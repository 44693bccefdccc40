"""FLOP accounting, device peaks, bounds and kernel timing on the card.

Port of ``tinydiffusionmodels_tpu/perf.py``. The JAX version reads a TPU's
peaks from its ``device_kind`` and counts FLOPs with XLA's cost analysis;
here the peaks are looked up by the CUDA device's name
(``torch.cuda.get_device_name``) and FLOPs are counted by
``torch.utils.flop_counter``. Beside them live the two measurements the
port's timing scripts share (``chip_smoke.py``, ``kernel_bench.py``):

- ``bound_ms``: the least time the card could take for some work, the
  larger of its bytes over the HBM rate and its operations over the peak
  of their type;
- ``device_ms``: the mean device time of one call of a function, over a
  burst of calls timed with CUDA events behind a sleep kernel.

Peaks are NVIDIA's data-sheet numbers for the H100 SXM at its full 700 W
power limit (dense, no sparsity); a card set to a lower limit runs slower
under load, so a number measured against them is stated beside the card's
name and power limit.
"""

from __future__ import annotations

import subprocess
import time

import torch

# Peaks by device-name prefix: H100 SXM (NVIDIA data sheet, 700 W, dense),
# HBM3 bytes/s, f32 FLOP/s outside the tensor cores, bf16 and TF32
# tensor-core FLOP/s.
# Only the card the port is measured on is listed: the H100 PCIe and NVL
# parts have other rates, so they get None. Everything reads them through
# ``device_peak_flops`` and ``device_hbm_bandwidth``.
_PEAK_FLOPS = (("NVIDIA H100 80GB HBM3",
                {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}),)
_HBM_BW = (("NVIDIA H100 80GB HBM3", 3.35e12),)


def _lookup(table, name: str):
    for prefix, value in table:
        if name.startswith(prefix):
            return value
    return None


def _device_name(device) -> str | None:
    """The CUDA device's name, or None for the CPU or without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    return torch.cuda.get_device_name(index)


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its first card), the
    label every time measured on the card is stated beside."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_peak_flops(device=None, dtype: str = "bf16") -> float | None:
    """Peak dense FLOP/s of ``device`` (default: the current CUDA device)
    for ``dtype``: 'bf16' or 'tf32' (tensor cores) or 'f32' (outside the
    tensor cores). None on the CPU and on a card the table does not
    list."""
    name = _device_name(device)
    peaks = _lookup(_PEAK_FLOPS, name) if name else None
    return None if peaks is None else peaks[dtype]


def device_hbm_bandwidth(device=None) -> float | None:
    """Peak device-memory bytes/s of ``device``; None on the CPU and on a
    card the table does not list."""
    name = _device_name(device)
    return _lookup(_HBM_BW, name) if name else None


def compiled_flops(fn, *args, **kwargs) -> float | None:
    """FLOPs of one call of ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matmuls,
    convolutions, attention; 2 FLOPs per multiply-add); None when it counts
    none.

    The counter sees only PyTorch operators. It does not see the port's
    kernels, which are launched through ctypes, so the kernels take analytic
    counts (``kernel_bench.py``, ``chip_smoke.py``)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = counter.get_total_flops()
    return float(flops) if flops > 0 else None


def mfu(flops_per_unit: float | None, units_per_sec: float,
        device=None, dtype: str = "bf16") -> float | None:
    """Achieved FLOP/s over peak FLOP/s; None when either side is unknown."""
    peak = device_peak_flops(device, dtype=dtype)
    if peak is None or flops_per_unit is None:
        return None
    return flops_per_unit * units_per_sec / peak


def bound_ms(nbytes: int, ops, device=None) -> tuple[float, str] | None:
    """(least time in ms, what bounds it) on ``device`` (default: the
    current CUDA device) for work that moves ``nbytes`` and does, for each
    (flops, dtype) of ``ops``, ``flops`` operations of ``dtype`` ('f32',
    'tf32' or 'bf16', as ``device_peak_flops``): bytes over the HBM rate or the summed
    operation times at the dtypes' peaks, the larger ("bytes" or
    "operations"). None where the peaks are unknown (the CPU, an unlisted
    card)."""
    bandwidth = device_hbm_bandwidth(device)
    peaks = [device_peak_flops(device, dtype) for _, dtype in ops]
    if bandwidth is None or None in peaks:
        return None
    t_bytes = nbytes / bandwidth * 1e3
    t_ops = sum(flops / peak for (flops, _), peak in zip(ops, peaks)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_tensor_core_ops(flops: float) -> list[tuple[float, str]]:
    """The ``ops`` of ``bound_ms`` for ``flops`` float32 product FLOPs run
    on the tensor cores as 3xTF32 (big*big + big*small + small*big, which
    keeps float32's accuracy): three TF32 products each. This is the least
    time for an f32 product on the card, below its FP32-FMA roof of
    ``flops`` at the 'f32' peak (495 / 3 = 165 against 67 TFLOP/s on the
    H100); the flash kernels' f32 path runs so."""
    return [(3 * flops, "tf32")]


def device_ms(fn, iters: int = 200, warmup: int = 10, device=None) -> float:
    """Mean time in ms of one call of ``fn`` over ``iters`` calls, after
    ``warmup`` calls.

    On a CUDA device (the default) the burst is queued behind a sleep
    kernel and timed with CUDA events, so the host's enqueue cost stays out
    of the reading and the reading is the device's. On the CPU it is the
    host clock around the same loop."""
    device = torch.device("cuda" if device is None else device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
