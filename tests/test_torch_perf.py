"""The port's ``perf.py``: device peaks, FLOP counting, MFU, the bound and
the timer, on the CPU. The peak table is read through a patched device name,
because this machine has no card."""

import math
import subprocess
import sys

import pytest
import torch

from tinydiffusionmodels_torch import perf

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture()
def card(monkeypatch):
    """Pretend the current CUDA device is named ``name``."""
    def use(name):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda index=None: name)
    return use


def test_h100_peaks(card):
    card(H100)
    assert perf.device_peak_flops() == 989e12
    assert perf.device_peak_flops(dtype="bf16") == 989e12
    assert perf.device_peak_flops("cuda", dtype="f32") == 67e12
    assert perf.device_peak_flops(torch.device("cuda", 0), "f32") == 67e12
    assert perf.device_peak_flops(dtype="tf32") == 495e12
    assert perf.device_hbm_bandwidth() == 3.35e12


def test_unknown_card_and_cpu_have_no_peak(card):
    assert perf.device_peak_flops("cpu") is None
    assert perf.device_hbm_bandwidth(torch.device("cpu")) is None
    card("NVIDIA A100-SXM4-80GB")
    assert perf.device_peak_flops() is None
    assert perf.device_hbm_bandwidth() is None
    assert perf.device_peak_flops("cpu") is None


def test_no_gpu_has_no_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert perf.device_peak_flops() is None
    assert perf.device_hbm_bandwidth() is None


@pytest.mark.parametrize("m, n, k", [(3, 5, 7), (64, 32, 16)])
def test_compiled_flops_of_a_matmul(m, n, k):
    a, b = torch.randn(m, k), torch.randn(k, n)
    assert perf.compiled_flops(torch.matmul, a, b) == 2 * m * n * k
    assert perf.compiled_flops(lambda x: x + 1, a) is None


def test_mfu(card):
    assert perf.mfu(1e12, 10.0, device="cpu") is None
    card(H100)
    assert perf.mfu(1e12, 10.0) == pytest.approx(1e13 / 989e12)
    assert perf.mfu(1e12, 10.0, dtype="f32") == pytest.approx(1e13 / 67e12)
    assert perf.mfu(None, 10.0) is None


def _old_bound(nbytes, ops):
    """``chip_smoke._bound`` as it stood before it moved to perf.py."""
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = sum(flops / rate for flops, rate in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def test_bound_ms_is_the_old_chip_smoke_bound(card):
    # Row 1 of the kernel table: the flash forward at the training shape.
    # The old bound took rates; bound_ms takes dtypes and looks them up.
    card(H100)
    rates = {"f32": 67e12, "bf16": 989e12}
    b, l, h, d = 8, 64, 4, 64
    n_qkv, n_row, pairs = b * l * h * d, b * h * l, b * h * l * l
    cases = [((4 * n_qkv + n_row) * 4 + 4, [(2 * pairs * 2 * d, "f32")]),
             ((6 * n_qkv + 2 * n_row) * 4 + 4, [(2 * pairs * 4 * d, "f32")]),
             (10, [(1e9, "bf16"), (1e6, "f32")])]
    for nbytes, ops in cases:
        assert perf.bound_ms(nbytes, ops) == _old_bound(
            nbytes, [(flops, rates[dtype]) for flops, dtype in ops])
    ms, by = perf.bound_ms(*cases[0])
    # PERF.md's row 1: 0.00063 ms, by bytes.
    assert by == "bytes" and math.isclose(ms, 2105348 / 3.35e12 * 1e3)
    assert round(ms, 5) == 0.00063
    assert perf.bound_ms(0, [(67e9, "f32")]) == (1.0, "operations")


def test_tf32_peak_and_the_3xtf32_bound(card):
    """The flash kernels' f32 products run as 3xTF32 on the tensor cores:
    three TF32 products per f32 product, at the data sheet's dense TF32
    peak; that bound is below the FP32-FMA roof of the same FLOPs."""
    card(H100)
    assert perf.device_peak_flops(dtype="tf32") == 495e12
    flops = 2 * 8 * 4 * 64 * 64 * (64 + 64)   # the forward at (8, 4, 64, 64)
    assert perf.f32_tensor_core_ops(flops) == [(3 * flops, "tf32")]
    ms, by = perf.bound_ms(0, perf.f32_tensor_core_ops(flops))
    assert by == "operations"
    assert math.isclose(ms, 3 * flops / 495e12 * 1e3)
    fma_roof = perf.bound_ms(0, [(flops, "f32")])[0]
    assert math.isclose(ms / fma_roof, 3 * 67 / 495)
    # At the training shape the bytes still bound the forward.
    nbytes = (4 * 8 * 64 * 4 * 64 + 8 * 4 * 64) * 4 + 4
    assert perf.bound_ms(nbytes, perf.f32_tensor_core_ops(flops)) == (
        nbytes / 3.35e12 * 1e3, "bytes")


def test_bound_ms_is_none_without_the_cards_peaks(card):
    assert perf.bound_ms(10, [(1e6, "f32")], device="cpu") is None
    card("NVIDIA A100-SXM4-80GB")
    assert perf.bound_ms(10, [(1e6, "f32")]) is None


def test_device_ms_on_the_cpu_calls_warmup_plus_iters_times():
    calls = []
    ms = perf.device_ms(lambda: calls.append(1), iters=7, warmup=3,
                        device="cpu")
    assert len(calls) == 10 and ms >= 0.0


def test_perf_imports_no_jax():
    code = ("import sys, tinydiffusionmodels_torch.perf; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tinydiffusionmodels_tpu')]; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_card_label_is_nvidia_smis_first_line(monkeypatch):
    seen = {}

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(
            cmd, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\nother\n")

    monkeypatch.setattr(perf.subprocess, "run", run)
    assert perf.card_label() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen["cmd"] == ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]
