"""Flash-attention forward: the CUDA kernel's wrapper and its build.

Port of the TPU kernel ``_flash_kernel`` (``tinydiffusionmodels_tpu/ops/
pallas_kernels.py``, with its host functions ``_flash_attention_impl``,
``flash_attention`` and ``flash_attention_with_lse``) to a hand-written CUDA
C++ kernel for Hopper, ``csrc/flash_attention_fwd.cu``; the source's header
says what bounds it on the card and what its design does about that.

Dispatch is on the tensor's device alone. A CPU tensor goes to the plain
PyTorch version (``ops/reference.py``); a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other.

The kernel is compiled with ``nvcc`` at first use, from the sources in
``csrc/`` only, into ``build/kernels/`` beside the package; the library's
name carries a hash of the sources, so an edited source is rebuilt. Nothing
is built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from tinydiffusionmodels_torch.ops import reference

# Number of kernel launches made by this process. Incremented once per launch
# and nowhere else; callers reset it to 0 to count a run.
launches = 0

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
_LIB_STEM = "libtdm_kernels"

_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output of the last build in this process
build_seconds = 0.0     # wall time of that build (0.0 when it was cached)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the CUDA kernels are built from source at "
        "first use"
    )


def library_path() -> Path:
    """Path of the shared library for the current sources."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{_LIB_STEM}-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless the library for these exact
    sources exists; returns its path."""
    global build_log, build_seconds
    out = library_path()
    if out.is_file():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(tmp),
        *[str(s) for s in _sources() if s.suffix == ".cu"],
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{build_log}"
        )
    os.replace(tmp, out)
    (out.with_suffix(".log")).write_text(build_log)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.tdm_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]
        )
        lib.tdm_cuda_error_string.restype = ctypes.c_char_p
        lib.tdm_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _bhl_strides(x: torch.Tensor, layout: str) -> tuple[int, int, int]:
    """Element strides over (batch, head, row) of a 4-D attention operand."""
    s = x.stride()
    return (s[0], s[1], s[2]) if layout == "bhld" else (s[0], s[2], s[1])


def _check_cuda_operands(q, k, v, layout: str) -> None:
    if layout not in reference.LAYOUTS:
        raise ValueError(f"unknown attention layout: {layout!r}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(
                f"{name} must be contiguous in its last dim, strides "
                f"{x.stride()}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash attention takes float32 or bfloat16, got {q.dtype}"
        )
    if q.device.index != torch.cuda.current_device():
        raise ValueError(
            f"q is on {q.device} but the current CUDA device is "
            f"{torch.cuda.current_device()}"
        )
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "the CUDA flash-attention kernel is forward only; its backward "
            "lands with the training port"
        )
    bdim, hdim, ldim = (0, 1, 2) if layout == "bhld" else (0, 2, 1)
    b, h = q.shape[bdim], q.shape[hdim]
    if (k.shape[bdim], k.shape[hdim]) != (b, h) or (
        v.shape[bdim], v.shape[hdim]
    ) != (b, h):
        raise ValueError(
            f"batch/head dims differ: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)} ({layout})"
        )
    if k.shape[ldim] != v.shape[ldim]:
        raise ValueError("k and v must have the same length")
    if k.shape[-1] != q.shape[-1]:
        raise ValueError("q and k must have the same head dim")
    for name, d in (("Dh", q.shape[-1]), ("Dv", v.shape[-1])):
        if d not in HEAD_DIMS:
            raise ValueError(
                f"{name}={d} is not a width the kernel is built for "
                f"{HEAD_DIMS}"
            )
    if min(q.shape[ldim], k.shape[ldim], b, h) == 0:
        raise ValueError("flash attention needs non-empty operands")


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
    q_offset: int = 0,
    k_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention and its per-row logsumexp, as ``reference.attention``.

    Returns ``out`` in the layout and dtype of q (width Dv) and ``lse`` as
    (B, H, Lq) float32. CPU tensors run the plain version; CUDA tensors run
    the kernel, which takes float32 or bfloat16, Dh and Dv in {32, 64, 128},
    and any strides whose last dim is contiguous.
    """
    global launches
    if q.device.type == "cpu":
        return reference.attention(
            q, k, v, causal=causal, layout=layout,
            q_offset=q_offset, k_offset=k_offset,
        )
    if q.device.type != "cuda":
        raise NotImplementedError(
            f"flash attention has no path for {q.device.type} tensors"
        )
    _check_cuda_operands(q, k, v, layout)
    if layout == "bhld":
        b, h, lq, dh = q.shape
    else:
        b, lq, h, dh = q.shape
    lk, dv = k.shape[2 if layout == "bhld" else 1], v.shape[-1]
    out_shape = (b, h, lq, dv) if layout == "bhld" else (b, lq, h, dv)
    out = torch.empty(out_shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = library()
    err = lib.tdm_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODES[q.dtype], b, h, lq, lk, dh, dv,
        *_bhl_strides(q, layout), *_bhl_strides(k, layout),
        *_bhl_strides(v, layout), *_bhl_strides(out, layout),
        1.0 / math.sqrt(dh), int(causal), int(q_offset), int(k_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            "flash attention kernel launch failed: "
            f"{lib.tdm_cuda_error_string(err).decode()} (cudaError {err})"
        )
    launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    layout: str = "bhld",
) -> torch.Tensor:
    """``flash_attention_with_lse`` without the logsumexp."""
    return flash_attention_with_lse(q, k, v, causal=causal, layout=layout)[0]
