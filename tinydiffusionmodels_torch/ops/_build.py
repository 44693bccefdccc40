"""Build and load the port's CUDA kernels: one shared library from ``csrc/``.

Every kernel wrapper (``ops/flash_attention.py``, ``ops/decode_kernel.py``,
``ops/resblock.py``, ``ops/single_block.py``, ``ops/rng.py``) takes its C
entry point from here. The kernels are compiled with ``nvcc`` at
first use, from the sources in ``csrc/`` only, into ``build/kernels/`` beside
the package: each ``.cu`` in its own ``nvcc``, all started together, then
one link. The library's name carries a hash of every source (``.cu`` and
``.cuh``), so an edited source is rebuilt. Nothing is built or loaded when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "kernels"
_LIB_STEM = "libtdm_kernels"

_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output of the last build in this process
build_seconds = 0.0     # wall time of that build (0.0 when it was cached)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc() -> str:
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
    tag = f"{out.stem}.{os.getpid()}"
    compiler = nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    t0 = time.perf_counter()
    compiles = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [compiler, *arch, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        compiles.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in compiles:
        logs.append(f"--- {src.name}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [obj for _, obj, _ in compiles]
    tmp = out.with_name(f"{tag}.tmp.so")
    if not failed:
        link = subprocess.run(
            [compiler, *arch, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, check=False,
        )
        logs.append(f"--- link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    os.replace(tmp, out)
    (out.with_suffix(".log")).write_text(build_log)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.tdm_cuda_error_string.restype = ctypes.c_char_p
        lib.tdm_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's C entry point ``name``, returning a cudaError_t code,
    with its argument types set (pointers and the stream as
    ``ctypes.c_void_p``, so 64-bit addresses pass whole)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _functions[name] = fn
    return fn


_functions: dict[str, ctypes._CFuncPtr] = {}


def raise_on(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{library().tdm_cuda_error_string(err).decode()} (cudaError {err})"
        )
