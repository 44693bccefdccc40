"""Where a stage of the fused resblock's wgmma kernel spends its cycles, on
one NVIDIA GPU.

    python -m tinydiffusionmodels_torch.resblock_trace [--widths 256:256]

Copies ``csrc/`` to ``build/resblock_trace/csrc`` with ``clock64`` stamps
added to CTA 0 of the wgmma kernel (``resblock_wgmma.cuh``): its producer
thread after each stage's copies are issued, and consumer thread 0 (and
128, the other warpgroup) before and after each stage's ``full`` barrier
and at its release. Builds that copy into ``build/resblock_trace/kernels``
(the package's own library is not touched), launches the kernel at B 8,
32 x 32 and each ``--widths`` CIN:COUT (a 1x1 skip where they differ) in
float32 and bfloat16 at the plan's layout, in clusters of 1 and 2, and
prints per launch the plan, the device time (``perf.device_ms``) and the
medians over its stages, in cycles: a stage's interval at the consumer,
its wait on the ``full`` barrier, its products (from the wait's end to the
release), the rest (release, loop, x chunks) and the producer's interval.
The card's name and power limit print first.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
from pathlib import Path

import numpy as np
import torch

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import _build
from tinydiffusionmodels_torch.ops import resblock as rb
from tinydiffusionmodels_torch.resblock_tile_ab import block_args

OUT = _build.BUILD_DIR.parent / "resblock_trace"
ROWS, STAGES = 6, 1024  # stamp rows, stages stamped
# (text, the same with its stamp), each found once in resblock_wgmma.cuh.
PATCHES = (
    ("namespace tdm_resblock {\n",
     "namespace tdm_resblock {\n"
     f"__device__ long long g_trace[{ROWS}][{STAGES}];\n"
     "__device__ __forceinline__ void stamp(int row, int j) {\n"
     f"  if (blockIdx.x == 0 && j < {STAGES}) g_trace[row][j] = clock64();\n"
     "}\n"),
    ("      int s = 0;\n      uint32_t phase = 0;\n      auto issue",
     "      int s = 0, issued = 0;\n      uint32_t phase = 0;\n"
     "      auto issue"),
    ("        if (++s == p.stages) {\n          s = 0;\n          phase ^= 1;\n"
     "        }\n      };",
     "        stamp(0, issued++);\n"
     "        if (++s == p.stages) {\n          s = 0;\n          phase ^= 1;\n"
     "        }\n      };"),
    ("    hop::mbar_wait(full + s, phase);\n",
     "    if (threadIdx.x == 0) stamp(1, j);\n"
     "    hop::mbar_wait(full + s, phase);\n"
     "    if (threadIdx.x == 0) stamp(2, j);\n"
     "    if (threadIdx.x == 128) stamp(4, j);\n"),
    ("  __device__ __forceinline__ void release() {\n",
     "  __device__ __forceinline__ void release() {\n"
     "    if (threadIdx.x == 0) stamp(3, j);\n"),
)
DUMP = ("\nextern \"C\" int tdm_resblock_trace(long long* out) {\n"
        "  return int(cudaMemcpyFromSymbol(out, tdm_resblock::g_trace,\n"
        "                                  sizeof(tdm_resblock::g_trace)));\n"
        "}\n")


def traced_sources() -> Path:
    """``csrc/`` with the stamps, and ``tdm_resblock_trace`` (a copy of the
    stamps to the host) in each wgmma instance file."""
    dst = OUT / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, dst)
    header = dst / "resblock_wgmma.cuh"
    text = header.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"resblock_trace: {old!r} is not found once in "
                             f"resblock_wgmma.cuh; update PATCHES")
        text = text.replace(old, new)
    header.write_text(text)
    for i, path in enumerate(sorted(dst.glob("fused_resblock_wgmma_*.cu"))):
        path.write_text(path.read_text() + DUMP.replace(
            "tdm_resblock_trace", f"tdm_resblock_trace_{i}"))
    return dst


def _dump(lib, dtype: torch.dtype, nc: int) -> np.ndarray:
    """The stamps of the instance (dtype, nc), from its file's copy: the
    files a-d pair f32 256 and 32, f32 128 and 64, bf16 256 and 32, bf16
    128 and 64."""
    file = (0 if dtype == torch.float32 else 2) + (0 if nc in (256, 32)
                                                   else 1)
    buf = (ctypes.c_longlong * (ROWS * STAGES))()
    _build.raise_on(getattr(lib, f"tdm_resblock_trace_{file}")(buf),
                    "resblock trace copy")
    return np.array(buf, dtype=np.int64).reshape(ROWS, STAGES)


def _width(text: str) -> tuple[int, int]:
    cin, cout = (int(v) for v in text.split(":"))
    return cin, cout


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--widths", type=_width, nargs="+",
                        default=[(256, 256), (128, 256)])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resblock_trace: needs an NVIDIA GPU")
    print(perf.card_label())
    _build.CSRC_DIR = traced_sources()
    _build.BUILD_DIR = OUT / "kernels"
    lib = _build.library()
    b, hw = 8, 32
    for cin, cout in args.widths:
        for dtype in (torch.float32, torch.bfloat16):
            block = block_args(b, hw, cin, cout, 800, dtype)
            for cluster in (1, 2):
                p = rb.plan(b, hw, hw, cin, cout, dtype, cluster=cluster)
                for _ in range(3):
                    rb._launch(*block, cluster=cluster)
                torch.cuda.synchronize()
                t = _dump(lib, dtype, p.nc)
                n = int((t[1] != 0).sum())
                ms = perf.device_ms(lambda: rb._launch(*block,
                                                       cluster=cluster))
                interval = np.median(np.diff(t[1, :n]))
                wait = np.median(t[2, :n] - t[1, :n])
                products = np.median(t[3, :n] - t[2, :n])
                produced = np.median(np.diff(t[0][t[0] != 0]))
                print(f"{cin}->{cout} {str(dtype)[6:]} cluster {p.cluster}: "
                      f"{ms:.4f} ms; {n} stages; median cycles a stage: "
                      f"interval {interval:.0f}, full wait {wait:.0f}, "
                      f"products {products:.0f}, rest "
                      f"{interval - wait - products:.0f}, producer "
                      f"interval {produced:.0f}; "
                      f"kc {p.kc}, nc {p.nc}, stages {p.stages}, x "
                      f"{'in chunks' if p.x_chunked else 'whole'}",
                      flush=True)


if __name__ == "__main__":
    main()
