"""A/B of the fused resblock's kernels and tile edges on one NVIDIA GPU.

    python -m tinydiffusionmodels_torch.resblock_tile_ab [--tiles 7 14]
        [--widths CIN:COUT:HW ...] [--batches 1 3 25 128]
    python -m tinydiffusionmodels_torch.resblock_tile_ab --kernels
        [--batches 1 3 25 128]
    python -m tinydiffusionmodels_torch.resblock_tile_ab --layouts
        [--widths 256:256:32 ...] [--batches 8]

``--layouts`` times the wgmma kernel at every layout its plan could take
at the given widths (default 256:256:32), one at a time: each column chunk
of its instances, each of ``resblock._LAYOUTS`` (x whole or in chunks,
the bytes of K a stage, the stages in the ring) and clusters of 1, 2 and
4, where the shared memory fits, at the plan's tile edge; f32 and bf16,
each time a ``perf.device_ms`` reading of the launch alone (weights
packed once).

``--kernels`` times the narrow kernel against the wgmma kernel
(``ops.resblock._launch(..., kernel=...)``, each at its own plan) at the
UNet's four blocks and rb4 from two sources, at each of ``--batches``, in
float32 and bfloat16, in turns (narrow, wgmma, wgmma, narrow), and prints
per row both means and the faster; the plan gives a UNet block to the
wgmma kernel only where it is faster at every batch in both dtypes.

Builds the port's kernels (``ops/_build.py``) and times ``ops.resblock.
_launch`` at each tile edge of ``--tiles`` (default: the wrapper's
``TILES``, 7 and 14) and at the edge ``resblock.plan`` picks, for every
block of the MNIST UNet (or, with ``--widths``, every (Cin, Cout, H = W)
given) at each of ``--batches``, in float32 and bfloat16: CUDA-event device
time (``perf.device_ms``) in turns, the edges in order and then in
reverse, each edge at the plan ``resblock.plan(..., tile=edge)`` gives it
(an edge no plan fits is skipped and said). Inputs: N(0, 1) activations and
time bias, weights at torch's init scale, from a seed. Prints per shape the
plan, per batch the shapes' sum at each edge and at the plan's picks, and
the card's name and power limit first. Imports nothing of jax.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import math

import torch

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.models.unet import BLOCKS
from tinydiffusionmodels_torch.ops import _build, reference
from tinydiffusionmodels_torch.ops import resblock as rb


def block_args(b: int, hw: int, cin: int, cout: int, seed: int,
               dtype: torch.dtype) -> list:
    """A (b, hw, hw, cin) -> cout block's arguments on the card, a 1x1
    skip where Cin != Cout."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(
            dtype)

    args = [r(b, hw, hw, cin), r(cout, cin, 3, 3, scale=1 / math.sqrt(9 * cin)),
            r(cout, scale=0.1), r(cout, cout, 3, 3,
                                  scale=1 / math.sqrt(9 * cout)),
            r(cout, scale=0.1), r(b, 1, 1, cout)]
    if cin == cout:
        return args + [None, None]
    return args + [r(cout, cin, 1, 1, scale=1 / math.sqrt(cin)),
                   r(cout, scale=0.1)]


def unet_cases(b: int, dtype: torch.dtype) -> dict:
    """The UNet's blocks at batch b (a 1x1 skip where Cin != Cout) and rb4
    from two sources (h3 at half the resolution, upsampled 2x in the
    gather, and h1): name -> (positional arguments, keyword arguments)."""
    cases = {}
    for i, (name, (cin, cout)) in enumerate(BLOCKS.items()):
        hw = 28 if name in ("rb1", "rb4") else 14
        cases[name] = (block_args(b, hw, cin, cout, 400 + i, dtype), {})
    args = cases["rb4"][0]
    g = torch.Generator(device="cuda").manual_seed(499)
    h3 = torch.randn(b, 14, 14, 64, generator=g, device="cuda").to(dtype)
    h1 = torch.randn(b, 28, 28, 32, generator=g, device="cuda").to(dtype)
    cases["rb4 two sources"] = ([h3, *args[1:]],
                                {"x_b": h1, "upsample_a": 2})
    return cases


def kernel_ab(batches) -> list[dict]:
    """The narrow and the wgmma kernel, each at its own plan, in turns
    (narrow, wgmma, wgmma, narrow) at ``unet_cases``, f32 and bf16: one
    row each, with both means in ms, the wgmma plan and the faster."""
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for b in batches:
            for name, (args, kw) in unet_cases(b, dtype).items():
                times = {"narrow": [], "wgmma": []}
                for kernel in ("narrow", "wgmma", "wgmma", "narrow"):
                    # 50 calls a reading: at these small shapes the wgmma
                    # path's host work a call (the f32 weight planes) can
                    # outlast the device's, and 50 calls fit behind
                    # device_ms's sleep, so the reading stays the device's.
                    times[kernel].append(perf.device_ms(
                        lambda: rb._launch(*args, **kw, kernel=kernel),
                        iters=50))
                p = rb._check(*args, **kw, kernel="wgmma")
                ms = {k: sum(v) / len(v) for k, v in times.items()}
                rows.append({"block": name, "batch": b,
                             "dtype": str(dtype)[6:],
                             "narrow_ms": ms["narrow"],
                             "wgmma_ms": ms["wgmma"],
                             "faster": min(ms, key=ms.get),
                             "wgmma_plan": f"tile {p.tile}, {p.ctas} CTAs, "
                                           f"{p.nc} x {p.column_passes} "
                                           f"columns, kc {p.kc}"})
                print(f"{name} {str(dtype)[6:]} n {b}: narrow "
                      f"{times['narrow']} ms, wgmma {times['wgmma']} ms "
                      f"({rows[-1]['wgmma_plan']}): {rows[-1]['faster']} "
                      f"faster", flush=True)
    return rows


def check_kernels(batches) -> float:
    """The wgmma kernel at ``unet_cases`` against the plain version (f32
    1e-4, bf16 2e-2), and rb4 from two sources bit-equal to its launch on
    the concat; returns the largest f32 error."""
    worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for b in batches:
            for name, (args, kw) in unet_cases(b, dtype).items():
                out = rb._launch(*args, **kw, kernel="wgmma")
                if kw:
                    full = reference.concat_sources(args[0], kw["x_b"], 2)
                    cat = rb._launch(full, *args[1:], kernel="wgmma")
                    if not torch.equal(out, cat):
                        raise AssertionError(f"wgmma {name} n {b} {dtype}: "
                                             f"not bit-equal to the concat")
                    ref = reference.fused_resblock(full, *args[1:])
                else:
                    ref = reference.fused_resblock(*args)
                torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
                if dtype == torch.float32:
                    worst = max(worst, float((out - ref).abs().max()))
    return worst


@contextlib.contextmanager
def _only(nc: int, layout: tuple):
    """The wgmma plan held to one column chunk and one layout."""
    saved = rb._WGMMA_COLS, rb._LAYOUTS
    rb._WGMMA_COLS, rb._LAYOUTS = (nc,), (layout,)
    try:
        yield
    finally:
        rb._WGMMA_COLS, rb._LAYOUTS = saved


def layout_sweep(shapes, batches) -> None:
    """Every layout of the wgmma plan at ``shapes`` ({name: (cin, cout,
    hw)}) and ``batches``, f32 and bf16: one reading of the launch alone
    each, beside its plan."""
    stream = torch.cuda.current_stream().cuda_stream
    entry = _build.function("tdm_fused_resblock_wgmma", rb._WGMMA_ARGTYPES)
    for dtype in (torch.float32, torch.bfloat16):
        for b in batches:
            for name, (cin, cout, hw) in shapes.items():
                block = block_args(b, hw, cin, cout, 400, dtype)
                tile = rb.plan(b, hw, hw, cin, cout, dtype,
                               kernel="wgmma").tile
                for nc, layout, cluster in itertools.product(
                        rb._WGMMA_COLS, rb._LAYOUTS, (1, 2, 4)):
                    with _only(nc, layout):
                        try:
                            p, _, args, keep = rb._kernel_args(
                                *block, tile=tile, kernel="wgmma",
                                cluster=cluster)
                        except ValueError:
                            continue
                    if p.nc != nc or p.cluster != cluster:
                        continue
                    _build.raise_on(entry(*args, stream), "fused resblock")
                    ms = perf.device_ms(lambda: entry(*args, stream))
                    print(f"{name} {str(dtype)[6:]} n {b}: {ms:.4f} ms; "
                          f"nc {p.nc}, kc {p.kc} (stages of "
                          f"{layout[1]} bytes) x {p.stages}, x "
                          f"{'in chunks' if p.x_chunked else 'whole'}, "
                          f"clusters of {p.cluster}", flush=True)


def _width(text: str) -> tuple[int, int, int]:
    cin, cout, hw = (int(v) for v in text.split(":"))
    return cin, cout, hw


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiles", type=int, nargs="+", default=rb.TILES)
    parser.add_argument("--widths", type=_width, nargs="+", default=None,
                        help="CIN:COUT:HW shapes (default: the UNet's "
                             "blocks)")
    parser.add_argument("--batches", type=int, nargs="+", default=None,
                        help="default 8 with --layouts, else 1 3 25 128")
    parser.add_argument("--kernels", action="store_true",
                        help="time the narrow kernel against the wgmma "
                             "kernel at the UNet's blocks")
    parser.add_argument("--layouts", action="store_true",
                        help="time every layout of the wgmma plan")
    args = parser.parse_args(argv)
    batches = args.batches or ([8] if args.layouts else [1, 3, 25, 128])
    if not torch.cuda.is_available():
        raise SystemExit("resblock_tile_ab: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    print(perf.card_label())
    _build.library()
    if args.kernels:
        kernel_ab(batches)
        return
    if args.layouts:
        widths = args.widths or [(256, 256, 32)]
        layout_sweep({f"{cin}->{cout} {hw}x{hw}": (cin, cout, hw)
                      for cin, cout, hw in widths}, batches)
        return
    shapes = ({name: (cin, cout, 28 if name in ("rb1", "rb4") else 14)
               for name, (cin, cout) in BLOCKS.items()}
              if args.widths is None else
              {f"{cin}->{cout} {hw}x{hw}": (cin, cout, hw)
               for cin, cout, hw in args.widths})
    print(f"tile edges {args.tiles} and the plan's (turns in order, then "
          f"reversed), ms")
    for dtype in (torch.float32, torch.bfloat16):
        kind = str(dtype)[6:]
        for b in batches:
            total, picked = {}, 0.0
            for i, (name, (cin, cout, hw)) in enumerate(shapes.items()):
                block = block_args(b, hw, cin, cout, 400 + i, dtype)
                chosen = rb.plan(b, hw, hw, cin, cout, dtype)
                tiles = []
                for t in dict.fromkeys((*args.tiles, chosen.tile)):
                    try:
                        rb.plan(b, hw, hw, cin, cout, dtype, tile=t)
                        tiles.append(t)
                    except ValueError as e:
                        print(f"{name} {kind} n {b}: tile {t} skipped: {e}")
                times = {t: [] for t in tiles}
                for t in (*tiles, *reversed(tiles)):
                    times[t].append(perf.device_ms(
                        lambda: rb._launch(*block, tile=t)))
                for t, v in times.items():
                    total[t] = total.get(t, 0.0) + sum(v) / len(v)
                picked += sum(times[chosen.tile]) / 2
                print(f"{name} {kind} n {b}: "
                      + ", ".join(f"tile {t} {v}" for t, v in times.items())
                      + f"; the plan: {chosen}")
            print(f"all shapes {kind} n {b}: "
                  + ", ".join(f"tile {t} {v}" for t, v in total.items())
                  + f"; the plan's picks {picked}")


if __name__ == "__main__":
    main()
