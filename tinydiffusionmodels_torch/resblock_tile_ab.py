"""A/B of the fused resblock kernel's output tile edge on one NVIDIA GPU.

    python -m tinydiffusionmodels_torch.resblock_tile_ab [--tiles 7 14]
        [--widths CIN:COUT:HW ...] [--batches 1 3 25 128]

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
import math

import torch

from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.models.unet import BLOCKS
from tinydiffusionmodels_torch.ops import _build
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


def _width(text: str) -> tuple[int, int, int]:
    cin, cout, hw = (int(v) for v in text.split(":"))
    return cin, cout, hw


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiles", type=int, nargs="+", default=rb.TILES)
    parser.add_argument("--widths", type=_width, nargs="+", default=None,
                        help="CIN:COUT:HW shapes (default: the UNet's "
                             "blocks)")
    parser.add_argument("--batches", type=int, nargs="+",
                        default=[1, 3, 25, 128])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resblock_tile_ab: needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    print(perf.card_label())
    _build.library()
    shapes = ({name: (cin, cout, 28 if name in ("rb1", "rb4") else 14)
               for name, (cin, cout) in BLOCKS.items()}
              if args.widths is None else
              {f"{cin}->{cout} {hw}x{hw}": (cin, cout, hw)
               for cin, cout, hw in args.widths})
    print(f"tile edges {args.tiles} and the plan's (turns in order, then "
          f"reversed), ms")
    for dtype in (torch.float32, torch.bfloat16):
        kind = str(dtype)[6:]
        for b in args.batches:
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
