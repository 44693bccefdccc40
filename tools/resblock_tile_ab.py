#!/usr/bin/env python3
"""A/B of the fused resblock kernel's output tile edge on one NVIDIA GPU.

    python3 tools/resblock_tile_ab.py [--tiles 7 14]

Builds the port's kernels (``tinydiffusionmodels_torch/ops/_build.py``) and
times ``ops.resblock._launch`` at each tile edge of ``--tiles`` (default:
the wrapper's ``TILES``, 7 and 14) at every block of the MNIST UNet and
batch 1, 3, 25 and 128, in float32 and bfloat16, with the same inputs as
``chip_smoke.resblock_timing``: CUDA-event device time (``perf.device_ms``)
in turns, the tiles in order and then in reverse. Prints, per block, the
tile the wrapper's rule (``resblock.tile_for``) picks, and per batch the
four blocks' sum at each tile and at the rule's picks. Prints the card's
name and power limit first. Imports nothing of jax.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402


def main(argv=None) -> None:
    import torch

    from tinydiffusionmodels_torch import perf
    from tinydiffusionmodels_torch.models.unet import BLOCKS
    from tinydiffusionmodels_torch.ops import resblock as rb

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiles", type=int, nargs="+", default=rb.TILES)
    tiles = parser.parse_args(argv).tiles
    c.environment()
    c.build()
    c.phase(f"tile edges {tiles} (turns in order, then reversed), ms")
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 3, 25, 128):
            total = dict.fromkeys(tiles, 0.0)
            picked = 0.0
            for i, name in enumerate(BLOCKS):
                args = [None if a is None else a.to(dtype)
                        for a in c._resblock_args(name, b, seed=400 + i)]
                times = {t: [] for t in tiles}
                for tile in (*tiles, *reversed(tiles)):
                    times[tile].append(perf.device_ms(
                        lambda: rb._launch(*args, tile=tile)))
                mean = {t: sum(v) / 2 for t, v in times.items()}
                for t in tiles:
                    total[t] += mean[t]
                rule = rb.tile_for(*args[0].shape[:3])
                picked += mean.get(rule, float("nan"))
                print(f"{name} {str(dtype)[6:]} n {b}: "
                      + ", ".join(f"tile {t} {times[t]}" for t in tiles)
                      + f"; the rule picks {rule}")
            print(f"four blocks {str(dtype)[6:]} n {b}: "
                  + ", ".join(f"tile {t} {total[t]}" for t in tiles)
                  + f"; the rule's picks {picked}")


if __name__ == "__main__":
    main()
