#!/usr/bin/env python3
"""A/B of the fused resblock kernel's output tile edge on one NVIDIA GPU.

    python3 tools/resblock_tile_ab.py

Builds the port's kernels (``tinydiffusionmodels_torch/ops/_build.py``) and
times ``ops.resblock._launch`` with tile edge 7 (the wrapper's ``TILE``)
and 14 at every block of the MNIST UNet and batch 1, 3, 25 and 128, in turns
7, 14, 14, 7 (CUDA-event device time, ``chip_smoke._device_ms``), with the
same inputs as ``chip_smoke.resblock_timing``. Prints the card's name and
power limit first. Imports nothing of jax.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402


def main() -> None:
    from tinydiffusionmodels_torch.models.unet import BLOCKS
    from tinydiffusionmodels_torch.ops import resblock as rb

    c.environment()
    c.build()
    c.phase("tile 7 vs 14 (turns 7, 14, 14, 7), ms")
    for b in (1, 3, 25, 128):
        total = {7: 0.0, 14: 0.0}
        for i, name in enumerate(BLOCKS):
            args = c._resblock_args(name, b, seed=400 + i)
            times = {7: [], 14: []}
            for tile in (7, 14, 14, 7):
                times[tile].append(c._device_ms(
                    lambda: rb._launch(*args, tile=tile)))
            for tile in total:
                total[tile] += sum(times[tile]) / 2
            print(f"{name} n {b}: tile 7 {times[7]}, tile 14 {times[14]}")
        print(f"four blocks n {b}: tile 7 {total[7]}, tile 14 {total[14]}")


if __name__ == "__main__":
    main()
