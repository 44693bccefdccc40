"""The fused resblock kernels of two trees on one card, in turns: each
tree's outputs against the plain version, and CUDA-event times.

    git archive <rev> | tar -x -C build/parent
    python -m tinydiffusionmodels_torch.resblock_ab build/parent [--readings 3]

Builds both trees' kernel libraries from source, side by side, then runs
one process a turn, in the order other, this, this, other, each in its
tree's root with that tree's package on the path. A turn calls the tree's
own ``ops.resblock._launch`` at its plan (positional arguments, which every
tree since the resblock's port takes) on the same operands, seeded: the
wide blocks (B 8, 32 x 32, Cin = Cout = 256 with the identity skip, and
Cin 128 -> Cout 256 with a 1x1 skip) in float32 and bfloat16. Each output
must be within 1e-4 (f32) and 2e-2 (bf16) of the plain version, with
cuDNN's TF32 off; it takes ``--readings`` ``perf.device_ms`` readings (200
launches behind a sleep kernel) of each. The medians print with the card's
name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from tinydiffusionmodels_torch import perf

THIS = Path(__file__).resolve().parents[1]
ORDER = ("other", "this", "this", "other")
BUILD = "from tinydiffusionmodels_torch.ops import _build; _build.library()"
# (B, H, W, Cin, Cout, 1x1 skip)
SHAPES = ((8, 32, 32, 256, 256, False), (8, 32, 32, 128, 256, True))
# One turn, in a tree's root: argv = [readings, shapes as JSON].
TURN = """
import json, math, sys
import torch
from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import reference
from tinydiffusionmodels_torch.ops import resblock as rb

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
times, errors = {}, {}
for b, h, w, cin, cout, skip in json.loads(sys.argv[2]):
    g = torch.Generator(device="cuda").manual_seed(800)
    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda")
    args = [r(b, h, w, cin), r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
            r(cout, scale=0.1), r(cout, cout, 3, 3, scale=(9 * cout) ** -0.5),
            r(cout, scale=0.1), r(b, 1, 1, cout)]
    args += ([r(cout, cin, 1, 1, scale=cin ** -0.5), r(cout, scale=0.1)]
             if skip else [None, None])
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        typed = [None if t is None else t.to(dtype) for t in args]
        out = rb._launch(*typed)
        ref = reference.fused_resblock(*typed)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
        key = f"{cin}->{cout} {'1x1' if skip else 'identity'} {str(dtype)[6:]}"
        errors[key] = float((out.float() - ref.float()).abs().max())
        times[key] = [perf.device_ms(lambda: rb._launch(*typed))
                      for _ in range(int(sys.argv[1]))]
print(json.dumps({"times": times, "errors": errors}))
"""


def _env(tree: Path) -> dict:
    return dict(os.environ, PYTHONPATH=str(tree))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other tree's root")
    parser.add_argument("--readings", type=int, default=3,
                        help="readings of each shape a turn")
    args = parser.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": THIS}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree,
                               env=_env(tree)) for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("resblock_ab: a kernel build failed")
    card = perf.card_label()
    times: dict = {}
    errors: dict = {}
    for i, who in enumerate(ORDER):
        proc = subprocess.run(
            [sys.executable, "-c", TURN, str(args.readings),
             json.dumps(SHAPES)],
            cwd=trees[who], env=_env(trees[who]), capture_output=True,
            text=True)
        if proc.returncode:
            raise SystemExit(f"resblock_ab: turn {i} ({who}) exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        turn = json.loads(proc.stdout.splitlines()[-1])
        for key, readings in turn["times"].items():
            times.setdefault(key, {}).setdefault(who, []).extend(readings)
            errors.setdefault(key, {})[who] = turn["errors"][key]
    record = {"card": card, "order": list(ORDER),
              "readings_per_turn": args.readings}
    for key, t in times.items():
        med = {who: float(np.median(v)) for who, v in t.items()}
        print(f"{key}: median ms other {med['other']:.5f}, this "
              f"{med['this']:.5f} ({med['this'] / med['other']:.3f}x), "
              f"{len(t['this'])} readings each; max|d| from plain other "
              f"{errors[key]['other']:.3e}, this {errors[key]['this']:.3e}; "
              f"on {card}")
        record[key] = {**med, "spread_other": [min(t["other"]),
                                               max(t["other"])],
                       "spread_this": [min(t["this"]), max(t["this"])],
                       "max_abs_err": errors[key]}
    print(json.dumps(record))


if __name__ == "__main__":
    main()
