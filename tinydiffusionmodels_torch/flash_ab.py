"""The flash kernels of two trees on one card, in turns: outputs bit for bit
and CUDA-event times.

    git archive <rev> | tar -x -C build/parent
    python -m tinydiffusionmodels_torch.flash_ab build/parent [--readings 5]

Builds both trees' kernel libraries from source, side by side, then runs
one process a turn, in the order other, this, this, other, each in its
tree's root with that tree's package on the path. A turn calls the tree's
own wrappers (``ops.flash_attention.forward``, ``backward_dq`` and
``backward_dkv``, with the keyword arguments every tree since the dropout
hash takes, so no tree's ctypes signature is written here) on the same
operands: the training shape (B 8, L 64, 4 heads on strided views of one
QKV projection, dropout 0.1) at head widths 64 (the model's), 256 (the
widest of the narrow instances) and 512 (the --embed_dim 2048 path's:
the wide forward, dq and dk/dv kernels), f32 and bf16. It saves its
outputs and takes ``--readings`` ``perf.device_ms`` readings of each
kernel (200 launches behind a sleep kernel). Every turn's outputs must be
bit-equal to the first turn of its tree; between the trees the largest
difference of each output prints (0 where both run the same kernel). The
medians print with the card's name and power limit, then one JSON line.
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
# One turn, in a tree's root: argv = [output path, readings].
TURN = """
import json, sys
import torch
from tinydiffusionmodels_torch import perf
from tinydiffusionmodels_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
b, l, h = 8, 64, 4
outputs, times = {}, {}
for d, dtype in [(w, t) for w in (64, 256, 512)
                 for t in (torch.float32, torch.bfloat16)]:
    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn(b, l, 3, h, d, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    g_out = torch.randn(b, l, h, d, generator=g, device="cuda").to(dtype)
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    kw = dict(causal=False, layout="blhd", q_offset=0, k_offset=0,
              dropout_rate=0.1, dropout_seed=seed)
    o, lse = fa.forward(q, k, v, **kw)
    delta = fa.backward_delta(o, g_out, None, "blhd")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    calls = {
        "fwd": lambda: fa.forward(q, k, v, **kw),
        "dq": lambda: fa.backward_dq(q, k, v, g_out, lse, delta, dq, **kw),
        "dkv": lambda: fa.backward_dkv(q, k, v, g_out, lse, delta, dk, dv,
                                       **kw)}
    calls["dq"]()
    calls["dkv"]()
    torch.cuda.synchronize()
    name = f"{str(dtype)[6:]}_d{d}"
    outputs[name] = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    times[name] = {k: [perf.device_ms(f) for _ in range(int(sys.argv[2]))]
                   for k, f in calls.items()}
torch.save({n: {k: x.cpu() for k, x in o.items()}
            for n, o in outputs.items()}, sys.argv[1])
print(json.dumps(times))
"""


def _env(tree: Path) -> dict:
    return dict(os.environ, PYTHONPATH=str(tree))


def main(argv=None) -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other tree's root")
    parser.add_argument("--readings", type=int, default=5,
                        help="readings of each kernel a turn")
    args = parser.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": THIS}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree,
                               env=_env(tree)) for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("flash_ab: a kernel build failed")
    out_dir = THIS / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    card = perf.card_label()
    times: dict = {}
    first: dict = {}
    for i, who in enumerate(ORDER):
        path = out_dir / f"turn{i}_{who}.pt"
        proc = subprocess.run(
            [sys.executable, "-c", TURN, str(path), str(args.readings)],
            cwd=trees[who], env=_env(trees[who]), capture_output=True,
            text=True)
        if proc.returncode:
            raise SystemExit(f"flash_ab: turn {i} ({who}) exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        outputs = torch.load(path)
        first.setdefault(who, outputs)
        for case, tensors in outputs.items():
            for name, x in tensors.items():
                if not torch.equal(x, first[who][case][name]):
                    raise AssertionError(f"{case} {name}: turn {i} ({who}) "
                                         f"differs from its tree's first")
        for case, kernels in json.loads(proc.stdout.splitlines()[-1]).items():
            for kernel, readings in kernels.items():
                times.setdefault(f"{case}_{kernel}", {}).setdefault(
                    who, []).extend(readings)
    record = {"card": card, "order": list(ORDER),
              "readings_per_turn": args.readings}
    diffs = {case: {name: float((x.float() - first["other"][case][name]
                                 .float()).abs().max())
                    for name, x in tensors.items()}
             for case, tensors in first["this"].items()}
    for case, d in diffs.items():
        print(f"{case}: largest difference between the trees {d}")
    for key, t in times.items():
        med = {who: float(np.median(v)) for who, v in t.items()}
        print(f"{key}: bit-equal in every turn of a tree; median ms other "
              f"{med['other']:.5f}, this {med['this']:.5f} "
              f"({med['this'] / med['other']:.3f}x), {len(t['this'])} "
              f"readings each, on {card}")
        record[key] = {**med, "spread_other": [min(t["other"]),
                                               max(t["other"])],
                       "spread_this": [min(t["this"]), max(t["this"])]}
    record["max_abs_diff_between_trees"] = diffs
    print(json.dumps(record))


if __name__ == "__main__":
    main()
