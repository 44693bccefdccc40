"""The text CLI's first training run in a fresh process, for two trees in
turns: the step loop's rate and each chunk's wall seconds.

    git archive <rev> | tar -x -C build/parent
    python -m tinydiffusionmodels_torch.train_ab build/parent

Builds both trees' kernel libraries from source, side by side, then runs
one process a turn, in the order other, this, this, other, each in its
tree's root with that tree's package on the path. A turn loads its
kernel library, turns TF32 off and calls its tree's
``shakespeare.main(["--train", ...])`` twice (RUNS) at the headline
width (dim 256, depth 3, bs 8, seq 64, dropout 0.1) on 160 000 characters
of the built-in corpus (281 steps: 11 chunks of 25, then one of 6), as
``chip_smoke.py``'s first training path calls it. Each run reports the
trainer's own loop seconds and the wall seconds of every chunk
(``EpochSteps.run_variants``, which returns the chunk's losses on the
host, so a chunk's time includes its device work and, for the first
chunk of a length, its warm-up and capture), and of those the seconds
in ``graphs.Step``'s eager warm-up steps and in its capture, each
bracketed by a synchronize. The medians print with the card's name and
power limit, then one JSON line.
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
CHARS = 160_000
RUNS = 2    # the first in a fresh process, then one after it
# One turn, in a tree's root: argv = [work directory, runs].
TURN = """
import json, sys, time
from pathlib import Path
import torch
from tinydiffusionmodels_torch import graphs, shakespeare
from tinydiffusionmodels_torch.ops import _build
from tinydiffusionmodels_torch.train import chunks

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.library()
work = Path(sys.argv[1])
chunk_s, warmup_s, capture_s = [], [], []
spent = {"warmup": 0.0, "capture": 0.0, "depth": 0}
run_variants = chunks.EpochSteps.run_variants
on_side_stream, capture = graphs.Step._on_side_stream, graphs.Step._capture


def timed(self, variants):
    before = dict(spent)
    t0 = time.perf_counter()
    out = run_variants(self, variants)
    chunk_s.append(time.perf_counter() - t0)
    warmup_s.append(spent["warmup"] - before["warmup"])
    capture_s.append(spent["capture"] - before["capture"])
    return out


def timed_side_stream(self, fn):
    if spent["depth"]:      # the prime or the capture, inside _capture
        return on_side_stream(self, fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_side_stream(self, fn)
    torch.cuda.synchronize()
    spent["warmup"] += time.perf_counter() - t0


def timed_capture(self):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spent["depth"] += 1
    try:
        capture(self)
    finally:
        spent["depth"] -= 1
    torch.cuda.synchronize()
    spent["capture"] += time.perf_counter() - t0


chunks.EpochSteps.run_variants = timed
graphs.Step._on_side_stream = timed_side_stream
graphs.Step._capture = timed_capture
runs = []
for i in range(int(sys.argv[2])):
    for x in (chunk_s, warmup_s, capture_s):
        x.clear()
    torch.cuda.synchronize()
    result = shakespeare.main([
        "--train", "--epochs", "1", "--batch_size", "8", "--seq_len", "64",
        "--embed_dim", "256", "--depth", "3", "--dropout", "0.1",
        "--model_id", "char", "--use_learned_embeddings", "--data_root",
        str(work / "data"), "--ckpt", str(work / f"run{i}.pth")])
    torch.cuda.synchronize()
    runs.append({"steps": result.steps, "seconds": result.seconds,
                 "chunk_s": list(chunk_s), "warmup_s": list(warmup_s),
                 "capture_s": list(capture_s)})
print(json.dumps(runs))
"""


def _env(tree: Path) -> dict:
    return dict(os.environ, PYTHONPATH=str(tree), TDM_PLATFORM="cuda",
                TDM_DATA_LIMIT=str(CHARS), TDM_PROGRESS_EVERY="4")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other tree's root")
    args = parser.parse_args(argv)
    trees = {"other": args.other.resolve(), "this": THIS}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree,
                               env=_env(tree)) for tree in trees.values()]
    if any(p.wait() for p in builds):
        raise SystemExit("train_ab: a kernel build failed")
    card = perf.card_label()
    turns: dict = {"other": [], "this": []}
    for i, who in enumerate(ORDER):
        work = THIS / "build" / "train_ab" / f"turn{i}_{who}"
        work.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [sys.executable, "-c", TURN, str(work), str(RUNS)],
            cwd=trees[who], env=_env(trees[who]), capture_output=True,
            text=True)
        if proc.returncode:
            raise SystemExit(f"train_ab: turn {i} ({who}) exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        runs = json.loads(proc.stdout.splitlines()[-1])
        for r, run in enumerate(runs):
            print(f"turn {i} ({who}) run {r}: {run['steps']} steps, "
                  f"{run['steps'] / run['seconds']:.2f} steps/s over "
                  f"{run['seconds']:.4f} s; chunks (s) "
                  f"{[round(s, 4) for s in run['chunk_s']]}; of the first "
                  f"chunk, warm-up {run['warmup_s'][0]:.4f} s and capture "
                  f"{run['capture_s'][0]:.4f} s")
        turns[who].append(runs)
    record = {"card": card, "order": list(ORDER), "runs": RUNS}
    for who, runs in turns.items():
        for r in range(RUNS):
            rates = [t[r]["steps"] / t[r]["seconds"] for t in runs]
            med = {k: np.median([t[r][k] for t in runs], axis=0)
                   for k in ("chunk_s", "warmup_s", "capture_s")}
            first = med["chunk_s"][0]
            print(f"{who} run {r}: median {np.median(rates):.2f} steps/s "
                  f"({[round(x, 2) for x in rates]}); median chunk s: first "
                  f"{first:.4f} (warm-up {med['warmup_s'][0]:.4f}, capture "
                  f"{med['capture_s'][0]:.4f}), last "
                  f"{med['chunk_s'][-1]:.4f}, the others "
                  f"{med['chunk_s'][1:-1].sum():.4f} in all, on {card}")
            record[f"{who}_run{r}"] = {
                "steps_per_s": rates,
                **{f"{k}_median": v.tolist() for k, v in med.items()}}
    print(json.dumps(record))


if __name__ == "__main__":
    main()
