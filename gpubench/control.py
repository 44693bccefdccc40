"""Readings that set a cell's correctness limits: the program's numbers,
the control's and a planted fault's, over many seeds, in one process.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 [--cpu]

For each seed it builds the cell, runs its set-up (a training cell's
three checked steps) and, for a sampling cell, ``checked_batches``
batches at the cell's own load, frees the program and prints one JSON
line: ``program`` (the program against the float32 reference),
``control`` (the reference in TF32, the nearest precision below the
configuration's float32 with TF32 off, put in the program's place) and
a planted fault's: for a training cell ``half_batch`` (the reference with
the second half of each batch left out, the mean taken over the rest),
for a sampling cell ``answer_altered`` (the reference's own answers with
one element of each altered where it is produced: a sample's first
pixel, or its first token). A state left unchanged reads 1 by the
training measure and needs no run. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device) -> dict:
    import torch

    from gpubench.builders import training

    module = importlib.import_module(
        f"gpubench.builders.{cell.workload['builder']}")
    tf32 = cell.config["precision"]["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    runner = module.build(cell, seed, device)
    runner.setup()
    if runner.kind == "sample":
        for _ in range(runner.checked_batches):
            runner.unit()
    runner.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed}
    if runner.kind == "train":
        ref = runner.reference()
        out["program"] = training.readings(runner.prog, ref)
        out["control"] = training.readings(runner.reference(tf32=True), ref)
        out["half_batch"] = training.readings(
            runner.reference(half_batch=True), ref)
    else:
        picks = runner.picks()
        ref = runner.reference(picks)
        out["program"] = runner.compare(runner.program_rows(picks), ref)
        out["control"] = runner.compare(runner.reference(picks, tf32=True),
                                        ref)
        out["answer_altered"] = runner.compare(
            [runner.altered(r) for r in ref], ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench import run

    run._environment()
    import torch

    from gpubench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(cell, seed, device)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
