"""A copy of the benchmark's cells at sizes the CPU runs in seconds, in a
directory of its own: ``BENCHMARK.json`` and the configuration and
workload files, nothing else. The code (builders, metric readers,
reference) stays the benchmark's, so a test that runs these cells runs
what the chip runs, at other sizes."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TEXT = dict(dim=32, heads=4, depth=2, ffn_dim=64, vocab_size=128,
            timesteps=20)
TRAIN = dict(batch=4, chunk=2, epoch_steps=5, trace_units=2)
SAMPLE = dict(n=4, checked_batches=2, checked_rows=1, trace_units=1)


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def make_root(tmp: Path, *, rename: str = "") -> Path:
    """Write the tiny copy under ``tmp``; with ``rename``, every cell's
    name gets that suffix, so its files exist only there."""
    tmp = Path(tmp)
    bench = _read(REPO / "BENCHMARK.json")
    for conf in bench["configs"]:
        cfg = _read(REPO / conf["file"])
        model = cfg["model"]
        model.update(TEXT if "dim" in model else {"timesteps": 10})
        path = tmp / conf["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    names = {}
    for w in bench["workloads"]:
        wf = _read(REPO / "gpubench" / "workloads" / f"{w['name']}.json")
        traffic = wf["traffic"]
        traffic.update(TRAIN if "batch" in traffic else SAMPLE)
        if "length" in traffic:
            traffic["length"] = 8
        names[w["name"]] = wf["name"] = w["name"] + rename
        w["name"] = wf["name"]
        path = tmp / "gpubench" / "workloads" / f"{wf['name']}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(wf))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[c] for c in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
