"""Runs one cell: finds its files by name, builds it, times its window,
reads its metrics and decides ``correct``.

Everything that belongs to one cell, configuration or metric is a file
of its own, found by the name ``BENCHMARK.json`` gives it:

- ``gpubench/workloads/<cell>.json``: the builder, the traffic, the
  correctness limits;
- the configuration's ``file`` (``gpubench/configs/<config>.json``);
- ``gpubench/builders/<builder>.py``: ``build(cell, seed, device)``;
- ``gpubench/metrics/<metric>.py``: ``read(run)``, a number or None.

A cell reports every end-to-end metric whose ``workloads`` list it (or
that has none), and every per-layer metric whose ``workloads`` list it
(or, without the key, that moves an end-to-end metric it reports).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from gpubench import trace as tracing

CODE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "tinydiffusionmodels_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files."""
    root = Path(root)
    manifest = _json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    workload = _json(root / "gpubench" / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name, _json(root / conf["file"]), workload, e2e, per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = CODE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Phases:
    """Records into ``into`` the host seconds since the last call, under
    each name it is called with (set-up's parts, for the log)."""

    def __init__(self, into: dict):
        self.into, self.last = into, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.into[name] = now - self.last
        self.last = now


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    units: int = 0
    steps: int = 0
    examples: int = 0
    samples: int = 0
    flops: float = 0.0


@dataclasses.dataclass
class Run:
    """What a metric reads: the cell, its runner, the window's counts and,
    in a traced run, its trace."""

    cell: Cell
    runner: object
    setup_s: float
    window: Window
    trace: tracing.Trace | None
    memory_peak_bytes: int


def _window(runner, *, seconds: float, units: int | None) -> Window:
    """Run whole units until ``seconds`` have passed (or ``units`` units):
    each unit ends in its host read, so the window ends when the first
    unit that finishes after the time finishes."""
    w = Window()
    t0 = time.perf_counter()
    while True:
        done = runner.unit()
        w.units += 1
        w.steps += done["steps"]
        w.examples += done.get("examples", 0)
        w.samples += done.get("samples", 0)
        w.flops += done["flops"]
        w.seconds = time.perf_counter() - t0
        if (w.units >= units) if units else (w.seconds >= seconds):
            return w


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def run_cell(root: Path, name: str, *, seed: int, seconds: float,
             trace: bool, device: torch.device, start: float,
             log=print) -> dict:
    """One run of a cell on ``device``; ``start`` is the process's start on
    the host clock (``time.perf_counter``). Returns the result line."""
    cell = load_cell(root, name)
    module = importlib.import_module(
        f"gpubench.builders.{cell.workload['builder']}")
    precision = cell.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = precision["tf32"]
    torch.backends.cudnn.allow_tf32 = precision["tf32"]
    t0 = time.perf_counter()
    runner = module.build(cell, seed, device)
    runner.setup()
    t1 = time.perf_counter()
    setup_s = t1 - start
    log(f"setup {setup_s:.3f} s: {t0 - start:.3f} s to the build, then "
        + ", ".join(f"{k} {v:.3f} s" for k, v in runner.phases.items()))
    trace_obj = None
    if trace:
        units = cell.workload["traffic"]["trace_units"]
        with tracing.profiled(device) as got:
            with tracing.window_span():
                window = _window(runner, seconds=seconds, units=units)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        trace_obj = tracing.Trace(*got, steps=window.steps)
    else:
        window = _window(runner, seconds=seconds, units=None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(cell, runner, setup_s, window, trace_obj, peak)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    runner.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    values = runner.check()
    log(f"check {time.perf_counter() - t2:.3f} s")
    limits = cell.workload["limits"]
    if set(values) != set(limits):
        raise RuntimeError(f"{name}: readings {sorted(values)} against "
                           f"limits {sorted(limits)}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    failed = sum(not (math.isfinite(c["value"]) and c["value"] <= c["limit"])
                 for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0,
              "attempted": window.examples or window.samples,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_obj is not None:
        dev["busy_s"] = trace_obj.busy_s
        dev["window_s"] = trace_obj.window_s
        result["breakdown"] = trace_obj.breakdown()
    result["checks"] = checks
    return result
