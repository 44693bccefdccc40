"""The traced window's idle time, split by where the port left the device
idle: inside one replayed CUDA graph, between two replays of one chunk or
batch, or at the host.

The port opens a ``tdm.graph.replay`` span around each replay's
``cudaGraphLaunch`` and a ``tdm.train.chunk`` / ``tdm.sample.batch`` span
around each unit (``runtime.span``). Every kernel, copy and fill of a
replay carries the CUPTI correlation id of its ``cudaGraphLaunch``, so a
replay's device extent runs from its first operation's start to its last
one's end. The window's idle gaps (``trace.Trace.gaps``) then fall into
three parts that add up to the window's idle share:

- in a replay: the gap lies inside one replay's extent (gaps between one
  step's kernels);
- between replays: it lies between the extents of two consecutive replays
  launched inside the same chunk or batch (the graph launches);
- at the host: every other gap (a unit's edges and host read, an epoch's
  uploads, the sampler's start and decode, the profiler's own work),
  also given by the innermost ``tdm.*`` span open at its midpoint.

``trace.Event`` carries no correlation id, so no metric reads this yet.
Run as a module on the card, it runs one cell's set-up, a window of its
units without the profiler and one under it, and prints one JSON line:
the split, what the profile holds of the replays, the steps a second of
both windows and what a span costs::

    python3 -m gpubench.replays --workload <cell> --seed <n> [--units N]
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

from gpubench import trace

REPLAY_SPAN = "tdm.graph.replay"
LAUNCH = "cudaGraphLaunch"
UNIT_SPANS = ("tdm.train.chunk", "tdm.sample.batch")
SPAN_PREFIX = "tdm."


@dataclasses.dataclass
class Linked(trace.Event):
    link: int = 0    # the CUPTI correlation id (0: none)


def linked_events(prof):
    """``trace.events`` of a finished profile, each event a ``Linked``
    with its ``correlation_id()`` (``linked_correlation_id()`` names the
    enclosing torch op, not the launch)."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()
    device, host, window = [], [], None
    for k in results.events():
        start = (k.start_ns() - base) * 1e-9
        e = Linked(k.name(), start, start + k.duration_ns() * 1e-9,
                   k.correlation_id())
        if k.device_type() == DeviceType.CPU:
            if e.name == trace.WINDOW_SPAN:
                window = (e.start, e.end)
            host.append(e)
        elif not k.is_user_annotation():
            device.append(e)
    if window is None:
        raise RuntimeError(f"the profile holds no {trace.WINDOW_SPAN} span")
    return device, host, window


def _containing(spans: list, starts: list, t: float) -> int:
    """The index of the latest-starting of ``spans`` (sorted by start)
    open at ``t``, or -1."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[i].end >= t:
            return i
    return -1


def split(device: list, host: list, window: tuple[float, float],
          steps: int) -> dict | None:
    """The window's idle time in three parts, each in percent of the
    window (``in_replay_pct``, ``between_replays_pct``, ``host_pct``),
    beside ``idle_pct``, the ``replays`` found and ``host_s``, the
    host-bound seconds by the innermost ``tdm.*`` span at each gap's
    midpoint. None where the window holds no replay, where the
    ``tdm.graph.replay`` spans are not ``steps``, or where a replay's
    ``cudaGraphLaunch`` or its device operations cannot be found."""
    t0, t1 = window
    tr = trace.Trace(device, host, window, steps)
    # ``tr.host`` is sorted by start, and so is every list taken from it.
    inside = [e for e in tr.host if t0 <= e.start and e.end <= t1]
    replay_spans = [e for e in inside if e.name == REPLAY_SPAN]
    if not replay_spans or len(replay_spans) != steps:
        return None
    by_link: dict[int, list] = {}
    for e in tr.ops:
        if e.link:
            by_link.setdefault(e.link, []).append(e)
    span_starts = [e.start for e in replay_spans]
    units = [e for e in inside if e.name in UNIT_SPANS]
    unit_starts = [e.start for e in units]
    launched: dict[int, tuple] = {}
    for e in inside:
        if e.name != LAUNCH:
            continue
        i = bisect.bisect_right(span_starts, e.start) - 1
        if i < 0 or replay_spans[i].end < e.end:
            continue
        ops = by_link.get(e.link)
        if not ops:
            return None
        launched[i] = (max(t0, min(o.start for o in ops)),
                       min(t1, max(o.end for o in ops)),
                       _containing(units, unit_starts, e.start))
    if len(launched) != len(replay_spans):
        return None
    extents = sorted(launched.values())
    ext_starts = [x[0] for x in extents]
    named = [e for e in inside if e.name.startswith(SPAN_PREFIX)]
    named_starts = [e.start for e in named]
    parts = {"in_replay": 0.0, "between_replays": 0.0, "host": 0.0}
    host_s: dict[str, float] = {}
    for s, e in tr.gaps():
        i = bisect.bisect_right(ext_starts, s) - 1
        if i >= 0 and e <= extents[i][1]:
            parts["in_replay"] += e - s
        elif 0 <= i < len(extents) - 1 and extents[i][2] >= 0 \
                and extents[i][2] == extents[i + 1][2]:
            parts["between_replays"] += e - s
        else:
            parts["host"] += e - s
            j = _containing(named, named_starts, 0.5 * (s + e))
            name = named[j].name if j >= 0 else "none"
            host_s[name] = host_s.get(name, 0.0) + (e - s)
    out = {f"{k}_pct": 100.0 * v / tr.window_s for k, v in parts.items()}
    out["idle_pct"] = 100.0 * (1.0 - tr.busy_s / tr.window_s)
    out["replays"] = len(replay_spans)
    out["host_s"] = dict(sorted(host_s.items(), key=lambda kv: -kv[1]))
    return out


def coverage(device: list, host: list, window: tuple[float, float]) -> dict:
    """What the profile holds of the window's replays: its
    ``tdm.graph.replay`` spans, its ``cudaGraphLaunch`` events, and those
    launches whose link some device operation carries (``split`` reads
    nothing unless each is one a step)."""
    t0, t1 = window
    inside = [e for e in host if t0 <= e.start and e.end <= t1]
    links = {e.link for e in device if e.link}
    launches = [e for e in inside if e.name == LAUNCH]
    return {"replay_spans": sum(e.name == REPLAY_SPAN for e in inside),
            "launches": len(launches),
            "linked": sum(e.link in links for e in launches)}


def span_us(spans: int = 20000) -> dict:
    """Host µs of one ``runtime.span`` entered and left, with no profiler
    and under one that records CPU and CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.runtime import span

    def timed() -> float:
        t = time.perf_counter()
        for _ in range(spans):
            with span(REPLAY_SPAN):
                pass
        return (time.perf_counter() - t) / spans * 1e6

    off = timed()
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        on = timed()
    return {"off_us": off, "on_us": on}


def measure(root: Path, name: str, *, seed: int, units: int | None,
            device) -> dict:
    """Set up ``root``'s cell ``name`` on ``device``, run ``units`` units
    (default its ``trace_units``) without the profiler, then as many in a
    profiled window; the split of that window, both windows' steps a
    second, the ``tdm.*`` spans in the window and what a span costs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench import harness

    cell = harness.load_cell(root, name)
    precision = cell.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = precision["tf32"]
    torch.backends.cudnn.allow_tf32 = precision["tf32"]
    module = importlib.import_module(
        f"gpubench.builders.{cell.workload['builder']}")
    runner = module.build(cell, seed, device)
    runner.setup()
    units = units or cell.workload["traffic"]["trace_units"]
    t = time.perf_counter()
    plain_steps = sum(runner.unit()["steps"] for _ in range(units))
    plain_s = time.perf_counter() - t
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with trace.window_span():
            steps = sum(runner.unit()["steps"] for _ in range(units))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    device_ev, host_ev, window = linked_events(prof)
    return {"workload": name, "seed": seed, "units": units, "steps": steps,
            "split": split(device_ev, host_ev, window, steps),
            "coverage": coverage(device_ev, host_ev, window),
            "steps_s_traced": steps / (window[1] - window[0]),
            "steps_s_plain": plain_steps / plain_s,
            "spans": sum(e.name.startswith(SPAN_PREFIX) for e in host_ev),
            "span": span_us()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--units", type=int, default=None,
                        help="units a window (default the cell's "
                             "trace_units)")
    args = parser.parse_args(argv)
    from gpubench import run as bench_run

    bench_run._environment()
    import torch

    if not torch.cuda.is_available():
        print("gpubench.replays: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = measure(Path(__file__).resolve().parent.parent, args.workload,
                  seed=args.seed, units=args.units, device=device)
    out["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
