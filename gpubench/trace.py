"""The traced window: ``torch.profiler`` over the window's units, and the
arithmetic that turns its events into per-layer readings.

Device time is the union of the device operations' intervals (kernels,
copies, fills) inside the window, so overlapping operations count once;
the window is the benchmark's own span around the traced units
(``gpubench.window``) on the profiler's clock. Idle gaps are named by
what the host was doing at their midpoint: the innermost host event
around it (a span of the benchmark, a runtime call, an operator), or
``host idle`` where none was open.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

WINDOW_SPAN = "gpubench.window"
TOP = 10
NAME_CHARS = 160        # a kernel's name is cut to this in a breakdown
# Device operations that are not kernel launches.
_NOT_KERNELS = ("memcpy", "memset")


@dataclasses.dataclass
class Event:
    name: str
    start: float     # seconds on the profiler's clock
    end: float


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """The device and host events of one traced window, and ``steps``, the
    optimizer or reverse steps the window ran."""

    def __init__(self, device: list[Event], host: list[Event],
                 window: tuple[float, float], steps: int):
        t0, t1 = window
        self.window_s = t1 - t0
        self.steps = steps
        self.ops = [e for e in device if e.end > t0 and e.start < t1]
        self.kernels = [e for e in self.ops
                        if not any(w in e.name.lower() for w in _NOT_KERNELS)]
        self.busy = _union([(max(e.start, t0), min(e.end, t1))
                            for e in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy)
        self.host = sorted((e for e in host if e.name != WINDOW_SPAN),
                           key=lambda e: e.start)
        self._window = window

    def matching(self, word: str) -> list[Event]:
        """The kernels whose lower-cased name holds ``word``."""
        return [e for e in self.kernels if word in e.name.lower()]

    def gaps(self) -> list[tuple[float, float]]:
        t0, t1 = self._window
        edges = [t0] + [x for iv in self.busy for x in iv] + [t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def _host_at(self, t: float, starts: list[float]) -> str:
        """The innermost host event open at ``t``: the latest to start."""
        i = bisect.bisect_right(starts, t)
        for e in reversed(self.host[max(0, i - 512):i]):
            if e.end >= t:
                return e.name
        return "host idle"

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        time by what the host was doing, TOP of each, in seconds."""
        ops: dict[str, float] = {}
        for e in self.ops:
            ops[e.name] = ops.get(e.name, 0.0) + (e.end - e.start)
        starts = [e.start for e in self.host]
        idle: dict[str, float] = {}
        for s, e in self.gaps():
            name = self._host_at(0.5 * (s + e), starts)
            idle[name] = idle.get(name, 0.0) + (e - s)

        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def roofline_pct(trace: Trace, calls):
    """The sum of each call's least time over the device time of the
    kernels that ran them, in percent. ``calls`` pairs a word of a
    kernel's name with the least times of one round of its calls in the
    order they run (one forward's four residual blocks, or one call); the
    kernels found are taken round by round. None where none ran."""
    bound = time_s = 0.0
    for word, bounds_s in calls or ():
        hits = trace.matching(word)
        if not hits:
            continue
        time_s += sum(e.end - e.start for e in hits)
        rounds, rest = divmod(len(hits), len(bounds_s))
        bound += rounds * sum(bounds_s) + sum(bounds_s[:rest])
    return 100.0 * bound / time_s if time_s else None


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the block (CPU and, on the card, CUDA activity); yields a
    list that receives the (device events, host events, window) once the
    block has ended. The block opens ``window_span()`` around its
    units."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out: list = []
    with profile(activities=activities) as prof:
        yield out
    out.extend(events(prof))


def window_span():
    return torch.profiler.record_function(WINDOW_SPAN)


def events(prof) -> tuple[list[Event], list[Event], tuple[float, float]]:
    """(device events, host events, the window span) of a finished
    profile, from the profiler's raw events."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    base = results.trace_start_ns()   # seconds from here keep sub-µs digits
    device, host, window = [], [], None
    for k in results.events():
        start = (k.start_ns() - base) * 1e-9
        e = Event(k.name(), start, start + k.duration_ns() * 1e-9)
        if k.device_type() == DeviceType.CPU:
            if e.name == WINDOW_SPAN:
                window = (e.start, e.end)
            host.append(e)
        elif not k.is_user_annotation():
            device.append(e)
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN} span")
    return device, host, window
