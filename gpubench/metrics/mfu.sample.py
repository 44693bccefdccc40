"""The whole step's share of the chip's dense bf16 peak (sample cells):
the benchmark's own FLOPs of the traced units (``gpubench/work/flops.py``)
over the traced window, in percent, whatever precision the work ran in."""

from gpubench.work import peaks


def read(run):
    if run.trace is None or run.runner.kind != "sample":
        return None
    rate = run.window.flops / run.trace.window_s
    return 100.0 * rate / peaks.PEAK_FLOPS
