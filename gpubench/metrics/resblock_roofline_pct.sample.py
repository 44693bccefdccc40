"""The fused residual-block kernel of the traced window (sample cells): the
sum of each call's least time (its bytes at the HBM rate or its FLOPs at
the bf16 peak, the larger; ``gpubench/work/kernels.py``, the four
blocks of a forward in turn) over its profiled device time, in percent.
Nothing where none ran."""

from gpubench import trace


def read(run):
    if run.trace is None or run.runner.kind != "sample":
        return None
    return trace.roofline_pct(run.trace, run.runner.bounds.get("resblock"))
