"""The wide flash kernels (head width above 256: forward, dq, dk/dv) of
the traced window (sample cells): the sum of each call's least time (its
bytes at the HBM rate or its FLOPs at the bf16 peak, the larger;
``gpubench/work/kernels.py``) over their profiled device time, in
percent. Nothing where none ran."""

from gpubench import trace


def read(run):
    if run.trace is None or run.runner.kind != "sample":
        return None
    return trace.roofline_pct(run.trace, run.runner.bounds.get("flash_wide"))
