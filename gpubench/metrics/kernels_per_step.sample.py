"""Kernels the profiler recorded in the traced window over the optimizer
or reverse steps in it (sample cells); copies and fills are not kernels."""


def read(run):
    if run.trace is None or run.runner.kind != "sample" \
            or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.steps
