"""The share of the traced window in which no operation ran on the
device: the union of the device operations' intervals, against the
window, in percent (sample cells)."""


def read(run):
    if run.trace is None or run.runner.kind != "sample":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
