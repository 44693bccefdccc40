"""Generation throughput: the samples of every whole batch finished in
the window over the window's wall time; the window ends when the first
batch that finishes after the time finishes."""


def read(run):
    if not run.window.samples:
        return None
    return run.window.samples / run.window.seconds
