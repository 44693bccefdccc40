"""Training throughput: the examples of every optimizer step finished in
the window over the window's wall time, whole chunks each ending in its
host read."""


def read(run):
    if not run.window.examples:
        return None
    return run.window.examples / run.window.seconds
