"""Set-up: from the process's start to the first timed unit (imports,
the kernel library's build or load, the weights and data made from the
seed, warm-up, graph capture and, in a training cell, the three checked
steps), on the host clock."""


def read(run):
    return run.setup_s
