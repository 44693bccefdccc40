"""One builder per kind of cell, named by a workload file's ``builder``."""
