"""The benchmark of the PyTorch and CUDA port (``tinydiffusionmodels_torch``).

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the repo's root names the cells, configurations and
metrics; each configuration, cell and metric has its own file here
(``configs/``, ``workloads/``, ``metrics/``), and each kind of cell its
builder (``builders/``). The yardstick (traffic, the counts of work and
the peaks, the trace's arithmetic, the plain reference) lives here and not
in the program.
"""
