"""Run one cell of the port's benchmark and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``tinydiffusionmodels_torch``). It runs on the CUDA
device of this machine and refuses to run without one (or with fewer
than the cell asks for): it never falls back to the CPU. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: every number compared beside its limit, which also
end standard error). ``setup_s`` runs from this process's start to the
first timed unit. Build and kernel caches stay inside the checkout under
``build/``.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Settings the run fixes before torch and the program are imported:
    the program's counter-hash draws on every device, no JAX through a
    library, and every cache inside the checkout."""
    os.environ["TDM_FAST_NOISE"] = "1"
    os.environ["USE_FLAX"] = "0"
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    # The script's own folder comes first on the path; its modules would
    # shadow any library module of the same name (``trace``).
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != HERE]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    import torch

    from gpubench import harness

    imported = time.perf_counter()

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"gpubench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    print(f"imports {imported - START:.3f} s, CUDA context "
          f"{time.perf_counter() - imported:.3f} s", file=sys.stderr)
    result = harness.run_cell(ROOT, args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device=device, start=START,
                              log=lambda line: print(line, file=sys.stderr))
    found = harness.banned_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
