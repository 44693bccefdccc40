"""Device selection for the port (counterpart of ``runtime.configure_platform``).

``TDM_PLATFORM`` is the same variable the JAX package reads. Unset or
``cuda`` selects the GPU; ``cpu`` selects the CPU, where every op runs its
plain PyTorch version. There is no silent fallback: asking for the GPU on a
machine without one is an error.
"""

from __future__ import annotations

import contextlib
import os

import torch


def device() -> torch.device:
    """The device named by ``TDM_PLATFORM`` (default ``cuda``)."""
    platform = os.environ.get("TDM_PLATFORM", "").strip().lower() or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(
            f"TDM_PLATFORM={platform!r} is not a platform of the torch "
            "package; use 'cuda' (the default) or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available to torch; set TDM_PLATFORM=cpu to run on "
            "the CPU with the plain PyTorch versions of the kernels"
        )
    return torch.device("cuda")


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` over the block (counterpart of the JAX package's
    ``runtime.profile_trace``); does nothing when ``logdir`` is None.

    Records CPU activity, and CUDA activity where torch sees a card (a
    graph's replay shows as its kernels). At the end it writes into
    ``logdir`` the Chrome trace ``trace.json`` (chrome://tracing, Perfetto)
    and ``ops.txt``, the per-op table sorted by device time (by CPU time
    without a card)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "self_device_time_total" if cuda else "self_cpu_time_total"
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=-1,
                                          max_name_column_width=120))
    print(f"[profile] wrote trace.json and ops.txt to {logdir}")
