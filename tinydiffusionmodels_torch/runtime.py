"""Device selection for the port (counterpart of ``runtime.configure_platform``).

``TDM_PLATFORM`` is the same variable the JAX package reads. Unset or
``cuda`` selects the GPU; ``cpu`` selects the CPU, where every op runs its
plain PyTorch version. There is no silent fallback: asking for the GPU on a
machine without one is an error.
"""

from __future__ import annotations

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
