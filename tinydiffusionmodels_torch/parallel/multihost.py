"""Process-group bring-up (port of ``parallel/multihost.py``).

The port runs one process per GPU, started by ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N -m tinydiffusionmodels_torch.
shakespeare --train ...``), which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` in each process's
environment. This module holds the pieces that depend on that:

- ``initialize()``: ``torch.distributed.init_process_group`` from
  torchrun's environment, NCCL on the card and gloo on the CPU; a no-op in
  a process that torchrun did not start, as the JAX package's is with no
  coordinator configured;
- ``process_batch_slice()``: which rows of the global batch this process
  trains on.

The JAX package's ``make_global_batch`` has no counterpart: torch has no
global array. Each rank holds its own rows (and, with a sequence axis, its
own token positions) as an ordinary tensor, and the collectives that GSPMD
inserts in the JAX package are written out (``parallel/data_parallel.py``,
``parallel/ring_attention.py``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tinydiffusionmodels_torch import runtime


def initialize(init_method: str | None = None) -> bool:
    """Join the process group torchrun describes; returns whether this
    process is in one.

    With no ``WORLD_SIZE`` in the environment it does nothing and returns
    False. Otherwise the backend is NCCL when ``runtime.device()`` is the
    card (``cuda:LOCAL_RANK``; the communicator is created here, so a
    failed NCCL init raises here) and gloo when it is the CPU
    (``TDM_PLATFORM=cpu``). ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``); a ``file://`` store serves tests.
    Calling it again in a process that already joined is a no-op."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    dev = runtime.device()
    kw = {}
    if dev.type == "cuda":
        backend = "nccl"
        kw["device_id"] = dev
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), **kw)
    if dev.type == "cuda":
        # Create the NCCL communicator now: a card that cannot join (two
        # ranks on one GPU, say) fails here, not inside a training step.
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize(dev)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_batch_slice(global_batch_size: int) -> slice:
    """Rows of the global batch this process trains on: contiguous blocks
    by rank; the global batch must divide by the number of processes."""
    n, i = process_count(), process_index()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes"
        )
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)
