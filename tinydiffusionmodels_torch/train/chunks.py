"""Chunks of optimizer steps on device state (the counterpart of the JAX
trainers' K-step scans, ``make_train_step_multi[_ema]`` and
``make_text_train_step_multi[_ema]``, and of their ``TDM_SCAN_CHUNK``
flushes).

An epoch of S steps runs as chunks of K = ``TDM_SCAN_CHUNK`` steps
(default 25, read as the JAX trainers read it), then one chunk of the
remainder, S mod K, with one host read a chunk: that chunk's per-step
losses. Progress is logged every ``TDM_PROGRESS_EVERY`` chunks (default
10), as in the JAX trainers.

``EpochSteps`` holds what a step reads that the host used to pass it:
the epoch's batch order, the learning rate of every step of the epoch (a
table from the schedule, filled once an epoch) and a device step cursor
into both, the global step number on the device (the counter each step's
random draws fold into their key, ``core/rng.py``), and the per-step
losses the step writes. Each kind of step is
a ``graphs.Step``: on the card it is captured once and replayed, so a
chunk is K graph launches and one read; on the CPU it runs eagerly, with
the learning rate set on the host as ``LambdaLR`` sets it.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from tinydiffusionmodels_torch import graphs

# Eager steps of each kind on a side stream before its capture.
WARMUP = 2


def scan_chunk() -> int:
    """K, the steps of a chunk: ``TDM_SCAN_CHUNK`` (default 25), at least 1."""
    return max(1, int(os.environ.get("TDM_SCAN_CHUNK", "25")))


def progress_every() -> int:
    """Chunks between progress lines: ``TDM_PROGRESS_EVERY`` (default 10;
    0 logs none)."""
    return int(os.environ.get("TDM_PROGRESS_EVERY", "10"))


def chunk_lengths(steps: int, chunk: int) -> list[int]:
    """The JAX trainers' flushes of an epoch of ``steps``: K steps each,
    then the remainder."""
    lengths = [chunk] * (steps // chunk)
    if steps % chunk:
        lengths.append(steps % chunk)
    return lengths


class EpochSteps:
    """Device state of one epoch's steps, read through a device cursor.

    ``step(variant)`` runs one step: it calls ``set_lr``, reads its batch
    rows with ``rows``, draws with keys folded from ``step`` (the global
    step, a (1,) device tensor), and ends with ``finish`` on its losses;
    ``run_variants`` runs a chunk. Each variant (the self-conditioning coin
    of a text step, or None) is its own ``graphs.Step``. ``lr_at`` maps a
    global step to its learning rate (``base_lr * LambdaLR``'s lambda);
    None keeps the optimizer's."""

    def __init__(self, step: Callable, *, optimizer, steps: int,
                 batch_size: int, loss_width: int, device, variants=(None,),
                 lr_at: Callable[[int], float] | None = None,
                 eager: bool = False):
        device = torch.device(device)
        self.optimizer = optimizer
        self.lr_at = lr_at
        self.device_lr = any(torch.is_tensor(g["lr"])
                             for g in optimizer.param_groups)
        self.order = torch.zeros((steps, batch_size), dtype=torch.long,
                                 device=device)
        # (cursor, global step): one add advances both.
        self.counters = torch.zeros((2,), dtype=torch.long, device=device)
        self.cursor = self.counters[0:1]
        self.step = self.counters[1:2]
        self.first_step = 0
        self.losses = torch.zeros((steps, loss_width), device=device)
        self.lrs = torch.zeros((steps,), device=device)
        self.lr_values: list = []
        self.done = 0
        self.kinds = {v: graphs.Step(lambda v=v: step(v), device,
                                     warmup=WARMUP, eager=eager)
                      for v in variants}

    def start(self, order: np.ndarray, first_step: int = 0) -> None:
        """A new epoch: its (steps, batch) batch order and, with ``lr_at``,
        the learning rates of its global steps from ``first_step``."""
        n = len(order)
        self.order[:n].copy_(torch.as_tensor(np.asarray(order)))
        self.counters.copy_(torch.tensor([0, first_step]))
        self.first_step = first_step
        self.done = 0
        if self.lr_at is not None:
            # Python floats, as LambdaLR computes them.
            self.lr_values = [self.lr_at(first_step + i)
                              for i in range(self.order.shape[0])]
            if self.device_lr:
                self.lrs.copy_(torch.tensor(self.lr_values,
                                            dtype=torch.float32))

    # --- inside a step -----------------------------------------------------

    def rows(self) -> torch.Tensor:
        """The (batch,) dataset rows of the cursor's step."""
        return self.order.index_select(0, self.cursor).squeeze(0)

    def set_lr(self) -> None:
        """On the card, the learning-rate tensor <- the cursor's entry of
        the table (the CPU's is set on the host, in ``run_variants``)."""
        if self.lr_at is not None and self.device_lr:
            lr = self.lrs.index_select(0, self.cursor).squeeze(0)
            for group in self.optimizer.param_groups:
                group["lr"].copy_(lr)

    def finish(self, losses: torch.Tensor) -> None:
        """Write the step's losses at the cursor and advance it and the
        global step."""
        self.losses.index_copy_(0, self.cursor, losses.reshape(1, -1))
        self.counters.add_(1)

    # --- on the host ---------------------------------------------------------

    def run_variants(self, variants: list) -> np.ndarray:
        """One chunk: a step of each of ``variants`` in turn, then one host
        read of their (n, loss_width) losses."""
        first = self.done
        if first + len(variants) > self.order.shape[0]:
            raise ValueError(f"{len(variants)} more steps run past the "
                             f"epoch's {self.order.shape[0]} (at {first})")
        for i, variant in enumerate(variants):
            if self.lr_at is not None and not self.device_lr:
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr_values[first + i]
            self.kinds[variant]()
        self.done = first + len(variants)
        return self.losses[first:self.done].cpu().numpy()
