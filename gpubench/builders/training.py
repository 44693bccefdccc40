"""What every training cell shares: epochs of the program's chunk runner,
the first three steps that set-up drives and the check holds against
the reference, and the comparison.

Set-up builds the program's chunk runner once (model, AdamW, the data
on the device), starts epoch 0 and runs its first three steps through
the runner's own call, one step a call: the first two run eagerly, the
third is captured and replayed, so the window replays only. After step 1
the gradient is read from AdamW's first moment (exp_avg = (1 - beta1)
g); after step 3 each parameter's change from its initial value. The
window then runs the same runner on: chunks of ``chunk`` steps, each
ending in its host read of the losses, through epochs of
``epoch_steps`` steps whose batch order is drawn from the seed.

The numbers compared (see ``compare``): the worst step's loss gap, the
worst leaf's gap of gradient norms, the worst leaf's gap of the norms
of three steps' change.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from gpubench import weights
from gpubench.harness import Phases

CHECKED_STEPS = 3
BETA1 = 0.9


@dataclasses.dataclass
class Readings:
    losses: np.ndarray       # (CHECKED_STEPS, k): the losses compared
    grads: dict              # leaf -> the norm of step 1's gradient
    change: dict             # leaf -> the norm of its change over 3 steps


def readings(prog: Readings, ref: Readings) -> dict:
    """``compare``'s numbers and, beside them, the readings that were
    weighed against them (``gpubench/control.py`` prints both): each
    step's loss gap and the median leaf's gap of change."""
    out = compare(prog, ref)
    gaps = np.abs(prog.losses - ref.losses) / np.abs(ref.losses)
    out["loss_gap_steps"] = gaps.max(axis=1).tolist()
    med_g = statistics.median(ref.grads.values())
    moved = [k for k, g in ref.grads.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref.change[k] for k in moved)
    out["update_gap_median"] = statistics.median(
        abs(prog.change[k] - ref.change[k]) / max(ref.change[k], med_c)
        for k in moved)
    out["left_out"] = len(ref.grads) - len(moved)
    return out


def compare(prog: Readings, ref: Readings) -> dict:
    """The numbers that decide ``correct``:

    - ``loss_gap``: the largest relative gap of a step's loss;
    - ``grad_gap``: over leaves, the largest gap between the norms of
      step 1's gradient, over the larger of the reference's norm of that
      leaf and of the median leaf;
    - ``update_gap``: the same of each leaf's change over three steps,
      leaving out leaves whose reference gradient is under a thousandth
      of the median leaf's (AdamW moves those by round-off alone)."""
    loss_gap = float(np.max(np.abs(prog.losses - ref.losses)
                            / np.abs(ref.losses)))
    med_g = statistics.median(ref.grads.values())
    grad_gap = max(abs(prog.grads[k] - g) / max(g, med_g)
                   for k, g in ref.grads.items())
    moved = [k for k, g in ref.grads.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref.change[k] for k in moved)
    update_gap = max(abs(prog.change[k] - ref.change[k])
                     / max(ref.change[k], med_c) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}


class Training:
    """A training cell. A subclass gives ``inputs`` (the leaves and the
    data from the generator), ``program`` (the chunk runner, its named
    parameters and its optimizer), ``start_kw``, ``loss_columns``,
    ``reference_losses``, ``step_flops``, and ``lr`` and ``weight_decay``
    before this constructor runs."""

    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        traffic = cell.workload["traffic"]
        self.batch = traffic["batch"]
        self.chunk = traffic["chunk"]
        self.epoch_steps = traffic["epoch_steps"]
        self.bounds: dict = {}
        self.phases: dict = {}
        self.flops = self.step_flops()

    # --- the feed ------------------------------------------------------------

    def order(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s (steps, batch) rows of the data: a permutation
        drawn from the seed, so every row of an epoch differs."""
        rng = np.random.default_rng([self.seed, epoch])
        return rng.permutation(self.epoch_steps * self.batch).reshape(
            self.epoch_steps, self.batch)

    def inputs(self, gen):
        raise NotImplementedError

    # --- set-up and the window ---------------------------------------------

    def setup(self) -> None:
        clock = Phases(self.phases)
        params, data = self.inputs(weights.generator(self.seed, self.device))
        clock("inputs")
        self.steps, named, self.optimizer = self.program(params, data)
        clock("program")
        self.epoch, self.pos, self.global_step = 0, 0, 0
        self.steps.start(self.order(0), **self.start_kw(0))
        losses = [self.steps.run(1)]
        clock("step 1")
        # A parameter the optimizer never stepped holds no moment: 0.
        grads = {k: float(self.optimizer.state[p].get(
            "exp_avg", torch.zeros(())).norm()) / (1.0 - BETA1)
            for k, p in named}
        losses += [self.steps.run(1) for _ in range(CHECKED_STEPS - 1)]
        clock("steps 2-3")
        with torch.no_grad():
            change = {k: float((p - params[k]).norm()) for k, p in named}
        self.prog = Readings(
            np.concatenate([np.asarray(x).reshape(1, -1)
                            for x in losses])[:, self.loss_columns],
            grads, change)
        self.pos = self.global_step = CHECKED_STEPS

    def unit(self) -> dict:
        """One chunk, ending in its host read of the losses."""
        if self.pos == self.epoch_steps:
            self.epoch += 1
            self.pos = 0
            self.steps.start(self.order(self.epoch),
                             **self.start_kw(self.global_step))
        n = min(self.chunk, self.epoch_steps - self.pos)
        with torch.profiler.record_function("gpubench.chunk"):
            losses = self.steps.run(n)
        if not np.all(np.isfinite(losses)):
            raise FloatingPointError(f"a loss of steps {self.global_step}"
                                     f"..{self.global_step + n} is not finite")
        self.pos += n
        self.global_step += n
        return {"steps": n, "examples": n * self.batch,
                "flops": n * self.flops}

    def free(self) -> None:
        del self.steps, self.optimizer

    # --- the check ---------------------------------------------------------

    def reference(self, *, tf32: bool = False,
                  half_batch: bool = False) -> Readings:
        """The reference's readings of the first three steps, computed in
        float32 (``tf32``: with TF32 products, the control), from the
        seed's weights and data; ``half_batch`` leaves out the second half
        of each batch (a planted fault)."""
        from gpubench.reference.adamw import AdamW

        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            params, data = self.inputs(
                weights.generator(self.seed, self.device))
            train = {k: params[k].clone().requires_grad_()
                     for k in self.trainable(params)}
            opt = AdamW(train, self.lr, self.weight_decay)
            order, losses, grads = self.order(0), [], None
            for s in range(CHECKED_STEPS):
                rows = torch.as_tensor(order[s], device=self.device)
                if half_batch:
                    rows = rows[:len(rows) // 2]
                out = self.reference_losses(train, params, data, rows, s)
                g = torch.autograd.grad(out[-1], list(train.values()))
                g = dict(zip(train, g))
                if grads is None:
                    grads = {k: float(v.norm()) for k, v in g.items()}
                opt.step(g)
                losses.append([float(x.detach()) for x in out])
            with torch.no_grad():
                change = {k: float((v - params[k]).norm())
                          for k, v in train.items()}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
        return Readings(np.asarray(losses)[:, self.loss_columns], grads,
                        change)

    def check(self) -> dict:
        return compare(self.prog, self.reference())

    def trainable(self, params: dict) -> list[str]:
        return list(params)
