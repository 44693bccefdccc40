"""What every sampling cell shares: whole ancestral batches of the
program's ``sample.ancestral.Sampler``, back to back, each from its own
key, and the check of a sample of their rows against the reference.

Batch b draws from ``fold_in(substream(PRNGKey(seed), "sample"), b)``.
Set-up builds the sampler once and warms it with two reverse steps of its
one kind of step (the first eager, the second captured and replayed) and
the cell's finishing work; every batch of the window then replays. A
batch ends in its host read of what it produced. After the window the
check draws from the seed ``checked_batches`` batches (the last one
always) and, in each, ``checked_rows`` rows from each half of the batch,
and the reference runs those rows' whole chains again.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import weights
from gpubench.harness import Phases
from gpubench.reference import keytree


class Sampling:
    """A sampling cell. A subclass gives ``specs``, ``program`` (the
    sampler and the finishing function: the program's outputs of a batch
    from its final x), ``batch_flops``, ``reference_rows`` (the
    reference's outputs of some rows) and ``compare``."""

    kind = "sample"

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        traffic = cell.workload["traffic"]
        self.n = traffic["n"]
        self.checked_batches = traffic["checked_batches"]
        self.checked_rows = traffic["checked_rows"]
        self.timesteps = cell.config["model"]["timesteps"]
        self.bounds: dict = {}
        self.phases: dict = {}
        self.flops = self.batch_flops()
        self.outputs: list[dict] = []

    def key(self, batch: int) -> tuple[int, int]:
        return keytree.fold_in(
            keytree.substream(keytree.prng_key(self.seed), "sample"), batch)

    def params(self) -> dict:
        return weights.draw(self.specs(),
                            weights.generator(self.seed, self.device),
                            self.device)

    def setup(self) -> None:
        clock = Phases(self.phases)
        self.sampler, self.finish = self.program(self.params())
        clock("program")
        with torch.inference_mode():
            self.sampler.x.zero_()
            run = self.sampler.schedule[0]
            run(0)
            run(0)
            self.sampler.i.zero_()
            self.finish(self.sampler.x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        clock("warm-up")

    def unit(self) -> dict:
        """One whole batch, ending in its host read of the outputs."""
        b = len(self.outputs)
        with torch.profiler.record_function("gpubench.batch"):
            x = self.sampler(torch.tensor(self.key(b), dtype=torch.int64))
            with torch.inference_mode():
                out = self.finish(x)
            out = {k: v.cpu() for k, v in out.items()}
        self.outputs.append(out)
        return {"steps": self.timesteps, "samples": self.n,
                "flops": self.flops}

    def free(self) -> None:
        del self.sampler, self.finish

    def picks(self) -> list[tuple[int, list[int]]]:
        """(batch, rows) checked: drawn from the seed once the window has
        closed, the last batch among them, rows from both halves."""
        rng = np.random.default_rng([self.seed, 1])
        last = len(self.outputs) - 1
        others = rng.permutation(last)[:self.checked_batches - 1].tolist()
        half = self.n // 2
        out = []
        for b in sorted(others) + [last]:
            rows = (rng.choice(half, self.checked_rows, replace=False).tolist()
                    + (half + rng.choice(self.n - half, self.checked_rows,
                                         replace=False)).tolist())
            out.append((b, sorted(rows)))
        return out

    def reference(self, picks, *, tf32: bool = False) -> list[dict]:
        """The reference's outputs of the picked rows, float32 (``tf32``:
        with TF32 products, the control)."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            params = self.params()
            with torch.no_grad():
                return [{k: v.cpu() for k, v in self.reference_rows(
                    params, self.key(b), rows).items()} for b, rows in picks]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def program_rows(self, picks) -> list[dict]:
        return [{k: v[rows] for k, v in self.outputs[b].items()}
                for b, rows in picks]

    def check(self) -> dict:
        picks = self.picks()
        return self.compare(self.program_rows(picks), self.reference(picks))


def sample_gap(prog: list, ref: list, key: str = "x") -> float:
    """The largest gap of an output element over the largest magnitude of
    the reference's, over every picked row."""
    diff = max(float((p[key] - r[key]).abs().max()) for p, r in zip(prog, ref))
    scale = max(float(r[key].abs().max()) for r in ref)
    return diff / scale
