"""Every cell run end to end on the CPU at a tiny size, from a directory
that holds only its data files (the harness finds a new cell by its
files alone); and each fault a cell can have, planted in the program
underneath, makes ``correct`` come out false. The harness's look for a
chip is skipped: ``run_cell`` is given the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import harness
from gpubench.tests import tiny

CELLS = ("textdiff_d2048.train_bs32", "mnist_unet.train_bs128",
         "mnist_unet.sample_n256", "textdiff_d2048.sample_n10")
SEED = 2**31 + 11      # past 32 signed bits


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("TDM_FAST_NOISE", "1")
    return tiny.make_root(tmp_path, rename="_new")


def _run(root, cell, trace=False):
    return harness.run_cell(root, cell + "_new", seed=SEED, seconds=0.2,
                            trace=trace, device=torch.device("cpu"),
                            start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_from_its_files_alone(root, cell, trace):
    r = _run(root, cell, trace)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    want = harness.load_cell(root, cell + "_new")
    names = {m["name"] for m in (want.per_layer if trace
                                 else want.end_to_end)}
    if trace:
        # No device on the CPU: the kernels' readers find nothing to read.
        assert {"mfu.train", "mfu.sample"} & set(r["metrics"])
        assert r["device"]["window_s"] > 0 and "breakdown" in r
    else:
        assert set(r["metrics"]) == names
    assert set(r["metrics"]) <= names
    assert r["device"]["platform"] == "cpu"


def _broken(monkeypatch, fault: str, cell: str) -> None:
    """Plant ``fault`` in the program for ``cell``."""
    from tinydiffusionmodels_torch.sample import ancestral
    from tinydiffusionmodels_torch.sample import text as sample_text
    from tinydiffusionmodels_torch.train import chunks, mnist_train, text_train

    if fault == "state_unchanged" and ".train" in cell:
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    elif fault == "state_unchanged":
        monkeypatch.setattr(ancestral, "p_sample",
                            lambda sched, x, *a, **k: x)
    elif fault == "half_batch" and cell.startswith("textdiff") and \
            ".train" in cell:
        losses = text_train._losses

        def half(joint, tokens, t, noise, *a, **k):
            h = tokens.shape[0] // 2
            return losses(joint, tokens[:h], t[:h], noise[:h], *a, **k)

        monkeypatch.setattr(text_train, "_losses", half)
    elif fault == "half_batch" and ".train" in cell:
        step = mnist_train.optimizer_step

        def half(model, optimizer, batch, t, noise, *a, **k):
            h = batch.shape[0] // 2
            return step(model, optimizer, batch[:h], t[:h], noise[:h], *a,
                        **k)

        monkeypatch.setattr(mnist_train, "optimizer_step", half)
    elif fault == "half_batch":
        p_sample = ancestral.p_sample

        def half(sched, x, t, *a, **k):
            out = p_sample(sched, x, t, *a, **k)
            h = x.shape[0] // 2
            return torch.cat([out[:h], x[h:]])

        monkeypatch.setattr(ancestral, "p_sample", half)
    elif fault == "answer_altered" and ".train" in cell:
        finish = chunks.EpochSteps.finish
        monkeypatch.setattr(chunks.EpochSteps, "finish",
                            lambda self, losses: finish(self, losses * 1.01))
    elif fault == "answer_altered" and cell.startswith("textdiff"):
        decode = sample_text.decode_embeddings

        def altered(x, **k):
            tokens = decode(x, **k).clone()
            tokens[:, 0] = (tokens[:, 0] + 1) % tiny.TEXT["vocab_size"]
            return tokens

        monkeypatch.setattr(sample_text, "decode_embeddings", altered)
    elif fault == "answer_altered":
        call = ancestral.Sampler.__call__

        def altered(self, *a, **k):
            x = call(self, *a, **k).clone()
            x[:, 0, 0, 0] += 1.0
            return x

        monkeypatch.setattr(ancestral.Sampler, "__call__", altered)
    else:
        raise ValueError(fault)


FAULTS = [(c, f) for c in CELLS
          for f in ("state_unchanged", "half_batch", "answer_altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_program_is_not_correct(root, monkeypatch, cell, fault):
    _broken(monkeypatch, fault, cell)
    r = _run(root, cell)
    assert r["correct"] is False and r["failed"] >= 1
