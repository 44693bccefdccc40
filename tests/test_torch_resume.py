"""``--resume`` in the torch package's trainers and CLIs, on the CPU.

- A run stopped after an epoch and resumed from its ``_state.pth`` equals
  the uninterrupted run bit for bit (tolerance 0): the final and best
  checkpoints, the last resume file, and the step losses and metrics
  records of the epochs after the restart (``it_per_s`` aside, a
  time). Text with self-conditioning, dropout 0.1 and an EMA under the
  cosine schedule; text with ``--freeze_embeddings`` at a constant
  learning rate; MNIST with an EMA. The stop is a ``log_fn`` that raises
  at ``Epoch 2/3``: after epoch 2's steps, before its resume file.
- The same in a 2-process gloo data-parallel run. Every draw is keyed on
  (seed, step) (``core/rng.py``), so the file holds no generator state
  and a run resumes at another data-parallel width: saved at width 2 and
  resumed at 1, and saved at 1 and resumed at 2, the final weights equal
  the uninterrupted run's at the new width up to the all-reduce's
  rounding (AdamW at lr 1e-3: atol 1e-5, and 2 lr a step on the key
  bias's slice, whose gradient is rounding noise that AdamW turns into
  steps of up to lr). A file an earlier port wrote, with generator states,
  still loads: that key is ignored with one log line.
- The file is the JAX package's resume dict both ways: the port resumes a
  file the JAX trainers wrote, its weights equal to JAX's and its AdamW
  moments and step equal to optax's ``mu``, ``nu`` and ``count`` laid out
  by the JAX package's own converters (tolerance 0, a layout move), and
  carries the JAX run on: a JAX text run stopped after epoch 1 and
  resumed by the port ends where the uninterrupted JAX run ends (dropout
  0; the same tolerances); the JAX trainers resume a file the port wrote,
  their optimizer leaves equal to the port's.
- A corrupt file starts fresh, in both trainers.
- A ``SIGKILL`` drill on the text CLI (``TDM_PLATFORM=cpu``) at the sizes
  of ``tests/test_fault_injection.py``'s: the resumed run restores an
  epoch and writes the uninterrupted run's final checkpoint.
"""

from __future__ import annotations

import os
import signal
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import spawn, worker_main  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DIM, VOCAB, L, B = 16, 29, 8, 4
TRAIN, VAL = 36, 8      # 9 steps an epoch at batch 4
# The JAX trainers lay each batch over the 8 virtual CPU devices.
B_JAX = 8
EPOCHS = 3


class Stop(Exception):
    """The interruption: raised by ``log_fn`` at ``Epoch 2/3``."""


def _stopping_log(msg, *_):
    if str(msg).startswith(f"Epoch 2/{EPOCHS}"):
        raise Stop()


def _chunks(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (TRAIN, L)).astype(np.int64),
            rng.integers(0, VOCAB, (VAL, L)).astype(np.int64))


def _joint(self_cond=False, dropout=0.1):
    import torch
    from torch import nn

    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.core.rng import prng_key, substream

    torch.set_num_threads(1)
    cfg = TransformerConfig(dim=DIM, n_heads=2, depth=1, dropout=dropout,
                            ffn_dim=32, timesteps=50, self_cond=self_cond)
    root = prng_key(0)
    return nn.ModuleDict({
        "diffusion_model": TinyTransformer(
            cfg, key=substream(root, "diffusion")),
        "rounding_fn": LearnedRounding(
            DIM, VOCAB, key=substream(root, "rounding")),
        "embedding_fn": LearnedEmbedding(
            VOCAB, DIM, key=substream(root, "embedding")),
    })


def _text_train(workdir: Path, log_fn, *, self_cond=False, ema_decay=None,
                freeze_embeddings=False, use_lr_scheduling=True, mesh=None,
                epochs=EPOCHS, batch_size=B):
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.train import text_train

    train_chunks, val_chunks = _chunks()
    return text_train.train(
        _joint(self_cond), train_chunks, val_chunks,
        sched=make_schedule(50), ckpt_path=str(workdir / "t.pth"),
        epochs=epochs, batch_size=batch_size, lr=1e-3, warmup_steps=4,
        patience=100, seed=3, ema_decay=ema_decay, freeze_embeddings=freeze_embeddings,
        use_lr_scheduling=use_lr_scheduling, mesh=mesh, resume=True,
        resume_every=1, log_fn=log_fn)


def _write_mnist_idx(root: Path, n: int) -> None:
    """``n`` synthetic digits as the standard IDX files, which both
    packages' ``load_mnist`` read (no render of 60 000 digits)."""
    from tinydiffusionmodels_torch.data.mnist import _synthetic_mnist

    images, labels = _synthetic_mnist(n, seed=0)
    root.mkdir(parents=True, exist_ok=True)
    for name, array in (("train-images-idx3-ubyte", images),
                        ("train-labels-idx1-ubyte", labels)):
        (root / name).write_bytes(
            struct.pack(">I", 0x0800 | array.ndim)
            + struct.pack(f">{array.ndim}I", *array.shape)
            + array.astype(np.uint8).tobytes())


@pytest.fixture()
def mnist_env(tmp_path, monkeypatch):
    _write_mnist_idx(tmp_path / "digits", 48)
    monkeypatch.setenv("TDM_DATA_LIMIT", "40")      # 5 steps of 8
    monkeypatch.setenv("TDM_PROGRESS_EVERY", "0")
    monkeypatch.delenv("AIP_MODEL_DIR", raising=False)
    return tmp_path


def _mnist_train(workdir: Path, log_fn, *, ema_decay=None, epochs=EPOCHS):
    from tinydiffusionmodels_torch.train import mnist_train

    return mnist_train.train(
        epochs=epochs, batch_size=8, ckpt_path=str(workdir / "m.pth"),
        sample_every_epoch=False, data_root=str(workdir.parent / "digits"),
        seed=5, ema_decay=ema_decay, device="cpu", resume=True,
        resume_every=1, log_fn=log_fn)


def _load(path):
    from tinydiffusionmodels_torch.io import load_checkpoint

    return load_checkpoint(str(path))


def _assert_same(a, b, where=""):
    """Two loaded checkpoints hold the same keys and values, exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _timeless(records):
    return [{k: v for k, v in r.items() if k != "it_per_s"} for r in records]


# name: (trainer, keyword arguments, files compared)
CASES = {
    "text_selfcond_dropout_ema": (
        "text", dict(self_cond=True, ema_decay=0.9),
        ("t.pth", "t_best.pth", "t_state.pth")),
    "text_frozen_constant_lr": (
        "text", dict(freeze_embeddings=True, use_lr_scheduling=False),
        ("t.pth", "t_best.pth", "t_state.pth")),
    "mnist_ema": ("mnist", dict(ema_decay=0.9), ("m.pth", "m_state.pth")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_resumed_run_is_the_uninterrupted_run(name, mnist_env, monkeypatch):
    """Stopped at ``Epoch 2/3`` and resumed: the checkpoints, the last
    resume file and the step losses and records of epochs 2-3 equal the
    uninterrupted run's, bit for bit."""
    kind, kw, files = CASES[name]
    monkeypatch.setenv("TDM_SCAN_CHUNK", "4")
    run = _text_train if kind == "text" else _mnist_train
    whole, cut = mnist_env / "whole", mnist_env / "cut"
    whole.mkdir()
    cut.mkdir()
    want = run(whole, lambda *_: None, **kw)
    with pytest.raises(Stop):
        run(cut, _stopping_log, **kw)
    assert _load(cut / files[-1])["epoch"] == 1
    logs = []
    got = run(cut, lambda *a: logs.append(" ".join(map(str, a))), **kw)
    assert any("[resume] restored epoch 1" in m for m in logs), logs
    assert _timeless(got.epochs) == _timeless(want.epochs[1:])
    per_epoch = len(want.step_losses) // EPOCHS
    np.testing.assert_array_equal(got.step_losses,
                                  want.step_losses[per_epoch:])
    for f in files:
        _assert_same(_load(whole / f), _load(cut / f), f)


# --- data parallel: 2 gloo processes ------------------------------------------

def _stop_at_epoch_2(monkeypatch_target):
    """Make ``text_train.train`` raise ``Stop`` as epoch 2 starts, on every
    rank alike (after epoch 1's resume file); returns the undo."""
    real = monkeypatch_target.dynamic_rounding_weight_schedule

    def stopping(epoch, *a, **k):
        if epoch == 1:
            raise Stop()
        return real(epoch, *a, **k)

    monkeypatch_target.dynamic_rounding_weight_schedule = stopping

    def undo():
        monkeypatch_target.dynamic_rounding_weight_schedule = real
    return undo


def _weights(result, prefix: str) -> dict:
    return {f"{prefix}/{k}": v.numpy()
            for k, v in result.joint.state_dict().items()}


def _dp_task() -> dict:
    """Each rank: the uninterrupted data-parallel run and one stopped
    as its epoch 2 starts (every rank stops there alike) and resumed; both
    runs' final weights."""
    import torch.distributed as dist

    from tinydiffusionmodels_torch.parallel import make_mesh
    from tinydiffusionmodels_torch.train import text_train

    here = Path.cwd()
    for tag in ("whole", "cut"):
        (here / tag).mkdir(exist_ok=True)
    dist.barrier()
    want = _text_train(here / "whole", lambda *_: None, mesh=make_mesh(),
                       ema_decay=0.9)
    undo = _stop_at_epoch_2(text_train)
    try:
        _text_train(here / "cut", lambda *_: None, mesh=make_mesh(),
                    ema_decay=0.9)
    except Stop:
        pass
    finally:
        undo()
    dist.barrier()
    logs = []
    got = _text_train(here / "cut", lambda *a: logs.append(str(a[0])),
                      mesh=make_mesh(), ema_decay=0.9)
    dist.barrier()
    out = {**_weights(want, "want"), **_weights(got, "got")}
    out["restored"] = np.array(any("restored epoch 1" in m for m in logs))
    out["generators"] = np.array("torch_generators" in _load(
        here / "cut" / "t_state.pth"))
    return out


def test_data_parallel_resume_is_the_uninterrupted_run(tmp_path):
    """World 2 (gloo), dropout 0.1, EMA: the resumed run's final weights
    equal the uninterrupted run's on both ranks, bit for bit; the resume
    file holds no generator state."""
    ranks = spawn(2, "test_torch_resume", "dp_resume", tmp_path / "dp")
    assert bool(ranks[0]["restored"])
    assert not bool(ranks[0]["generators"])
    for out in ranks:
        keys = [k[5:] for k in out if k.startswith("want/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(out[f"got/{k}"], out[f"want/{k}"],
                                          err_msg=k)
    for k in ranks[0]:
        if k.startswith(("want/", "got/")):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def _width_cut_task() -> dict:
    """A data-parallel run at this world's width, stopped as epoch 2
    starts (its epoch-1 resume file written) in ./run."""
    from tinydiffusionmodels_torch.parallel import make_mesh
    from tinydiffusionmodels_torch.train import text_train

    (Path.cwd() / "run").mkdir(exist_ok=True)
    undo = _stop_at_epoch_2(text_train)
    try:
        _text_train(Path.cwd() / "run", lambda *_: None, mesh=make_mesh())
    except Stop:
        pass
    finally:
        undo()
    return {"cut": np.array(1)}


def _width_resume_task() -> dict:
    """Resume ./run at this world's width; its final weights and whether
    it restored epoch 1."""
    from tinydiffusionmodels_torch.parallel import make_mesh

    logs = []
    got = _text_train(Path.cwd() / "run", lambda *a: logs.append(str(a[0])),
                      mesh=make_mesh())
    out = _weights(got, "got")
    out["restored"] = np.array(any("restored epoch 1" in m for m in logs))
    return out


def _width_whole_task() -> dict:
    """The uninterrupted run at this world's width."""
    from tinydiffusionmodels_torch.parallel import make_mesh

    (Path.cwd() / "whole").mkdir(exist_ok=True)
    return _weights(_text_train(Path.cwd() / "whole", lambda *_: None,
                                mesh=make_mesh()), "got")


def _assert_close_weights(got: dict, want: dict, steps: int) -> None:
    """The all-reduce's rounding, through AdamW (lr 1e-3): 1e-5, and 2 lr
    a step on the key bias's slice."""
    lr = 1e-3
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        if k.endswith("in_proj_bias"):
            key = slice(DIM, 2 * DIM)
            np.testing.assert_allclose(g[key], w[key], rtol=0,
                                       atol=2 * lr * steps, err_msg=k)
            g, w = np.delete(g, key), np.delete(w, key)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("saved_shards,world", [(2, 1), (1, 2)])
def test_resume_at_another_data_shard_count(saved_shards, world, tmp_path):
    """A run saved at one data-parallel width resumes at another: its final
    weights equal the uninterrupted run's at the new width."""
    from tinydiffusionmodels_torch.train import text_train

    run = tmp_path / "run"
    if saved_shards == 2:
        spawn(2, "test_torch_resume", "width_cut", tmp_path)
    else:
        run.mkdir()
        undo = _stop_at_epoch_2(text_train)
        try:
            with pytest.raises(Stop):
                _text_train(run, lambda *_: None)
        finally:
            undo()
    assert _load(run / "t_state.pth")["epoch"] == 1
    if world == 1:
        logs = []
        got = _weights(_text_train(run, lambda *a: logs.append(str(a[0]))),
                       "got")
        assert any("restored epoch 1" in m for m in logs)
        (tmp_path / "whole").mkdir()
        want = _weights(_text_train(tmp_path / "whole", lambda *_: None),
                        "got")
        ranks = [got]
    else:
        ranks = spawn(2, "test_torch_resume", "width_resume", tmp_path)
        # Rank 0 logs (the trainer silences the others).
        assert [bool(r.pop("restored")) for r in ranks] == [True, False]
        want = spawn(2, "test_torch_resume", "width_whole",
                     tmp_path / "w2")[0]
    for got in ranks:
        _assert_close_weights(got, want, steps=EPOCHS * (TRAIN // B))


def test_a_file_with_generator_states_loads(tmp_path):
    """An earlier port's file (``torch_generators``) restores, with one log
    line that the states are ignored."""
    import torch

    from tinydiffusionmodels_torch.train import state as train_state
    from tinydiffusionmodels_torch.train.optim import adamw

    _text_train(tmp_path, lambda *_: None, epochs=1)
    saved = _load(tmp_path / "t_state.pth")
    saved[train_state.GENERATORS] = {
        "gen": torch.Generator().manual_seed(1).get_state().numpy()}
    joint = _joint()
    logs = []
    epoch, step, _, _ = train_state.restore_text(
        saved, joint, adamw(joint.parameters(), 1e-3), None,
        log_fn=logs.append)
    assert (epoch, step) == (1, TRAIN // B)
    assert sum("ignoring" in m for m in logs) == 1


# --- the JAX package's files, both ways ----------------------------------------

def _jax_text_setup(dropout=0.1):
    import jax

    from tinydiffusionmodels_tpu.core import make_schedule
    from tinydiffusionmodels_tpu.models import (
        init_learned_embedding,
        init_learned_rounding,
        init_tiny_transformer,
    )
    from tinydiffusionmodels_tpu.models.transformer import TransformerConfig

    sched = make_schedule(50)
    cfg = TransformerConfig(dim=DIM, n_heads=2, depth=1, ffn_dim=32,
                            timesteps=50, self_cond=True, dropout=dropout)
    key = jax.random.PRNGKey(0)
    params = {
        "diffusion_model": init_tiny_transformer(key, cfg),
        "rounding_fn": init_learned_rounding(jax.random.fold_in(key, 1),
                                             DIM, VOCAB),
        "embedding_fn": init_learned_embedding(jax.random.fold_in(key, 2),
                                               VOCAB, DIM),
    }
    return params, cfg, sched


def _jax_text_train(workdir, log_fn, epochs=1):
    from tinydiffusionmodels_tpu.train import text_train as jax_text

    params, cfg, sched = _jax_text_setup()
    train_chunks, val_chunks = _chunks()
    jax_text.train(params, train_chunks, val_chunks, cfg=cfg, sched=sched,
                   ckpt_path=str(workdir / "t.pth"), epochs=epochs,
                   batch_size=B_JAX, lr=1e-3, warmup_steps=4, patience=100,
                   resume=True, ema_decay=0.9, log_fn=log_fn)


def _port_text_train(workdir, log_fn, epochs=1):
    return _text_train(workdir, log_fn, self_cond=True, ema_decay=0.9,
                       epochs=epochs, batch_size=B_JAX)


def _record_train_states(monkeypatch, module) -> list:
    """The JAX trainer's ``TrainState``s as it builds them (the restored
    one among them)."""
    from tinydiffusionmodels_tpu.train.state import TrainState

    made = []

    def recording(*a, **k):
        made.append(TrainState(*a, **k))
        return made[-1]

    recording.create = TrainState.create
    monkeypatch.setattr(module, "TrainState", recording)
    return made


def _jax_moments(saved, tree_to_sd):
    """optax's (count, mu, nu) of a resume file, unflattened by the JAX
    package's treedef and laid out as torch state dicts by its own
    converters."""
    leaves = saved["opt_state_leaves"]
    n = (len(leaves) - 1) // 2
    return int(leaves[0].reshape(-1)[0]), tree_to_sd(leaves[1:1 + n]), \
        tree_to_sd(leaves[1 + n:1 + 2 * n])


def _check_moments(optimizer, module, count, mu, nu, skip=()):
    state_of = {name: optimizer.state[p]
                for name, p in module.named_parameters()
                if p in optimizer.state}
    assert set(state_of) == set(mu) - set(skip)
    for name, st in state_of.items():
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name], name)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[name],
                                      name)
        assert float(st["step"]) == count


def test_port_resumes_a_jax_text_file(tmp_path, monkeypatch):
    """The JAX trainer's epoch-1 file (self-conditioning, EMA, cosine
    schedule) in the port: the weights are JAX's, AdamW's moments and step
    optax's, exactly; the log says ``restored epoch 1``."""
    import jax

    from tinydiffusionmodels_tpu.io.checkpoint import (
        embedding_to_state_dict,
        rounding_to_state_dict,
        transformer_to_state_dict,
    )
    from tinydiffusionmodels_torch.train import state as train_state
    from tinydiffusionmodels_torch.train.optim import adamw

    monkeypatch.chdir(tmp_path)
    _jax_text_train(tmp_path, lambda *_: None)
    saved = _load(tmp_path / "t_state.pth")
    logs = []
    _port_text_train(tmp_path, lambda *a: logs.append(str(a[0])), epochs=1)
    assert any("[resume] restored epoch 1" in m for m in logs)
    _assert_same(_load(tmp_path / "t.pth")["diffusion_model"],
                 saved["ema"]["diffusion_model"])

    params, _, _ = _jax_text_setup()
    treedef = jax.tree_util.tree_structure(params)

    def tree_to_sd(leaves):
        tree = jax.tree_util.tree_unflatten(treedef, leaves)
        sd = {}
        for key, conv in (("diffusion_model", transformer_to_state_dict),
                          ("rounding_fn", rounding_to_state_dict),
                          ("embedding_fn", embedding_to_state_dict)):
            sd.update({f"{key}.{k}": np.asarray(v)
                       for k, v in conv(tree[key]).items()})
        return sd

    joint = _joint(self_cond=True)
    optimizer = adamw(joint.parameters(), 1e-3)
    epoch, step, _, _ = train_state.restore_text(
        saved, joint, optimizer, None, log_fn=lambda *_: None)
    assert (epoch, step) == (1, TRAIN // B_JAX)
    for k, v in joint.state_dict().items():
        key, sub = k.split(".", 1)
        np.testing.assert_array_equal(v.numpy(), saved[key][sub], k)
    count, mu, nu = _jax_moments(saved, tree_to_sd)
    assert count == step and saved["opt_state_leaves"][-1].item() == step
    _check_moments(optimizer, joint, count, mu, nu)


def test_port_carries_on_a_jax_runs_draws(tmp_path, monkeypatch):
    """A JAX text run (self-conditioning, dropout 0, cosine schedule)
    stopped after epoch 1 of 2 and finished by the port ends where the
    uninterrupted JAX run ends: the port's epoch 2 draws the JAX run's
    timesteps, noise and coins from the file's step."""
    from tinydiffusionmodels_tpu.train import text_train as jax_text

    monkeypatch.chdir(tmp_path)
    train_chunks, val_chunks = _chunks()

    def jax_run(workdir, log_fn):
        params, cfg, sched = _jax_text_setup(dropout=0.0)
        jax_text.train(params, train_chunks, val_chunks, cfg=cfg,
                       sched=sched, ckpt_path=str(workdir / "t.pth"),
                       epochs=2, batch_size=B_JAX, lr=1e-3, warmup_steps=4,
                       patience=100, seed=3, resume=True, log_fn=log_fn)

    def stop(msg, *_):
        if str(msg).startswith("Epoch 2/2"):
            raise Stop()

    whole, cut = tmp_path / "whole", tmp_path / "cut"
    whole.mkdir()
    cut.mkdir()
    jax_run(whole, lambda *_: None)
    with pytest.raises(Stop):
        jax_run(cut, stop)
    assert _load(cut / "t_state.pth")["epoch"] == 1
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.train import text_train

    logs = []
    text_train.train(
        _joint(self_cond=True, dropout=0.0), train_chunks, val_chunks,
        sched=make_schedule(50), ckpt_path=str(cut / "t.pth"), epochs=2,
        batch_size=B_JAX, lr=1e-3, warmup_steps=4, patience=100, seed=3,
        resume=True, log_fn=lambda *a: logs.append(str(a[0])))
    assert any("[resume] restored epoch 1" in m for m in logs)
    got, want = _load(cut / "t.pth"), _load(whole / "t.pth")
    for part in ("diffusion_model", "rounding_fn", "embedding_fn"):
        _assert_close_weights(
            {k: np.asarray(v) for k, v in got[part].items()},
            {k: np.asarray(v) for k, v in want[part].items()},
            steps=TRAIN // B_JAX)


def test_jax_resumes_a_port_text_file(tmp_path, monkeypatch):
    """The port's epoch-1 file in the JAX trainer: its restored optimizer
    leaves are the port's, its weights the port's; ``restored epoch 1``."""
    import jax

    from tinydiffusionmodels_tpu.train import text_train as jax_text

    monkeypatch.chdir(tmp_path)
    _port_text_train(tmp_path, lambda *_: None)
    saved = _load(tmp_path / "t_state.pth")
    made = _record_train_states(monkeypatch, jax_text)
    logs = []
    _jax_text_train(tmp_path, lambda *a: logs.append(str(a[0])))
    assert any("[resume] restored epoch 1" in m for m in logs)
    restored = made[-1]
    leaves = jax.tree_util.tree_leaves(restored.opt_state)
    assert len(leaves) == len(saved["opt_state_leaves"])
    for a, b in zip(leaves, saved["opt_state_leaves"]):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(restored.step) == TRAIN // B_JAX
    _assert_same(_load(tmp_path / "t.pth")["diffusion_model"],
                 saved["ema"]["diffusion_model"])


def _jax_mnist_train(workdir, log_fn, epochs=1):
    from tinydiffusionmodels_tpu.train import mnist_train as jax_mnist

    jax_mnist.train(epochs=epochs, batch_size=8,
                    ckpt_path=str(workdir / "m.pth"), sample_every_epoch=False,
                    data_root=str(workdir.parent / "digits"), resume=True,
                    log_fn=log_fn)


def test_mnist_files_resume_in_both_packages(mnist_env, monkeypatch):
    """JAX -> port: the weights and AdamW equal the JAX file's (moments
    through the JAX package's ``unet_to_state_dict``); port -> JAX: the
    JAX trainer's restored leaves equal the port's file's. Both log
    ``restored epoch 1``."""
    import jax

    from tinydiffusionmodels_tpu.io.checkpoint import unet_to_state_dict
    from tinydiffusionmodels_tpu.models import init_unet
    from tinydiffusionmodels_tpu.train import mnist_train as jax_mnist
    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.train import state as train_state
    from tinydiffusionmodels_torch.train.optim import adamw

    jax_dir, port_dir = mnist_env / "jax", mnist_env / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    # JAX -> port
    _jax_mnist_train(jax_dir, lambda *_: None)
    saved = _load(jax_dir / "m_state.pth")
    logs = []
    _mnist_train(jax_dir, lambda *a: logs.append(str(a[0])), epochs=1)
    assert any("[resume] restored epoch 1" in m for m in logs)
    _assert_same(_load(jax_dir / "m.pth"), saved["model"])
    treedef = jax.tree_util.tree_structure(init_unet(jax.random.PRNGKey(0)))

    def tree_to_sd(leaves):
        return {k: np.asarray(v) for k, v in unet_to_state_dict(
            jax.tree_util.tree_unflatten(treedef, leaves)).items()}

    model = SimpleUNet()
    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    epoch, step = train_state.restore_mnist(
        saved, model, optimizer, None, log_fn=lambda *_: None)
    assert (epoch, step) == (1, 5)
    count, mu, nu = _jax_moments(saved, tree_to_sd)
    assert count == step and len(saved["opt_state_leaves"]) == 1 + 2 * len(mu)
    _check_moments(optimizer, model, count, mu, nu)

    # port -> JAX
    _mnist_train(port_dir, lambda *_: None, epochs=1)
    saved = _load(port_dir / "m_state.pth")
    made = _record_train_states(monkeypatch, jax_mnist)
    logs = []
    _jax_mnist_train(port_dir, lambda *a: logs.append(str(a[0])))
    assert any("[resume] restored epoch 1" in m for m in logs)
    leaves = jax.tree_util.tree_leaves(made[-1].opt_state)
    assert len(leaves) == len(saved["opt_state_leaves"])
    for a, b in zip(leaves, saved["opt_state_leaves"]):
        np.testing.assert_array_equal(np.asarray(a), b)
    _assert_same(_load(port_dir / "m.pth"), saved["model"])


def test_frozen_table_moments_are_zeros_both_ways(tmp_path, monkeypatch):
    """``--freeze_embeddings``: the port's optimizer holds no state for the
    table, its file holds zero moments there (JAX's zero-gradient ones),
    and reading the file back skips them."""
    from tinydiffusionmodels_torch.io import (
        adamw_state_from_jax,
        adamw_state_to_jax,
    )
    from tinydiffusionmodels_torch.train.optim import adamw, freeze_subtree

    monkeypatch.setenv("TDM_SCAN_CHUNK", "4")
    monkeypatch.chdir(tmp_path)
    _text_train(tmp_path, lambda *_: None, freeze_embeddings=True,
                use_lr_scheduling=False, epochs=1)
    saved = _load(tmp_path / "t_state.pth")
    joint = _joint()
    step, mu, nu = adamw_state_from_jax(saved["opt_state_leaves"], joint)
    assert step == TRAIN // B
    assert len(saved["opt_state_leaves"]) == 1 + 2 * len(mu)  # constant lr
    np.testing.assert_array_equal(mu["embedding_fn.embeddings.weight"], 0)
    np.testing.assert_array_equal(nu["embedding_fn.embeddings.weight"], 0)
    assert np.abs(mu["rounding_fn.decoder.weight"].numpy()).sum() > 0
    optimizer = adamw(freeze_subtree(joint, "embedding_fn"), 1e-3)
    leaves = adamw_state_to_jax(optimizer, joint, schedule=False)
    assert len(leaves) == len(saved["opt_state_leaves"])
    assert all(np.all(x == 0) for x in leaves)


@pytest.mark.parametrize("trainer", ["text", "mnist"])
def test_corrupt_resume_file_starts_fresh(trainer, mnist_env, monkeypatch):
    """A truncated file: the log says so, the run trains from scratch to
    the uninterrupted run's checkpoint and writes a valid resume file."""
    fresh, broken = mnist_env / "fresh", mnist_env / "broken"
    fresh.mkdir()
    broken.mkdir()
    run, name = ((_text_train, "t") if trainer == "text"
                 else (_mnist_train, "m"))
    run(fresh, lambda *_: None, epochs=1)
    (broken / f"{name}_state.pth").write_bytes(b"not a zip, not a pickle")
    logs = []
    run(broken, lambda *a: logs.append(str(a[0])), epochs=1)
    assert any(f"[resume] could not read {broken / name}_state.pth" in m
               and "starting fresh" in m for m in logs), logs
    _assert_same(_load(fresh / f"{name}.pth"), _load(broken / f"{name}.pth"))
    assert _load(broken / f"{name}_state.pth")["epoch"] == 1


# --- the CLI under SIGKILL --------------------------------------------------------

def test_sigkill_mid_training_then_resume(tmp_path):
    """Kill ``python -m tinydiffusionmodels_torch.shakespeare --train
    --resume`` as soon as its first resume file lands, restart it: it
    restores an epoch, finishes, and its final and best checkpoints equal
    an uninterrupted run's, bit for bit."""
    env = dict(os.environ, TDM_PLATFORM="cpu", TDM_DATA_LIMIT="20000",
               TDM_SCAN_CHUNK="5", TDM_PROGRESS_EVERY="0",
               OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("AIP_MODEL_DIR", None)

    def args(ckpt):
        return [sys.executable, "-m", "tinydiffusionmodels_torch.shakespeare",
                "--train", "--epochs", "6", "--batch_size", "16",
                "--seq_len", "32", "--model_id", "char",
                "--use_learned_embeddings", "--embed_dim", "32",
                "--depth", "1", "--patience", "100", "--ckpt", str(ckpt),
                "--resume", "--resume_every", "1"]

    # The uninterrupted run, beside the victim and its restart.
    whole = subprocess.Popen(args(tmp_path / "whole.pth"), cwd=tmp_path,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    ckpt, state = tmp_path / "m.pth", tmp_path / "m_state.pth"
    victim_log = tmp_path / "victim.log"
    try:
        with open(victim_log, "w") as log:
            victim = subprocess.Popen(args(ckpt), cwd=tmp_path, env=env,
                                      stdout=log, stderr=subprocess.STDOUT)
            deadline = time.time() + 300
            while time.time() < deadline and not state.exists():
                if victim.poll() is not None:
                    pytest.fail("training exited before checkpointing:\n"
                                + victim_log.read_text())
                time.sleep(0.02)
            victim.send_signal(signal.SIGKILL)
            victim.wait(timeout=30)
        assert victim.returncode == -signal.SIGKILL
        out = subprocess.run(args(ckpt), cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=300)
        whole_out = whole.communicate(timeout=300)[0]
    finally:
        whole.kill()
    assert whole.returncode == 0, whole_out
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[resume] restored epoch" in out.stdout
    assert "Saving final checkpoint" in out.stdout
    for a, b in (("whole.pth", "m.pth"), ("whole_best.pth", "m_best.pth")):
        _assert_same(_load(tmp_path / a), _load(tmp_path / b), b)


if __name__ == "__main__":
    worker_main({"dp_resume": _dp_task, "width_cut": _width_cut_task,
                 "width_resume": _width_resume_task,
                 "width_whole": _width_whole_task})
