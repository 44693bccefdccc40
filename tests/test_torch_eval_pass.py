"""The validation pass as one graph (``text_train.EvalPass``), the
counterpart of the JAX package's ``make_text_eval_multi``, on the CPU.

- Its eager path (what the card's graph replays) against the plain loop
  it replaced, ``eval_losses`` with the epoch's validation key
  (``val_key(seed, epoch)``), bit for bit: several epochs (one key
  buffer, rewritten), self-conditioning, a non-trainable EMA copy, bf16
  compute, and a run of ``text_train.train`` whose epoch records hold it.
- Against ``make_text_eval_multi`` at dropout 0 on the same parameters and
  the same key (the JAX trainer's ``fold_in(substream(key, "val"),
  epoch)``), so the same (t, noise), within 1e-5: the sums over the K
  batches.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.core import make_schedule as jax_schedule  # noqa: E402
from tinydiffusionmodels_tpu.core.rng import substream  # noqa: E402
from tinydiffusionmodels_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JaxConfig,
)
from tinydiffusionmodels_tpu.train import text_train as jax_train  # noqa: E402
from tinydiffusionmodels_torch.core import make_schedule  # noqa: E402
from tinydiffusionmodels_torch.core import rng as port_rng  # noqa: E402
from tinydiffusionmodels_torch.data.loader import batch_iterator  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedEmbedding,
    LearnedRounding,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.train import text_train  # noqa: E402

torch.set_num_threads(1)

DIM, DEPTH, FFN, VOCAB, K, B, L, T = 32, 2, 64, 23, 4, 3, 12, 100
TOL = dict(rtol=1e-5, atol=1e-5)


def _joint(dropout=0.1, self_cond=False, seed=0):
    cfg = TransformerConfig(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=FFN,
                            dropout=dropout, self_cond=self_cond, timesteps=T)
    g = torch.Generator().manual_seed(seed)
    root = port_rng.prng_key(seed)
    model = TinyTransformer(cfg, key=port_rng.substream(root, "diffusion"))
    if self_cond:   # its init is zero (a no-op); give it weights
        with torch.no_grad():
            model.selfcond_proj.weight.normal_(0.0, 0.1, generator=g)
    return torch.nn.ModuleDict({
        "diffusion_model": model,
        "rounding_fn": LearnedRounding(
            DIM, VOCAB, key=port_rng.substream(root, "rounding")),
        "embedding_fn": LearnedEmbedding(
            VOCAB, DIM, key=port_rng.substream(root, "embedding")),
    })


def _batches(seed=1):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, VOCAB, (K, B, L)))


KW = dict(use_learned_embeddings=True, pretrained_matrix=None)


@pytest.mark.parametrize("case", ["plain", "self_cond", "ema", "bf16"])
def test_eval_pass_equals_the_plain_loop(case):
    joint = _joint(self_cond=case == "self_cond")
    if case == "ema":
        joint = copy.deepcopy(joint).requires_grad_(False)
    kw = dict(KW, compute_dtype=torch.bfloat16 if case == "bf16" else None)
    sched = make_schedule(T)
    val = _batches()
    eval_pass = text_train.EvalPass(joint, val, seed=5, sched=sched, **kw)
    assert eval_pass.step.eager   # the CPU runs the step's eager path
    seen = []
    for epoch, w in ((0, 1.0), (1, 0.8333333), (2, 0.25), (0, 1.0)):
        got = eval_pass(epoch, w)
        want = text_train.eval_losses(
            joint, val, w, text_train.val_key(5, epoch),
            sched=sched, **kw)
        np.testing.assert_array_equal(got, want)
        seen.append(got)
    # Each epoch its own stream, and epoch 0 again the same.
    assert not np.array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(seen[0], seen[3])


def test_train_records_hold_the_eval_pass(tmp_path):
    """Two epochs of ``train`` with EMA: each record's validation losses
    are the plain loop's on the weights validated that epoch."""
    joint = _joint()
    sched = make_schedule(T)
    rng = np.random.default_rng(2)
    train_chunks = rng.integers(0, VOCAB, (12, L))
    val_chunks = rng.integers(0, VOCAB, (7, L))
    calls = []
    real = text_train.EvalPass.__call__

    def spy(self, epoch, w):
        calls.append((epoch, w))
        return real(self, epoch, w)

    text_train.EvalPass.__call__ = spy
    try:
        result = text_train.train(
            joint, train_chunks, val_chunks, sched=sched, epochs=2,
            batch_size=4, ema_decay=0.9, ckpt_path=str(tmp_path / "c.pth"),
            seed=3, log_fn=lambda *_: None, **KW)
    finally:
        text_train.EvalPass.__call__ = real
    assert [epoch for epoch, _ in calls] == [0, 1]
    # The last epoch validated the final (EMA) weights.
    val = torch.as_tensor(np.stack(list(batch_iterator(
        val_chunks, 4, shuffle=False))))
    w = calls[-1][1]
    want = text_train.eval_losses(
        result.joint, val, w, text_train.val_key(3, 1),
        sched=sched, **KW)
    rec = result.epochs[-1]
    np.testing.assert_array_equal(
        np.array([rec["val_diff"], rec["val_round"], rec["val_total"]],
                 dtype=np.float32), want)


def test_eval_pass_matches_make_text_eval_multi_at_dropout_0():
    """The port's pass and the JAX pass from one seed and epoch: the K
    batches' summed (diff, round, total) within 1e-5."""
    joint = _joint(dropout=0.0)
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_tree(joint))
    jcfg = JaxConfig(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=FFN,
                     dropout=0.0, timesteps=T)
    jsched = jax_schedule(T)
    val = _batches(3)
    epoch = 2
    key = jax.random.fold_in(substream(jax.random.PRNGKey(9), "val"), epoch)
    w = 0.7
    eval_multi = jax_train.make_text_eval_multi(
        jsched, jcfg, use_learned_embeddings=True)
    want = np.asarray(eval_multi(params, jnp.asarray(val.numpy()),
                                 jnp.asarray(w), key))
    got = text_train.EvalPass(joint, val, seed=9, sched=make_schedule(T),
                              **KW)(epoch, w)
    np.testing.assert_allclose(got * K, want, **TOL)
