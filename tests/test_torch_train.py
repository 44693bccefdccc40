"""Text-diffusion training of the torch package against the JAX package.

Same weights (the JAX package's init, carried over by ``io.convert``), the
same token ids, and the same timesteps and noise, made with numpy and fed
to both packages' ``_losses``, which take them as arguments. The port's
attention runs its plain PyTorch version here.

At dropout 0 the two are held together exactly up to float32 summation
order:
- training-mode forward of the TinyTransformer and its parameter gradients
  (``jax.grad`` vs ``torch.autograd``): atol 1e-4;
- ``_losses`` (total, diffusion, rounding) for every option: atol 1e-5, and
  their gradients: atol 1e-4;
- three AdamW steps under the cosine-warmup schedule against optax
  ``adamw``: updated parameters atol 1e-5.

Both packages draw from the same key tree (``core/rng.py``), so the
training steps are also held together whole, from a seed and a step:
- the step's timesteps, noise (``TDM_FAST_NOISE`` 0 and 1) and
  self-conditioning coin: bit-equal (noise within 3 ulp, the bound of
  ``tests/test_torch_rng.py``);
- three chunked training steps (``TextSteps``; eps, x0, self-conditioning,
  EMA) against ``make_text_train_step_multi[_ema]`` at dropout 0, with SGD
  at lr 0.5 on both sides (AdamW's parity is the test above; its first
  steps turn a gradient that is rounding noise into +-lr, which would hide
  the draws under noise): the summed losses rtol 1e-5, updated parameters
  (and the EMA) atol 1e-5;
- the training-mode denoiser at dropout 0.1, with the JAX package's
  attention sent to its flash kernels (interpret mode; at these shapes it
  would take the XLA path, whose mask is another stream): output and
  gradients atol 1e-4, as at dropout 0.

The distributional tests at dropout 0.1 stay, each naming the stream it
holds against.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from tinydiffusionmodels_tpu.core import make_schedule as jax_schedule  # noqa: E402
from tinydiffusionmodels_tpu.models import (  # noqa: E402
    init_learned_embedding,
    init_learned_rounding,
    init_tiny_transformer,
    tiny_transformer_apply,
)
from tinydiffusionmodels_tpu.models.torch_init import (  # noqa: E402
    dropout as jax_dropout,
)
from tinydiffusionmodels_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JaxConfig,
)
from tinydiffusionmodels_tpu.ops import xla_ref  # noqa: E402
from tinydiffusionmodels_tpu.train import optim as jax_optim  # noqa: E402
from tinydiffusionmodels_tpu.train import text_train as jax_train  # noqa: E402
from tinydiffusionmodels_torch.core import make_schedule, rng  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedEmbedding,
    LearnedRounding,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.models.transformer import dropout  # noqa: E402
from tinydiffusionmodels_torch.ops import reference  # noqa: E402
from tinydiffusionmodels_torch.train import optim, text_train  # noqa: E402

torch.set_num_threads(1)

DIM, DEPTH, FFN, VOCAB, B, L = 32, 2, 64, 23, 3, 12


def _configs(dropout=0.0, self_cond=False, pos_emb="none"):
    kw = dict(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=FFN, dropout=dropout,
              self_cond=self_cond, pos_emb=pos_emb, max_len=64)
    return JaxConfig(**kw), TransformerConfig(**kw)


def _jax_joint(jcfg, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    diff = init_tiny_transformer(keys[0], jcfg)
    if jcfg.self_cond:  # the init is zero (a no-op); give it real weights
        diff["selfcond_proj"]["w"] = 0.1 * jax.random.normal(keys[3],
                                                             (DIM, DIM))
    return {
        "diffusion_model": diff,
        "rounding_fn": init_learned_rounding(keys[1], DIM, VOCAB),
        "embedding_fn": init_learned_embedding(keys[2], VOCAB, DIM),
    }


def _port_joint(tcfg, params) -> torch.nn.ModuleDict:
    model = TinyTransformer(tcfg)
    model.load_state_dict(
        convert.transformer_state_from_jax(params["diffusion_model"]))
    rounding = LearnedRounding(DIM, VOCAB)
    rounding.load_state_dict(
        convert.rounding_state_from_jax(params["rounding_fn"]))
    embedding = LearnedEmbedding(VOCAB, DIM)
    embedding.load_state_dict(
        convert.embedding_state_from_jax(params["embedding_fn"]))
    return torch.nn.ModuleDict({"diffusion_model": model,
                                "rounding_fn": rounding,
                                "embedding_fn": embedding})


def _jax_state(params) -> dict:
    """The JAX joint tree (or its gradient tree) in the port's names."""
    return {
        **{f"diffusion_model.{k}": v.numpy() for k, v in
           convert.transformer_state_from_jax(params["diffusion_model"]).items()},
        **{f"rounding_fn.{k}": v.numpy() for k, v in
           convert.rounding_state_from_jax(params["rounding_fn"]).items()},
        **{f"embedding_fn.{k}": v.numpy() for k, v in
           convert.embedding_state_from_jax(params["embedding_fn"]).items()},
    }


def _batch(seed=0, t_max=1000):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (B, L))
    t = rng.integers(0, t_max, (B,))
    noise = rng.standard_normal((B, L, DIM), dtype=np.float32)
    return tokens, t, noise


def test_training_forward_and_grads_match_jax_at_dropout_0():
    jcfg, tcfg = _configs(pos_emb="abs")
    params = _jax_joint(jcfg)["diffusion_model"]
    rs = np.random.default_rng(1)
    x = rs.standard_normal((B, L, DIM), dtype=np.float32)
    t = np.array([0, 417, 999], dtype=np.int32)
    g = rs.standard_normal((B, L, DIM), dtype=np.float32)

    def loss(p):
        out = tiny_transformer_apply(p, jnp.asarray(x), jnp.asarray(t), jcfg,
                                     deterministic=False,
                                     key=jax.random.PRNGKey(3))
        return jnp.sum(out * g), out

    grads, out_j = jax.grad(loss, has_aux=True)(params)
    model = TinyTransformer(tcfg)
    model.load_state_dict(convert.transformer_state_from_jax(params))
    out_t = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                  deterministic=False, key=rng.prng_key(3))
    (out_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-4)
    want = convert.transformer_state_from_jax(grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


# name: (_losses keyword arguments, self-conditioned model, deterministic)
VARIANTS = {
    "eps": (dict(), False, False),
    "x0": (dict(parameterization="x0"), False, False),
    "self_cond_eps": (dict(), True, True),
    "self_cond_x0_clamp": (dict(parameterization="x0", clamp_train=True),
                           True, True),
    "clamp_train": (dict(parameterization="x0", clamp_train=True), False,
                    False),
    "anchor_ce_x0": (dict(parameterization="x0", anchor_ce=0.5), False,
                     False),
    "anchor_ce_eps": (dict(anchor_ce=0.3), False, False),
    "embed_norm_rms": (dict(embed_norm="rms"), False, False),
    "embed_norm_zscore": (dict(embed_norm="zscore"), False, False),
    "freeze_embeddings": (dict(freeze_embeddings=True, embed_norm="zscore"),
                          False, False),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_losses_match_jax(name):
    """Self-conditioning is held on its deterministic (validation) branch,
    which always feeds the estimate: the JAX package draws the training
    coin from its key."""
    kwargs, self_cond, deterministic = VARIANTS[name]
    jcfg, tcfg = _configs(self_cond=self_cond)
    params = _jax_joint(jcfg)
    tokens, t, noise = _batch()
    weight = 0.7

    def loss(p):
        total, (diff, round_) = jax_train._losses(
            p, jnp.asarray(tokens), jnp.asarray(t), jnp.asarray(noise),
            jnp.float32(weight), cfg=jcfg, sched=jax_schedule(),
            use_learned_embeddings=True, pretrained_matrix=None,
            deterministic=deterministic,
            key=None if deterministic else jax.random.PRNGKey(5), **kwargs)
        return total, (total, diff, round_)

    grads, ref = jax.grad(loss, has_aux=True)(params)
    joint = _port_joint(tcfg, params)
    total, (diff, round_) = text_train._losses(
        joint, torch.from_numpy(tokens), torch.from_numpy(t),
        torch.from_numpy(noise), weight, sched=make_schedule(),
        use_learned_embeddings=True, pretrained_matrix=None,
        deterministic=deterministic,
        key=None if deterministic else rng.prng_key(5), **kwargs)
    for got, want in zip((total, diff, round_), ref):
        np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-5)

    total.backward()
    want = _jax_state(grads)
    for pname, p in joint.named_parameters():
        got = np.zeros_like(want[pname]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[pname], rtol=0, atol=1e-4,
                                   err_msg=pname)


@pytest.mark.parametrize("freeze", [False, True])
def test_three_adamw_steps_match_optax(freeze):
    """Three optimizer steps of the joint model under the cosine-warmup
    schedule (warmup 2 of 10 steps: lr 0, lr/2, lr), with the same batches,
    timesteps and noise on both sides."""
    jcfg, tcfg = _configs()
    params = _jax_joint(jcfg)
    lr, wd, warmup, total_steps = 3e-2, 0.1, 2, 10
    tx = jax_optim.adamw(
        jax_optim.cosine_schedule_with_warmup(lr, warmup, total_steps),
        weight_decay=wd)
    if freeze:
        tx = jax_optim.freeze_subtree(tx, "embedding_fn")
    joint = _port_joint(tcfg, params)
    trainable = (optim.freeze_subtree(joint, "embedding_fn") if freeze
                 else list(joint.parameters()))
    opt = optim.adamw(trainable, lr, weight_decay=wd)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, optim.cosine_warmup_lambda(warmup, total_steps))
    kw = dict(use_learned_embeddings=True, pretrained_matrix=None,
              deterministic=True, freeze_embeddings=freeze)

    opt_state = tx.init(params)
    for step in range(3):
        tokens, t, noise = _batch(seed=10 + step)

        def loss(p):
            return jax_train._losses(
                p, jnp.asarray(tokens), jnp.asarray(t), jnp.asarray(noise),
                jnp.float32(1.0), cfg=jcfg, sched=jax_schedule(), key=None,
                **kw)[0]

        grads = jax.grad(loss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        total, _ = text_train._losses(
            joint, torch.from_numpy(tokens), torch.from_numpy(t),
            torch.from_numpy(noise), 1.0, sched=make_schedule(), **kw)
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        sched.step()

    want = _jax_state(params)
    for name, p in joint.named_parameters():
        got = p.detach().numpy()
        if name.endswith("in_proj_bias"):
            # The key bias adds q.b_k to every score of a row, which the
            # softmax ignores: its gradient is 0 in exact arithmetic, and
            # both sides see only rounding noise, which Adam normalises to
            # steps of up to lr. Its slice is held to that bound only.
            key = slice(DIM, 2 * DIM)
            np.testing.assert_allclose(got[key], want[name][key], rtol=0,
                                       atol=2 * lr, err_msg=name)
            got, want[name] = np.delete(got, key), np.delete(want[name], key)
        np.testing.assert_allclose(got, want[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    if freeze:
        np.testing.assert_array_equal(
            joint["embedding_fn"].embeddings.weight.detach().numpy(),
            _jax_state(_jax_joint(jcfg))["embedding_fn.embeddings.weight"])


def test_schedules_match_jax():
    base_lr = 2e-4
    jax_lr = jax_optim.cosine_schedule_with_warmup(base_lr, 100, 1000)
    port_lr = optim.cosine_warmup_lambda(100, 1000)
    for step in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 1200):
        # The JAX schedule runs in float32.
        np.testing.assert_allclose(base_lr * port_lr(step),
                                   float(jax_lr(step)), rtol=1e-6, atol=1e-9)
    for epoch, epochs in ((0, 1), (0, 5), (3, 5), (4, 5)):
        assert (optim.dynamic_rounding_weight_schedule(epoch, epochs, 0.8)
                == jax_optim.dynamic_rounding_weight_schedule(epoch, epochs,
                                                              0.8))


def test_train_step_runs_forward_backward_adamw():
    """One ``train_step`` in training mode at dropout 0.1 moves every
    trainable parameter and returns finite (diff, round, total) on the
    device, with no host read."""
    _, tcfg = _configs(dropout=0.1)
    joint = _port_joint(tcfg, _jax_joint(_configs()[0]))
    before = {n: p.detach().clone() for n, p in joint.named_parameters()}
    opt = optim.adamw(joint.parameters(), 1e-3)
    losses = text_train.train_step(
        joint, opt, torch.from_numpy(_batch()[0]), 1.0,
        rng.prng_key(0), sched=make_schedule(),
        use_learned_embeddings=True, pretrained_matrix=None)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    for name, p in joint.named_parameters():
        assert not torch.equal(p.detach(), before[name]), name


# --- dropout 0.1: distributional --------------------------------------------

RATE = 0.1


def test_feature_dropout_rate_matches_jax_distribution():
    """Feature dropout (input, dropout1, dropout_ffn, dropout2): the port's
    stream (here key 1) and the JAX package's ``torch_init.dropout``
    (``draw_keep``, key 0) each drop RATE of the units, within 2 %, and
    both scale the kept ones by 1 / (1 - RATE)."""
    x = torch.ones(200_000)
    port = dropout(x, RATE, rng.prng_key(1))
    ref = np.asarray(jax_dropout(jax.random.PRNGKey(0), jnp.ones(200_000),
                                 RATE, deterministic=False))
    for out in (port.numpy(), ref):
        assert abs(float((out == 0).mean()) - RATE) < 0.02
        np.testing.assert_allclose(out[out != 0], 1.0 / (1.0 - RATE),
                                   rtol=1e-6)
    assert torch.equal(dropout(x, RATE, None), x)


def test_attention_dropout_is_unbiased_in_both_streams():
    """Attention-weight dropout: the port's coordinate-hash stream (the
    flash kernels' mask, here through the plain version) and the JAX XLA
    path's ``draw_keep`` stream each keep 1 - RATE of the weights within
    2 %, and each output averaged over many seeds approaches the dropout-0
    output."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 2, 16, 32), dtype=np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out0 = reference.attention(tq, tk, tv)[0].numpy()
    n = 400
    port = np.mean([reference.attention(
        tq, tk, tv, dropout_rate=RATE,
        dropout_seed=torch.tensor([s], dtype=torch.int32))[0].numpy()
        for s in range(n)], axis=0)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ref = np.mean(np.asarray(jax.vmap(lambda kk: xla_ref.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_rate=RATE,
        dropout_key=kk))(keys)), axis=0)
    # One draw's error is ~0.3 here; the mean of n is ~0.3 / sqrt(n).
    for mean in (port, ref):
        assert np.abs(mean - out0).max() < 0.1
    kept = reference.dropout_scale(
        torch.arange(n, dtype=torch.int32)[:, None, None], 0,
        torch.arange(64)[None, :, None], torch.arange(64)[None, None, :],
        RATE) > 0
    assert abs(float(kept.float().mean()) - (1 - RATE)) < 0.02


def test_training_mode_averages_toward_eval_mode():
    """The whole denoiser at dropout 0.1 (port's streams): outputs are
    finite and differ per seed, and their mean over seeds lies nearer the
    eval-mode output than a single draw."""
    _, tcfg = _configs(dropout=RATE)
    model = _port_joint(tcfg, _jax_joint(_configs()[0]))["diffusion_model"]
    x = torch.from_numpy(_batch()[2])
    t = torch.tensor([5, 300, 900])
    with torch.no_grad():
        evald = model(x, t)
        draws = torch.stack([
            model(x, t, deterministic=False, key=rng.prng_key(s))
            for s in range(48)])
    assert bool(torch.isfinite(draws).all())
    assert not torch.equal(draws[0], draws[1])
    single = float((draws[0] - evald).abs().mean())
    mean = float((draws.mean(0) - evald).abs().mean())
    assert mean < 0.5 * single


@pytest.mark.parametrize("decay", [0.0, 1.0])
def test_train_ema_tracks_the_live_weights(tmp_path, decay):
    """``train(ema_decay=d)`` keeps ema = d * ema + (1 - d) * live after every
    step, outside autograd: at d = 0 the returned model is the live one,
    at d = 1 it is the initial one, and its parameters are plain leaves."""
    _, tcfg = _configs(dropout=0.1)
    joint = _port_joint(tcfg, _jax_joint(_configs()[0]))
    initial = {n: p.detach().clone() for n, p in joint.named_parameters()}
    chunks = np.random.default_rng(0).integers(0, VOCAB, (40, L))
    result = text_train.train(
        joint, chunks[:32], chunks[32:], sched=make_schedule(),
        ckpt_path=str(tmp_path / "t.pth"), batch_size=8, lr=1e-2,
        warmup_steps=1, ema_decay=decay, log_fn=lambda *a: None)
    assert result.steps == 4 and (tmp_path / "t_best.pth").exists()
    want = initial if decay == 1.0 else dict(joint.named_parameters())
    for name, p in result.joint.named_parameters():
        assert p.grad_fn is None and not p.requires_grad, name
        torch.testing.assert_close(p, want[name].detach(), rtol=0, atol=0)


# --- the key tree: the JAX step's own draws ---------------------------------

SEED, STEP = 4, 7


def _train_key(seed=SEED):
    return (rng.substream(rng.prng_key(seed), "train"),
            jax_train.substream(jax.random.PRNGKey(seed), "train"))


@pytest.mark.parametrize("fast", ["0", "1"])
def test_step_draws_equal_jax(fast, monkeypatch):
    """The step's timesteps, noise and self-conditioning coin from (seed,
    step), as ``make_text_train_step``'s ``loss_fn`` and ``_losses`` draw
    them: t and the coin bit-equal, the noise within 3 ulp."""
    from tinydiffusionmodels_tpu.core.rng import draw_noise, substream

    monkeypatch.setenv("TDM_FAST_NOISE", fast)
    _, tcfg = _configs()
    joint = _port_joint(tcfg, _jax_joint(_configs()[0]))
    tokens = torch.from_numpy(_batch()[0])
    port_key, jax_key = _train_key()
    for step in range(STEP, STEP + 4):
        sk = jax.random.fold_in(jax_key, step)
        t_j = jax.random.randint(substream(sk, "timesteps"), (B,), 0, 1000)
        noise_j = draw_noise(substream(sk, "noise"), (B, L, DIM))
        coin_j = jax.random.bernoulli(
            substream(substream(sk, "dropout"), "selfcond_coin"))
        t, noise = text_train.draw_t_noise(
            joint, tokens, 1000, rng.fold_in(port_key, step))
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
        np.testing.assert_allclose(noise.numpy(), np.asarray(noise_j),
                                   rtol=4e-7, atol=1e-7)
        assert text_train.coin(port_key, step) == bool(coin_j)


# name: (_losses keyword arguments, self-conditioned model, EMA decay)
STEP_VARIANTS = {
    "eps": (dict(), False, None),
    "x0": (dict(parameterization="x0"), False, None),
    "self_cond": (dict(), True, None),
    "ema": (dict(), False, 0.5),
}


@pytest.mark.parametrize("name", sorted(STEP_VARIANTS))
def test_training_steps_equal_jax_steps(name):
    """Three steps of the port's chunk runner (``TextSteps``, global steps
    STEP..STEP+2) against ``make_text_train_step_multi[_ema]`` from the
    same state, batches and train key, at dropout 0: every draw is the JAX
    step's, so losses and parameters agree to float32 rounding."""
    from tinydiffusionmodels_tpu.train.state import TrainState

    kwargs, self_cond, decay = STEP_VARIANTS[name]
    jcfg, tcfg = _configs(self_cond=self_cond)
    params = _jax_joint(jcfg)
    lr, k = 0.5, 3
    tx = optax.sgd(lr)
    tokens = np.random.default_rng(5).integers(0, VOCAB, (k, B, L))
    port_key, jax_key = _train_key()
    common = dict(use_learned_embeddings=True, **kwargs)
    joint = _port_joint(tcfg, params)

    def copy(tree):   # the JAX steps donate their state
        return jax.tree_util.tree_map(jnp.copy, tree)

    state = TrainState.create(copy(params), tx)
    state = TrainState(state.params, state.opt_state, jnp.int32(STEP))
    if decay is None:
        step = jax_train.make_text_train_step_multi(
            jax_schedule(), jcfg, tx, **common)
        state, sums = step(state, jnp.asarray(tokens), jnp.float32(0.7),
                           jax_key)
        want = _jax_state(state.params)
    else:
        step = jax_train.make_text_train_step_multi_ema(
            jax_schedule(), jcfg, tx, ema_decay=decay, **common)
        state, ema_j, sums = step(state, copy(params), jnp.asarray(tokens),
                                  jnp.float32(0.7), jax_key)
        want = _jax_state(ema_j)

    ema = None
    if decay is not None:
        import copy

        ema = copy.deepcopy(joint).requires_grad_(False)
    opt = torch.optim.SGD(joint.parameters(), lr=lr)
    runner = text_train.TextSteps(
        joint, opt, torch.from_numpy(tokens.reshape(k * B, L)),
        batch_size=B, steps=k, key=port_key, ema=ema, ema_decay=decay,
        sched=make_schedule(), pretrained_matrix=None, **common)
    runner.start(np.arange(k * B).reshape(k, B), 0.7, first_step=STEP)
    losses = runner.run(k)
    np.testing.assert_allclose(losses.sum(0), np.asarray(sums), rtol=1e-5,
                               atol=0)
    got = (ema if ema is not None else joint).named_parameters()
    for pname, p in got:
        np.testing.assert_allclose(p.detach().numpy(), want[pname], rtol=0,
                                   atol=1e-5, err_msg=pname)


def test_training_forward_with_dropout_equals_jax_flash_path(monkeypatch):
    """The denoiser in training mode at dropout 0.1 against
    ``tiny_transformer_apply`` with its attention sent to the Pallas flash
    kernels (interpret mode), whose mask the port's kernels hash: every
    mask and seed is the JAX package's for the same key, so output and
    gradients agree as at dropout 0 (atol 1e-4)."""
    from tinydiffusionmodels_tpu.ops import pallas_kernels, registry

    monkeypatch.setattr(registry, "_override", "pallas")
    monkeypatch.setattr(pallas_kernels, "TRAIN_SPILL_BYTES", -1)
    jcfg, tcfg = _configs(dropout=RATE, pos_emb="rope")
    params = _jax_joint(jcfg)["diffusion_model"]
    rs = np.random.default_rng(2)
    x = rs.standard_normal((B, L, DIM), dtype=np.float32)
    t = np.array([3, 500, 998], dtype=np.int32)
    g = rs.standard_normal((B, L, DIM), dtype=np.float32)
    key_j = jax_train.substream(jax.random.PRNGKey(8), "dropout")
    key_t = rng.substream(rng.prng_key(8), "dropout")

    def loss(p):
        out = tiny_transformer_apply(p, jnp.asarray(x), jnp.asarray(t), jcfg,
                                     deterministic=False, key=key_j)
        return jnp.sum(out * g), out

    grads, out_j = jax.grad(loss, has_aux=True)(params)
    model = TinyTransformer(tcfg)
    model.load_state_dict(convert.transformer_state_from_jax(params))
    out_t = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                  deterministic=False, key=key_t)
    (out_t * torch.from_numpy(g)).sum().backward()
    # Dropout changed the output: the comparison is not a dropout-0 one.
    assert (out_t == 0).any() or not torch.allclose(
        out_t, model(torch.from_numpy(x), torch.from_numpy(t).long()))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-4)
    want = convert.transformer_state_from_jax(grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
