"""bf16 compute of the torch package against the JAX package, on the CPU.

``train/precision.py``'s two functions are held against the JAX package's on
the same names and trees. Then one bf16 training step of each model: the
same weights (the JAX package's init, carried over by ``io.convert``), the
same batch, timesteps and noise made with numpy, deterministic, through the
JAX package's ``compute_dtype=jnp.bfloat16`` loss (the body of
``make_text_train_step`` and ``make_train_step``, with t and noise given
instead of drawn from a key) and an optax AdamW update, and through the
port's ``compute_dtype=torch.bfloat16`` loss and ``torch.optim.AdamW``.
The two round at the same points (parameters, the denoiser's input, the
rounding head's input) but their bf16 kernels sum in other orders, LayerNorm
accumulates in f32 in PyTorch and in bf16 under XLA, and XLA reduces a bias
gradient in bf16, so:

- losses 2e-2 relative;
- gradients: 5e-2 of each tensor's largest magnitude, plus the JAX bf16
  gradient's own largest distance from the JAX f32 gradient of the same
  step. At these sizes a bf16 gradient is that noisy by nature: a ReLU
  whose input rounds across 0 drops a term, and XLA sums the rounding
  head's bias gradient in bf16. The JAX bf16 gradients depart from the JAX
  f32 ones by up to 0.195 of the max (``linear1.weight``, x0 with the
  anchor CE) and 0.134 (the rounding bias); the port's by up to 0.169 and
  0.005. The port's are not farther from the JAX f32 gradient than that
  either;
- parameters after one AdamW step 1e-3 absolute (lr 1e-4: an update is at
  most 1e-4, so a sign that disagrees on a near-zero gradient moves one
  coordinate by 2e-4);
- the master gradients and AdamW's state are f32, the checkpoint f32.
"""

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy
optax = pytest.importorskip("optax")

from tinydiffusionmodels_tpu.core import diffusion as jax_diff  # noqa: E402
from tinydiffusionmodels_tpu.core import make_schedule as jax_schedule  # noqa: E402
from tinydiffusionmodels_tpu.models import (  # noqa: E402
    init_learned_embedding,
    init_learned_rounding,
    init_tiny_transformer,
    init_unet,
    unet_apply,
)
from tinydiffusionmodels_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JaxConfig,
)
from tinydiffusionmodels_tpu.train import precision as jax_precision  # noqa: E402
from tinydiffusionmodels_tpu.train import text_train as jax_train  # noqa: E402
from tinydiffusionmodels_tpu.train.optim import adamw as jax_adamw  # noqa: E402
from tinydiffusionmodels_torch.core import make_schedule, rng  # noqa: E402
from tinydiffusionmodels_torch.io import (  # noqa: E402
    convert,
    unet_state_from_jax,
)
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedEmbedding,
    LearnedRounding,
    SimpleUNet,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.train import mnist_train, text_train  # noqa: E402
from tinydiffusionmodels_torch.train import precision  # noqa: E402
from tinydiffusionmodels_torch.train.optim import adamw  # noqa: E402

torch.set_num_threads(1)

BF16 = torch.bfloat16
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 2e-2, 5e-2, 1e-3
LR = 1e-4


# --- precision.py -----------------------------------------------------------

@pytest.mark.parametrize("name", [None, "", "f32", "float32", "bf16",
                                  "bfloat16"])
def test_resolve_compute_dtype_matches_jax(name):
    want = jax_precision.resolve_compute_dtype(name)
    got = precision.resolve_compute_dtype(name)
    assert (got is None) == (want is None)
    if want is not None:
        assert want == jnp.bfloat16 and got == torch.bfloat16


@pytest.mark.parametrize("name", ["fp16", "bf32", "F32"])
def test_resolve_compute_dtype_errors_match_jax(name):
    with pytest.raises(ValueError) as want:
        jax_precision.resolve_compute_dtype(name)
    with pytest.raises(ValueError) as got:
        precision.resolve_compute_dtype(name)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_cast_floating_matches_jax(dtype):
    rng = np.random.default_rng(0)
    leaves = {"b": rng.standard_normal((4,), dtype=np.float32),
              "ids": np.arange(5, dtype=np.int32),
              "step": np.int32(7),
              "w": rng.standard_normal((3, 4), dtype=np.float32)}
    jax_dtype = None if dtype is None else jnp.bfloat16
    want = jax_precision.cast_floating(
        {k: jnp.asarray(v) for k, v in leaves.items()}, jax_dtype)
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in leaves.items()}
    got = precision.cast_floating(params, precision.resolve_compute_dtype(
        dtype))
    if dtype is None:
        assert got is params
    assert list(got) == list(want)
    for k, v in got.items():
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(want[k], np.float32))


def test_cast_floating_is_differentiable_into_f32():
    w = torch.randn(4, 3, requires_grad=True)
    cast = precision.cast_floating({"w": w}, BF16)["w"]
    assert cast.dtype == BF16
    (cast.float() * 2).sum().backward()
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(w.grad, torch.full((4, 3), 2.0))


# --- helpers ----------------------------------------------------------------

def _close_rel(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float32)
                       - np.asarray(want, np.float32)).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _close_bf16_grad(got, want16, want32, what):
    """``got`` (the port's bf16-step gradient) against the JAX bf16-step
    gradient ``want16``: GRAD_RTOL of its largest magnitude plus the JAX
    bf16 gradient's own distance from the JAX f32 one ``want32``; and no
    farther from ``want32`` than ``want16`` is, plus GRAD_RTOL."""
    got, want16, want32 = (np.asarray(a, np.float32)
                           for a in (got, want16, want32))
    scale = max(float(np.abs(want16).max()), 1e-12)
    own = float(np.abs(want16 - want32).max())
    err = float(np.abs(got - want16).max())
    assert err <= GRAD_RTOL * scale + own, (
        f"{what}: {err} > {GRAD_RTOL} x {scale} + {own}")
    err32 = float(np.abs(got - want32).max())
    assert err32 <= GRAD_RTOL * scale + own, (
        f"{what}: {err32} from f32 > {GRAD_RTOL} x {scale} + {own}")


def _adamw_step_jax(params, grads):
    tx = jax_adamw(LR, weight_decay=1e-4)
    updates, state = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def _check_optimizer_state_f32(optimizer):
    for state in optimizer.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            assert state[key].dtype == torch.float32, key


# --- text: one bf16 step ----------------------------------------------------

DIM, HEADS, DEPTH, FFN, VOCAB, B, L = 32, 2, 2, 64, 64, 4, 16

# name: _losses keyword arguments
TEXT_VARIANTS = {
    "eps": dict(),
    "anchor_ce_x0": dict(parameterization="x0", anchor_ce=0.5),
}


def _text_models():
    kw = dict(dim=DIM, n_heads=HEADS, depth=DEPTH, ffn_dim=FFN, dropout=0.0)
    jcfg, tcfg = JaxConfig(**kw), TransformerConfig(**kw)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {
        "diffusion_model": init_tiny_transformer(keys[0], jcfg),
        "rounding_fn": init_learned_rounding(keys[1], DIM, VOCAB),
        "embedding_fn": init_learned_embedding(keys[2], VOCAB, DIM),
    }
    model = TinyTransformer(tcfg)
    model.load_state_dict(
        convert.transformer_state_from_jax(params["diffusion_model"]))
    rounding = LearnedRounding(DIM, VOCAB)
    rounding.load_state_dict(
        convert.rounding_state_from_jax(params["rounding_fn"]))
    embedding = LearnedEmbedding(VOCAB, DIM)
    embedding.load_state_dict(
        convert.embedding_state_from_jax(params["embedding_fn"]))
    joint = torch.nn.ModuleDict({"diffusion_model": model,
                                 "rounding_fn": rounding,
                                 "embedding_fn": embedding})
    return jcfg, params, joint


def _text_state(params) -> dict:
    return {
        **{f"diffusion_model.{k}": v.numpy() for k, v in
           convert.transformer_state_from_jax(params["diffusion_model"]).items()},
        **{f"rounding_fn.{k}": v.numpy() for k, v in
           convert.rounding_state_from_jax(params["rounding_fn"]).items()},
        **{f"embedding_fn.{k}": v.numpy() for k, v in
           convert.embedding_state_from_jax(params["embedding_fn"]).items()},
    }


@pytest.mark.parametrize("name", sorted(TEXT_VARIANTS))
def test_text_bf16_step_matches_jax(name):
    kwargs = TEXT_VARIANTS[name]
    jcfg, params, joint = _text_models()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, VOCAB, (B, L))
    t = rng.integers(0, 1000, (B,))
    noise = rng.standard_normal((B, L, DIM), dtype=np.float32)
    weight = 0.7

    def loss(p, dtype=jnp.bfloat16):
        total, (diff, round_) = jax_train._losses(
            p, jnp.asarray(tokens), jnp.asarray(t), jnp.asarray(noise),
            jnp.float32(weight), cfg=jcfg, sched=jax_schedule(),
            use_learned_embeddings=True, pretrained_matrix=None,
            deterministic=True, key=None, compute_dtype=dtype, **kwargs)
        return total, (total, diff, round_)

    grads, ref = jax.grad(loss, has_aux=True)(params)
    grads32 = _text_state(jax.grad(lambda p: loss(p, None)[0])(params))
    new_params = _adamw_step_jax(params, grads)

    optimizer = adamw(joint.parameters(), LR, weight_decay=1e-4)
    total, (diff, round_) = text_train._losses(
        joint, torch.from_numpy(tokens), torch.from_numpy(t),
        torch.from_numpy(noise), weight, sched=make_schedule(),
        use_learned_embeddings=True, pretrained_matrix=None,
        deterministic=True, compute_dtype=BF16, **kwargs)
    for got, want, what in zip((total, diff, round_), ref,
                               ("total", "diffusion", "rounding")):
        assert got.dtype == torch.float32, what
        _close_rel(got.item(), float(want), LOSS_RTOL, what)

    optimizer.zero_grad(set_to_none=True)
    total.backward()
    want_grads = _text_state(grads)
    for pname, p in joint.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, pname
        _close_bf16_grad(p.grad.numpy(), want_grads[pname], grads32[pname],
                         pname)
    optimizer.step()
    _check_optimizer_state_f32(optimizer)
    want_params = _text_state(new_params)
    for pname, p in joint.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[pname],
                                   rtol=0, atol=PARAM_ATOL, err_msg=pname)


def test_text_bf16_train_step_keeps_f32_and_moves_every_parameter():
    """``train_step`` at dropout 0.1 in bf16: finite f32 losses, f32
    parameters, gradients and AdamW state, and every parameter moved."""
    _, _, joint = _text_models()
    for layer in joint["diffusion_model"].encoder.layers:
        layer.rate = 0.1
    before = {n: p.detach().clone() for n, p in joint.named_parameters()}
    optimizer = adamw(joint.parameters(), 1e-3)
    tokens = torch.randint(0, VOCAB, (B, L),
                           generator=torch.Generator().manual_seed(1))
    losses = text_train.train_step(
        joint, optimizer, tokens, 1.0, rng.prng_key(0),
        sched=make_schedule(), use_learned_embeddings=True,
        pretrained_matrix=None, compute_dtype=BF16)
    assert losses.dtype == torch.float32 and bool(torch.isfinite(
        losses).all())
    _check_optimizer_state_f32(optimizer)
    for name, p in joint.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert not torch.equal(p.detach(), before[name]), name


# --- MNIST: one bf16 step through the full UNet -----------------------------

def test_mnist_bf16_step_matches_jax():
    """``ddpm_loss`` at batch 2 through the full UNet (the resblock's plain
    version on the CPU), its gradients and one AdamW step (lr 1e-4), bf16
    against the JAX package's ``compute_dtype=jnp.bfloat16`` loss."""
    params = init_unet(jax.random.PRNGKey(0))
    model = SimpleUNet()
    model.load_state_dict(unet_state_from_jax(params), strict=True)
    rng = np.random.default_rng(1)
    x = np.clip(rng.standard_normal((2, 28, 28, 1)), -1, 1).astype(
        np.float32)
    t = np.array([3, 700], np.int32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    jsched = jax_schedule()

    def loss_fn(p, dtype=jnp.bfloat16):
        # make_train_step's loss with t and noise given.
        x_noisy = jax_diff.q_sample(jsched, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(noise))
        p_c = jax_precision.cast_floating(p, dtype)
        if dtype is not None:
            x_noisy = x_noisy.astype(dtype)
        eps = unet_apply(p_c, x_noisy, jnp.asarray(t),
                         timesteps=jsched.timesteps)
        return jnp.mean(jnp.square(eps.astype(jnp.float32)
                                   - jnp.asarray(noise)))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    grads32 = {k: v.numpy() for k, v in unet_state_from_jax(
        jax.grad(lambda p: loss_fn(p, None))(params)).items()}
    new_params = _adamw_step_jax(params, grads)

    optimizer = adamw(model.parameters(), LR, weight_decay=1e-4)
    got = mnist_train.optimizer_step(
        model, optimizer, torch.from_numpy(x), torch.from_numpy(t).long(),
        torch.from_numpy(noise), make_schedule(), compute_dtype=BF16)
    assert got.dtype == torch.float32
    _close_rel(got.item(), float(loss), LOSS_RTOL, "loss")
    want_grads = {k: v.numpy() for k, v in unet_state_from_jax(grads).items()}
    want_params = {k: v.numpy()
                   for k, v in unet_state_from_jax(new_params).items()}
    _check_optimizer_state_f32(optimizer)
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        _close_bf16_grad(p.grad.numpy(), want_grads[name], grads32[name],
                         name)
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_resblock_backward_matches_jax_vjp_in_bf16():
    """The block's backward differentiates it in the operands' dtype, as
    the JAX custom VJP's ``jax.vjp(xla_ref.fused_resblock, ...)`` does:
    bf16 leaves get bf16 gradients, held against that vjp on the same bf16
    values by the gradient rule above (its f32 twin is the f32 vjp)."""
    from tinydiffusionmodels_tpu.ops import xla_ref

    from tinydiffusionmodels_torch import ops

    g = torch.Generator().manual_seed(2)
    args = [torch.randn(2, 14, 14, 32, generator=g),
            0.05 * torch.randn(64, 32, 3, 3, generator=g),
            0.1 * torch.randn(64, generator=g),
            0.05 * torch.randn(64, 64, 3, 3, generator=g),
            0.1 * torch.randn(64, generator=g),
            torch.randn(2, 1, 1, 64, generator=g),
            0.2 * torch.randn(64, 32, 1, 1, generator=g),
            0.1 * torch.randn(64, generator=g)]
    args = [a.to(BF16) for a in args]
    cot = torch.randn(2, 14, 14, 64, generator=g).to(BF16)
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(ops.fused_resblock(*leaves), leaves, cot)

    def jax_vjp(dtype):
        x, w1, b1, w2, b2, tb, ws, bs = (
            jnp.asarray(a.float().numpy()).astype(dtype) for a in args)
        hwio = lambda w: w.transpose(2, 3, 1, 0)  # noqa: E731
        p = {"conv1": {"w": hwio(w1), "b": b1},
             "conv2": {"w": hwio(w2), "b": b2},
             "skip": {"w": hwio(ws), "b": bs}}
        _, vjp = jax.vjp(xla_ref.fused_resblock, x, p, tb)
        gx, gp, gtb = vjp(jnp.asarray(cot.float().numpy()).astype(dtype))
        oihw = lambda w: w.transpose(3, 2, 0, 1)  # noqa: E731
        out = [gx, oihw(gp["conv1"]["w"]), gp["conv1"]["b"],
               oihw(gp["conv2"]["w"]), gp["conv2"]["b"], gtb,
               oihw(gp["skip"]["w"]), gp["skip"]["b"]]
        return [np.asarray(a.astype(jnp.float32)) for a in out]

    want16, want32 = jax_vjp(jnp.bfloat16), jax_vjp(jnp.float32)
    for i, grad in enumerate(got):
        assert grad.dtype == BF16, i
        _close_bf16_grad(grad.float().numpy(), want16[i], want32[i], str(i))


def test_mnist_bf16_training_checkpoint_is_f32(tmp_path, monkeypatch):
    """``mnist_train.train`` in bf16 on 64 digits: a finite loss, an f32
    model and an f32 checkpoint that loads strict."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TDM_DATA_LIMIT", "64")
    # load_mnist would try a torchvision download before it renders
    # synthetic digits.
    monkeypatch.setitem(sys.modules, "torchvision", None)
    result = mnist_train.train(
        epochs=1, batch_size=32, ckpt_path=str(tmp_path / "m.pth"),
        sample_every_epoch=False, data_root=str(tmp_path / "data"),
        compute_dtype=BF16, device="cpu", log_fn=lambda *_: None)
    assert result.steps == 2 and np.isfinite(result.step_losses).all()
    assert all(p.dtype == torch.float32 for p in result.model.parameters())
    state = torch.load(tmp_path / "m.pth", weights_only=False)
    assert all(v.dtype == torch.float32 for v in state.values())
    mnist_train.load_unet(str(tmp_path / "m.pth"), "cpu")  # strict
