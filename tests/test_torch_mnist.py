"""The MNIST DDPM of the torch package against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and go through both packages.
The residual block's JAX side is the Pallas kernel in interpret mode (as
``tests/test_ops.py`` runs it) and ``xla_ref.fused_resblock``; the port's is
``ops.fused_resblock``, whose CPU path is the plain version and whose
backward is autograd of the plain version, as the card's is. Tolerances:
the block 2e-4 (``tests/test_ops.py``'s, float32 sums in another order);
gradients, the UNet, the loss and an AdamW step 1e-4; EMA 1e-6; sampling on
a 20-step schedule with the JAX draws replayed 1e-3 (each step's last-ulp
differences compound). Both packages draw from one key tree
(``core/rng.py``): a step's timesteps are bit-equal to the JAX step's and
its noise within 3 ulp; three chunked training steps equal
``make_train_step_multi``'s (SGD, so AdamW's sign-like first steps do not
hide the draws: mean loss and parameters 1e-5); and sampling from a key
equals the JAX sampler from the same key at the replay's 1e-3.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.core import diffusion as jax_diff  # noqa: E402
from tinydiffusionmodels_tpu.core.schedule import (  # noqa: E402
    make_schedule as jax_make_schedule,
)
from tinydiffusionmodels_tpu.data.loader import batch_iterator  # noqa: E402
from tinydiffusionmodels_tpu.io.checkpoint import (  # noqa: E402
    unet_from_state_dict,
    unet_to_state_dict,
)
from tinydiffusionmodels_tpu.models import init_unet, unet_apply  # noqa: E402
from tinydiffusionmodels_tpu.models.torch_init import (  # noqa: E402
    conv_params,
)
from tinydiffusionmodels_tpu.ops import pallas_kernels, xla_ref  # noqa: E402
from tinydiffusionmodels_tpu.train import mnist_train as jax_train  # noqa: E402
from tinydiffusionmodels_tpu.train.optim import adamw as jax_adamw  # noqa: E402
from tinydiffusionmodels_torch import ops  # noqa: E402
from tinydiffusionmodels_torch.core import make_schedule, rng  # noqa: E402
from tinydiffusionmodels_torch.io import (  # noqa: E402
    unet_checkpoint_dict,
    unet_params_dict,
    unet_state_from_jax,
)
from tinydiffusionmodels_torch.models import SimpleUNet  # noqa: E402
from tinydiffusionmodels_torch.ops import reference  # noqa: E402
from tinydiffusionmodels_torch.train import mnist_train  # noqa: E402
from tinydiffusionmodels_torch.train.optim import adamw  # noqa: E402
from tinydiffusionmodels_torch.core.rng import prng_key  # noqa: E402

torch.set_num_threads(1)

# (Cin, Cout, H) of rb1..rb4 (models/unet.py:26).
SHAPES = [(1, 32, 28), (32, 64, 14), (64, 64, 14), (96, 32, 28)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _block(cin, cout, hw, seed=0, tb_shift=0.0):
    """JAX params, numpy x and time bias, and the port's argument list."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    p = {"conv1": conv_params(k1, 3, 3, cin, cout),
         "conv2": conv_params(k2, 3, 3, cout, cout),
         "skip": conv_params(k3, 1, 1, cin, cout) if cin != cout else None}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, hw, hw, cin), dtype=np.float32)
    tb = (rng.standard_normal((2, 1, 1, cout), dtype=np.float32)
          + np.float32(tb_shift))
    args = [_t(x), _oihw(p["conv1"]["w"]), _t(p["conv1"]["b"]),
            _oihw(p["conv2"]["w"]), _t(p["conv2"]["b"]), _t(tb)]
    args += ([_oihw(p["skip"]["w"]), _t(p["skip"]["b"])] if p["skip"]
             else [None, None])
    return p, x, tb, args


@pytest.mark.parametrize("cin, cout, hw", SHAPES)
def test_plain_block_matches_pallas_and_xla(cin, cout, hw):
    p, x, tb, args = _block(cin, cout, hw)
    out = reference.fused_resblock(*args).numpy()
    for ref in (pallas_kernels.fused_resblock, xla_ref.fused_resblock):
        want = np.asarray(ref(jnp.asarray(x), p, jnp.asarray(tb)))
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(ops.fused_resblock(*args).numpy(), out)


def test_border_pixels_see_zero_padding_not_time_bias():
    """Only the border shows whether conv2's SAME padding reads 0 (the TPU
    kernel's re-zeroed border) or the time bias: with a large time bias the
    two differ there by far more than the tolerance."""
    cin, cout, hw = 32, 64, 14
    p, x, tb, args = _block(cin, cout, hw, seed=3, tb_shift=4.0)
    ring = np.ones((hw, hw), bool)
    ring[1:-1, 1:-1] = False
    want = np.asarray(pallas_kernels.fused_resblock(jnp.asarray(x), p,
                                                    jnp.asarray(tb)))
    out = reference.fused_resblock(*args).numpy()
    np.testing.assert_allclose(out[:, ring], want[:, ring], rtol=2e-4,
                               atol=2e-4)
    # The wrong border: h padded with the time bias instead of 0.
    xt, w1, b1, w2, b2, tbt, ws, bs = args
    xc = xt.permute(0, 3, 1, 2)
    tbc = tbt.permute(0, 3, 1, 2)
    h = torch.relu(torch.nn.functional.conv2d(xc, w1, b1, padding=1)) + tbc
    h = torch.nn.functional.pad(h - tbc, (1, 1, 1, 1)) + tbc
    bad = torch.relu(torch.nn.functional.conv2d(h, w2, b2))
    bad = (bad + torch.nn.functional.conv2d(xc, ws, bs)).permute(0, 2, 3, 1)
    gap = np.abs(bad.numpy()[:, ring] - want[:, ring]).max()
    assert gap > 0.1, gap
    np.testing.assert_allclose(bad.numpy()[:, ~ring], want[:, ~ring],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cin, cout, hw", SHAPES)
def test_block_gradients_match_jax(cin, cout, hw):
    """Gradients through ``ops.fused_resblock`` (the autograd Function) for
    x, every weight and bias and the time bias, against ``jax.grad`` of the
    Pallas path (whose custom VJP differentiates ``xla_ref``)."""
    p, x, tb, args = _block(cin, cout, hw, seed=1)
    g = np.random.default_rng(2).standard_normal((2, hw, hw, cout),
                                                 dtype=np.float32)
    gx, gp, gtb = jax.grad(
        lambda x, p, tb: jnp.sum(pallas_kernels.fused_resblock(x, p, tb) * g),
        argnums=(0, 1, 2))(jnp.asarray(x), p, jnp.asarray(tb))
    leaves = [None if a is None else a.requires_grad_() for a in args]
    (ops.fused_resblock(*leaves) * _t(g)).sum().backward()
    want = [gx, gp["conv1"]["w"], gp["conv1"]["b"], gp["conv2"]["w"],
            gp["conv2"]["b"], gtb]
    if gp["skip"] is not None:
        want += [gp["skip"]["w"], gp["skip"]["b"]]
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        w = np.asarray(w)
        if w.ndim == 4 and i in (1, 3, 6):  # HWIO -> OIHW
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(leaf.grad.numpy(), w, err_msg=str(i),
                                   **TOL)


@pytest.fixture(scope="module")
def unet_pair():
    params = init_unet(jax.random.PRNGKey(0))
    model = SimpleUNet()
    model.load_state_dict(unet_state_from_jax(params), strict=True)
    return params, model.eval()


def _images(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n, 28, 28, 1)), -1, 1).astype(
        np.float32)


def test_unet_matches_jax(unet_pair):
    params, model = unet_pair
    x, t = _images(), np.array([10, 500], np.int32)
    want = np.asarray(unet_apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(_t(x), torch.from_numpy(t).long()).numpy()
    assert got.shape == (2, 28, 28, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_unet_params_round_trip(unet_pair):
    params, model = unet_pair
    back = unet_state_from_jax(unet_params_dict(model))
    assert list(back) == list(model.state_dict())
    for key, value in model.state_dict().items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    assert unet_params_dict(model)["rb3"]["skip"] is None
    assert list(unet_checkpoint_dict(model)) == list(
        unet_to_state_dict(params))


def _state(tree) -> dict:
    return {k: v.numpy() for k, v in unet_state_from_jax(tree).items()}


def test_loss_and_adamw_step_match_jax(unet_pair):
    """ddpm_loss, its gradients and the parameters after one AdamW step
    (lr 1e-3, weight decay 0.01: the trainer's) at fixed t and noise."""
    params, model = unet_pair
    model = copy.deepcopy(model)
    jsched, psched = jax_make_schedule(), make_schedule()
    x = _images(3, seed=1)
    t = np.array([0, 500, 999], np.int32)
    noise = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)

    def loss_fn(p):
        return jax_diff.ddpm_loss(
            jsched, lambda xt, tt: unet_apply(p, xt, tt), jnp.asarray(x),
            jnp.asarray(t), jnp.asarray(noise))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = jax_adamw(1e-3, weight_decay=0.01)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    got = mnist_train.optimizer_step(model, optimizer, _t(x),
                                     torch.from_numpy(t).long(), _t(noise),
                                     psched)
    np.testing.assert_allclose(float(got), float(loss), **TOL)
    want_grads, want_params = _state(grads), _state(new_params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name],
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   err_msg=name, **TOL)


def test_ema_update_matches_jax(unet_pair):
    params, model = unet_pair
    other = SimpleUNet(key=prng_key(7))
    ema = copy.deepcopy(model)
    mnist_train.ema_update(ema, other, 0.9)
    want = _state(jax_train.ema_update(
        params, jax.tree_util.tree_map(jnp.asarray, unet_params_dict(other)),
        0.9))
    for name, value in ema.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert not any(p.requires_grad and p.grad is not None
                   for p in ema.parameters())


def _replayed(key, shape, method, ts):
    """x_T and the per-step noise the JAX sampler draws
    (``tests/test_torch_sample.py``'s pattern)."""
    init_key, loop_key = jax.random.split(key)
    x_T = torch.from_numpy(np.array(jax.random.normal(init_key, shape)))
    if method != "ancestral":
        return dict(x_T=x_T)
    draws = np.array(jax.vmap(
        lambda t: jax.random.normal(jax.random.fold_in(loop_key, t), shape)
    )(jnp.asarray(ts)))
    index = {int(t): i for i, t in enumerate(ts)}
    return dict(x_T=x_T, noise_fn=lambda t: torch.from_numpy(draws[index[t]]))


@pytest.mark.parametrize("method, steps", [("ancestral", None), ("ddim", 5)])
def test_sampling_matches_jax(unet_pair, method, steps):
    params, model = unet_pair
    timesteps, n = 20, 2
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_train._sample_batch(
        params, key, n_samples=n, method=method, num_steps=steps,
        timesteps=timesteps))
    unet = SimpleUNet(timesteps)
    unet.load_state_dict(model.state_dict())
    got = mnist_train.sample_images(
        unet, make_schedule(timesteps), n_samples=n, method=method,
        num_steps=steps,
        **_replayed(key, (n, 28, 28, 1), method,
                    np.arange(timesteps - 1, -1, -1)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("steps", [5, 20])
def test_dpmpp_sampling_matches_jax(unet_pair, steps):
    """DPM-Solver++(2M) on the full 1000-step schedule (the bench's
    ``mnist_sample_dpmpp20_s`` path) from the JAX sampler's x_T: the solver
    draws no noise, so the two agree to float32 rounding, 1e-5 of the
    samples' largest magnitude. The untrained UNet's x0 = (x - s eps) / a
    divides by a = 0.0064 at t = 999, so the samples reach ~1e3 and a
    last-bit difference of eps moves them by a few float32 ulps of that
    (4.9e-4 absolute, 4.8e-7 of the magnitude, at 20 steps)."""
    params, model = unet_pair
    n, key = 2, jax.random.PRNGKey(13)
    want = np.asarray(jax_train._sample_batch(
        params, key, n_samples=n, method="dpm++", num_steps=steps,
        timesteps=1000))
    got = mnist_train.sample_images(
        model, make_schedule(), n_samples=n, method="dpm++", num_steps=steps,
        **_replayed(key, (n, 28, 28, 1), "dpm++", None))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_load(unet_pair, tmp_path, writer):
    """A .pth either package writes loads in the other, strict, with equal
    outputs."""
    from tinydiffusionmodels_tpu.io import load_checkpoint as jax_load
    from tinydiffusionmodels_tpu.io import save_checkpoint as jax_save
    from tinydiffusionmodels_torch.io import save_checkpoint

    params, model = unet_pair
    path = tmp_path / "m.pth"
    if writer == "jax":
        jax_save(unet_to_state_dict(params), path)
        port, jax_params = mnist_train.load_unet(str(path), "cpu"), params
    else:
        save_checkpoint(unet_checkpoint_dict(model), path)
        port, jax_params = model, unet_from_state_dict(jax_load(path))
    x, t = _images(seed=4), np.array([3, 777], np.int32)
    want = np.asarray(unet_apply(jax_params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(_t(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_device_batch_order_is_batch_iterators():
    data = _images(37, seed=5)
    for epoch in (0, 2):
        order = mnist_train.epoch_order(37, 8, seed=3, epoch=epoch,
                                        device="cpu")
        want = list(batch_iterator(data, 8, seed=3, epoch=epoch))
        assert order.shape == (len(want), 8) == (4, 8)
        for i, batch in enumerate(want):
            np.testing.assert_array_equal(_t(data)[order[i]].numpy(), batch)


@pytest.mark.parametrize("fast", ["0", "1"])
def test_step_draws_equal_jax(fast, monkeypatch):
    """A step's timesteps and noise from (seed, step), as the JAX step's
    ``loss_fn`` draws them."""
    from tinydiffusionmodels_tpu.core.rng import draw_noise, substream

    monkeypatch.setenv("TDM_FAST_NOISE", fast)
    shape = (4, 28, 28, 1)
    jkey = substream(jax.random.PRNGKey(3), "train")
    pkey = rng.substream(rng.prng_key(3), "train")
    for step in (0, 5, 1234):
        sk = jax.random.fold_in(jkey, step)
        t, noise = mnist_train.draw_t_noise(rng.fold_in(pkey, step), shape,
                                            1000)
        np.testing.assert_array_equal(t.numpy(), np.asarray(
            jax.random.randint(substream(sk, "timesteps"), (4,), 0, 1000)))
        np.testing.assert_allclose(
            noise.numpy(), np.asarray(draw_noise(substream(sk, "noise"),
                                                 shape)),
            rtol=4e-7, atol=1e-7)


def test_training_steps_equal_jax_steps(unet_pair):
    """Three steps of ``MnistSteps`` (global steps 9..11) against
    ``make_train_step_multi`` from the same state, images and train key:
    the mean loss and the parameters within 1e-5 (SGD at lr 0.1)."""
    import optax

    from tinydiffusionmodels_tpu.core.rng import substream
    from tinydiffusionmodels_tpu.train.state import TrainState

    params, model = unet_pair
    timesteps, k, b, lr = 20, 3, 2, 0.1
    images = np.stack([_images(b, seed=10 + i) for i in range(k)])
    tx = optax.sgd(lr)
    state = TrainState.create(jax.tree_util.tree_map(jnp.copy, params), tx)
    state = TrainState(state.params, state.opt_state, jnp.int32(9))
    step = jax_train.make_train_step_multi(jax_make_schedule(timesteps), tx)
    jkey = substream(jax.random.PRNGKey(6), "train")
    state, loss = step(state, jnp.asarray(images), jkey)

    unet = SimpleUNet(timesteps)
    unet.load_state_dict(model.state_dict())
    unet.train()
    optimizer = torch.optim.SGD(unet.parameters(), lr=lr)
    runner = mnist_train.MnistSteps(
        unet, optimizer, _t(images.reshape(k * b, 28, 28, 1)),
        make_schedule(timesteps), batch_size=b, steps=k,
        key=rng.substream(rng.prng_key(6), "train"))
    runner.start(np.arange(k * b).reshape(k, b), first_step=9)
    losses = runner.run(k)
    np.testing.assert_allclose(losses.mean(), float(loss), rtol=1e-5,
                               atol=1e-6)
    want = _state(state.params)
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("method, steps", [("ancestral", None), ("ddim", 5)])
def test_sampling_from_the_key_matches_jax(unet_pair, method, steps):
    """``sample_images(key=PRNGKey(11))`` draws the JAX sampler's x_T and
    step noise (within 3 ulp), so its samples are the JAX sampler's at the
    replay test's 1e-3."""
    params, model = unet_pair
    timesteps, n = 20, 2
    want = np.asarray(jax_train._sample_batch(
        params, jax.random.PRNGKey(11), n_samples=n, method=method,
        num_steps=steps, timesteps=timesteps))
    unet = SimpleUNet(timesteps)
    unet.load_state_dict(model.state_dict())
    got = mnist_train.sample_images(
        unet, make_schedule(timesteps), n_samples=n, method=method,
        num_steps=steps, key=rng.prng_key(11))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
