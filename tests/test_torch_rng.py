"""The port's key tree and draws (``core/rng.py``, ``ops/rng.py`` on the CPU)
against ``jax.random`` and the JAX package's ``core/rng.py`` (threefry,
partitionable, 32-bit mode: the configuration the suite runs JAX in).

Tolerances:
- keys, ``random_bits``, ``uniform``, ``randint``, ``bernoulli`` and
  ``counter_bernoulli``: bit-equal;
- ``erf_inv`` over all 2^23 uniforms ``normal`` can feed it: within 2 ulp
  (the port rounds ``log1p`` correctly, XLA's float32 ``log1p`` is off by
  an ulp for some inputs);
- ``normal`` and ``counter_normal``: within 3 ulp of the larger magnitude.
  ``normal`` multiplies an erf_inv 2 ulp off by sqrt(2) into a binade where
  that is 3 ulp; ``counter_normal`` compounds XLA's float32 ``log``,
  ``cos`` and ``sin`` (1 ulp off in about 8 %, 1 % and 1 % of its inputs,
  where the port rounds them correctly) through ``sqrt`` and the product.
  Both tests also bound the share of elements that differ at all.

The card's kernel (``csrc/rng.cu``) is held against these plain versions in
``chip_smoke.py``.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tinydiffusionmodels_torch import ops  # noqa: E402
from tinydiffusionmodels_torch.core import rng  # noqa: E402
from tinydiffusionmodels_tpu.core import rng as jrng  # noqa: E402

SEEDS = (0, -1, 2**32 + 5, 12345)
SHAPE = (5, 7, 33)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(jkey) -> np.ndarray:
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def _ulps(a, b) -> np.ndarray:
    """|a - b| in units of the float32 spacing at the larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    spacing = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a.astype(np.float64) - b) / spacing.astype(np.float64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    jk, k = _jkey(seed), rng.prng_key(seed)
    np.testing.assert_array_equal(k.numpy(), _words(jk))
    for data in (0, 1, 7, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(rng.fold_in(k, data).numpy(),
                                      _words(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(
        np.stack([x.numpy() for x in rng.split(k, 3)]),
        _words(jax.random.split(jk, 3)))
    for name in ("train", "timesteps", "noise", "dropout", "attn_weights"):
        np.testing.assert_array_equal(rng.substream(k, name).numpy(),
                                      _words(jrng.substream(jk, name)))
    np.testing.assert_array_equal(
        rng.key_for_step(k, 41).numpy(), _words(jrng.key_for_step(jk, 41)))


def test_seed_outside_int64_raises():
    with pytest.raises(OverflowError):
        rng.prng_key(2**63)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_equal_jax(seed):
    jk, k = _jkey(seed), rng.prng_key(seed)
    np.testing.assert_array_equal(rng.random_bits(k, SHAPE).numpy(),
                                  np.asarray(jax.random.bits(jk, SHAPE)))
    np.testing.assert_array_equal(rng.uniform(k, SHAPE).numpy(),
                                  np.asarray(jax.random.uniform(jk, SHAPE)))
    for p in (0.5, 0.9):
        np.testing.assert_array_equal(
            rng.bernoulli(k, p, SHAPE).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, SHAPE)))
    np.testing.assert_array_equal(rng.bernoulli(k).numpy(),
                                  np.asarray(jax.random.bernoulli(jk)))


# (shape, minval, maxval): the trainers' timesteps, a small range, the
# flash kernels' seed (int32 min..max), an empty span and a reversed one.
RANDINT = [((64,), 0, 1000), ((3, 4), 0, 5), ((1,), -2**31, 2**31 - 1),
           ((1000,), -2**31, 2**31 - 1), ((4,), 3, 3), ((100,), 0, 2**31 - 1),
           ((50,), 100, 7)]


@pytest.mark.parametrize("case", range(len(RANDINT)))
def test_randint_equal_jax(case):
    shape, lo, hi = RANDINT[case]
    for seed in SEEDS:
        want = np.asarray(jax.random.randint(_jkey(seed), shape, lo, hi,
                                             dtype=jnp.int32))
        got = rng.randint(rng.prng_key(seed), shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_int64_equal_jax_x64():
    """The 64-bit form (JAX with 64-bit mode on), from the same key."""
    k = rng.prng_key(9)
    with jax.enable_x64(True):
        jk = jax.random.wrap_key_data(jnp.asarray(k.numpy(), jnp.uint32))
        for lo, hi in ((0, 1000), (-2**40, 2**50), (-2**63, 2**63 - 1)):
            want = np.asarray(jax.random.randint(jk, (37,), lo, hi,
                                                 dtype=jnp.int64))
            got = rng.randint(k, (37,), lo, hi, dtype=torch.int64)
            np.testing.assert_array_equal(got.numpy(), want)


def test_counter_bernoulli_equal_jax():
    for seed in SEEDS:
        for p in (0.9, 0.5):
            np.testing.assert_array_equal(
                rng.counter_bernoulli(rng.prng_key(seed), p, SHAPE).numpy(),
                np.asarray(jrng.counter_bernoulli(_jkey(seed), p, SHAPE)))


@pytest.mark.parametrize("n", [1, 2, 100_001])
def test_counter_normal_within_3_ulp(n):
    a = np.asarray(jrng.counter_normal(_jkey(3), (n,)))
    b = rng.counter_normal(rng.prng_key(3), (n,)).numpy()
    d = _ulps(a, b)
    assert d.max() <= 3.0, d.max()
    assert (d > 0).mean() < 0.1 and (d > 2).mean() < 1e-3


def test_normal_within_3_ulp():
    a = np.asarray(jax.random.normal(_jkey(7), (200_000,)))
    b = rng.normal(rng.prng_key(7), (200_000,)).numpy()
    d = _ulps(a, b)
    assert d.max() <= 3.0, d.max()
    assert (d > 0).mean() < 0.02


def test_erf_inv_within_2_ulp_of_every_uniform():
    """Every float32 ``normal`` can pass to erf_inv: the 2^23 mantissas of
    [1, 2), mapped as ``jax.random.uniform`` maps them."""
    i = np.arange(2**23, dtype=np.uint32)
    f = (i | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * np.float32(2.0) + lo).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = rng.erf_inv(torch.from_numpy(u)).numpy()
    d = _ulps(want, got)
    assert d.max() <= 2.0, d.max()
    assert (d > 0).mean() < 0.02
    # torch's own erfinv is what the port does not use: far from XLA's.
    assert _ulps(want, torch.erfinv(torch.from_numpy(u)).numpy()).max() > 10


WINDOWS = {
    "rows": ((8, 64, 16), ((4, 4), (0, 64), (0, 16))),
    "positions": ((4, 64, 16), ((0, 4), (16, 16), (0, 16))),
    "columns": ((4, 8, 32), ((0, 4), (0, 8), (16, 16))),
    "box": ((6, 10, 12), ((2, 3), (5, 5), (3, 7))),
}


def _cut(x, window):
    return x[tuple(slice(s, s + n) for s, n in window)]


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_a_window_is_its_slice_of_the_whole_draw(name):
    shape, window = WINDOWS[name]
    k = rng.fold_in(rng.prng_key(5), 3)
    draws = {
        "bits": lambda **w: rng.random_bits(k, shape, **w),
        "normal": lambda **w: rng.normal(k, shape, **w),
        "counter_normal": lambda **w: rng.counter_normal(k, shape, **w),
        "bernoulli": lambda **w: rng.bernoulli(k, 0.9, shape, **w),
        "counter_bernoulli": lambda **w: rng.counter_bernoulli(
            k, 0.9, shape, **w),
    }
    for what, draw in draws.items():
        whole, part = draw(), draw(window=window)
        assert torch.equal(part, _cut(whole, window)), what
    t = rng.randint(k, (shape[0],), 0, 1000)
    assert torch.equal(rng.randint(k, (shape[0],), 0, 1000,
                                   window=(window[0],)), _cut(t, window[:1]))


def test_a_one_dim_window_is_a_flat_slice():
    k = rng.prng_key(2)
    whole = rng.random_bits(k, (1000,))
    np.testing.assert_array_equal(
        rng.random_bits(k, (1000,), window=((500, 300),)), whole[500:800])


def test_key_path_resolves_on_the_cpu():
    base = rng.substream(rng.prng_key(4), "train")
    step = torch.tensor([17])
    path = rng.substream(rng.fold_in(base, step), "noise")
    assert isinstance(path, rng.KeyPath)
    want = rng.substream(rng.fold_in(base, 17), "noise")
    assert torch.equal(path.resolve(), want)
    assert torch.equal(rng.normal(path, (3, 4)), rng.normal(want, (3, 4)))
    with pytest.raises(ValueError):
        rng.fold_in(path, torch.tensor([1]))


@pytest.mark.parametrize("fast", ["0", "1"])
def test_draw_noise_and_keep_follow_tdm_fast_noise(fast, monkeypatch):
    monkeypatch.setenv("TDM_FAST_NOISE", fast)
    jk, k = _jkey(11), rng.prng_key(11)
    shape = (4, 9, 8)
    want = np.asarray(jrng.draw_keep(jk, 0.9, shape))
    np.testing.assert_array_equal(rng.draw_keep(k, 0.9, shape).numpy(), want)
    noise = np.asarray(jrng.draw_noise(jk, shape))
    assert _ulps(noise, ops.rng.draw_noise(k, shape).numpy()).max() <= 3.0


def test_auto_is_the_stock_draw_on_the_cpu(monkeypatch):
    monkeypatch.delenv("TDM_FAST_NOISE", raising=False)
    assert not rng.fast_noise("cpu") and rng.fast_noise("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", ["0", "1"])
def test_dropout_equals_torch_init_dropout(dtype, fast, monkeypatch):
    """``ops.rng.dropout`` on the CPU against the JAX package's
    ``torch_init.dropout`` (``where(keep, x / (1 - rate), 0)``): bit-equal,
    in float32 and bfloat16; the gradient is the mask over the keep
    probability."""
    from tinydiffusionmodels_tpu.models.torch_init import dropout

    monkeypatch.setenv("TDM_FAST_NOISE", fast)
    x = np.random.default_rng(0).standard_normal((3, 8, 16)).astype(
        np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(dropout(_jkey(2), jnp.asarray(x, jd), 0.1,
                              deterministic=False).astype(jnp.float32))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    got = ops.rng.dropout(xt, rng.prng_key(2), 0.1)
    np.testing.assert_array_equal(got.float().detach().numpy(), want)
    (g,) = torch.autograd.grad(got.float().sum(), xt)
    keep = rng.draw_keep(rng.prng_key(2), 0.9, x.shape).numpy()
    np.testing.assert_array_equal(g.float().numpy() > 0, keep)


def test_attention_seed_is_pack_scalars_seed():
    from tinydiffusionmodels_tpu.ops.pallas_kernels import _pack_scalars

    for seed in SEEDS:
        want = int(np.asarray(_pack_scalars(0.1, _jkey(seed), 0, 0))[0])
        got = ops.rng.attention_seed(rng.prng_key(seed))
        assert got.dtype == torch.int32 and got.shape == (1,)
        assert int(got) == want


def test_box_merges_whole_inner_dims():
    assert ops.rng.box((8, 64, 256), ((4, 4), (0, 64), (0, 256))) == [
        (4 * 64 * 256, 1, 4 * 64 * 256)]
    assert ops.rng.box((4, 64, 16), ((0, 4), (16, 16), (0, 16))) == [
        (4, 64 * 16, 0), (16 * 16, 1, 16 * 16)]
    assert ops.rng.box((1,), None) == [(1, 1, 0)]
    assert ops.rng.box((1, 1, 5), ((0, 1), (0, 1), (2, 3))) == [(3, 1, 2)]


def _np_fmix32(h):
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    return h ^ (h >> np.uint64(16))


@pytest.mark.parametrize("n", [7, 8])
def test_counter_normal_halves(n):
    """The first (n + 1) // 2 draws are r cos(theta) of pairs 0, 1, ...,
    the rest r sin(theta) of the same pairs: held against Box-Muller in
    float64 on the same two hashes of each pair (1e-6 relative, the
    float32 rounding of r, theta and the product)."""
    seed, seed2 = (np.uint64(s) for s in rng.counter_seeds(rng.prng_key(1)))
    m = np.uint64(0xFFFFFFFF)
    half = (n + 1) // 2
    pair = np.arange(half, dtype=np.uint64)
    h1 = _np_fmix32((pair * np.uint64(0x9E3779B9) + seed) & m)
    h2 = _np_fmix32((pair * np.uint64(0x85EBCA6B) + seed2) & m)
    u1 = (h1 >> np.uint64(8)).astype(np.float64) * 2.0**-24 + 2.0**-25
    u2 = (h2 >> np.uint64(8)).astype(np.float64) * 2.0**-24
    r, theta = np.sqrt(-2.0 * np.log(u1)), 2.0 * math.pi * u2
    want = np.concatenate([r * np.cos(theta), (r * np.sin(theta))[:n - half]])
    z = rng.counter_normal(rng.prng_key(1), (n,)).numpy()
    np.testing.assert_allclose(z, want, rtol=1e-6, atol=1e-6)


def test_a_device_key_is_never_read_on_the_host():
    """Folding a key that lies off the CPU (a meta tensor here, as a CUDA
    one on the card) makes a ``KeyPath`` the draw kernel derives, with no
    host read; on the CPU the same path resolves to the host fold."""
    k = rng.prng_key(3)
    path = rng.substream(rng.fold_in(k.to("meta"), 5), "noise")
    assert isinstance(path, rng.KeyPath) and path.counter is None
    assert path.words == (5, rng.name_word("noise"))
    cpu = rng.KeyPath(k, words=path.words).resolve()
    assert torch.equal(cpu, rng.substream(rng.fold_in(k, 5), "noise"))
