"""The port's residual block at every width the Pallas kernel takes, and
its concat-free decoder block, against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and go through both packages.
The JAX side of the one-source block is the Pallas kernel in interpret mode
(as ``tests/test_ops.py`` runs it) and ``xla_ref.fused_resblock``; of the
two-source block, ``xla_ref.fused_resblock_split`` on the upsampled first
source. The port's side is its plain version, which is the CPU path of
``ops.fused_resblock`` and ``ops.fused_resblock_split``, and the autograd
``Function`` around it. The host plan of the CUDA kernels
(``resblock.plan``: the narrow kernel or the wgmma kernel, and its
layout) is checked here over the widths 1 to 1024, and the wgmma kernel's
weight packing (K-major taps, 3xTF32 planes) bit for bit; the kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances: the block 2e-4 (``tests/test_ops.py``'s, float32 sums in
another order, more of them at the wide shapes); the two-source block 1e-5
(the same convolutions, its input channels split in two); gradients and the
UNet 1e-4, as ``tests/test_torch_mnist.py``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.models import init_unet, unet_apply  # noqa: E402
from tinydiffusionmodels_tpu.models.torch_init import (  # noqa: E402
    conv_params,
)
from tinydiffusionmodels_tpu.ops import pallas_kernels, xla_ref  # noqa: E402
from tinydiffusionmodels_torch import ops  # noqa: E402
from tinydiffusionmodels_torch.io import unet_state_from_jax  # noqa: E402
from tinydiffusionmodels_torch.models import SimpleUNet  # noqa: E402
from tinydiffusionmodels_torch.ops import reference, resblock  # noqa: E402

torch.set_num_threads(1)

# (Cin, Cout, H, W): odd, narrow, non-square and wide blocks; the identity
# skip where Cin == Cout.
WIDTHS = [(1, 1, 5, 5), (3, 8, 9, 13), (5, 40, 12, 12), (48, 24, 14, 14),
          (96, 96, 7, 7), (128, 256, 8, 8)]
# Widths the plan is checked at: every edge of the k step (8, 16), the
# warp's 32 columns and the instances' 64, 128 and 256, up to 1024.
PLAN_WIDTHS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 24, 31, 32, 33, 40, 48, 63, 64,
               65, 96, 100, 127, 128, 129, 160, 255, 256, 257, 384, 500, 511,
               512, 513, 640, 768, 1000, 1023, 1024]
# The UNet's blocks: (Cin, Cout, H).
UNET_BLOCKS = [(1, 32, 28), (32, 64, 14), (64, 64, 14), (96, 32, 28)]
DTYPES = [torch.float32, torch.bfloat16]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _params(cin, cout, seed, skip=None):
    """JAX params of a block (a 1x1 skip where Cin != Cout, or where
    ``skip``) and the port's weight arguments."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    skip = cin != cout if skip is None else skip
    p = {"conv1": conv_params(k1, 3, 3, cin, cout),
         "conv2": conv_params(k2, 3, 3, cout, cout),
         "skip": conv_params(k3, 1, 1, cin, cout) if skip else None}
    weights = [_oihw(p["conv1"]["w"]), _t(p["conv1"]["b"]),
               _oihw(p["conv2"]["w"]), _t(p["conv2"]["b"])]
    tail = ([_oihw(p["skip"]["w"]), _t(p["skip"]["b"])] if skip
            else [None, None])
    return p, weights, tail


@pytest.mark.parametrize("cin, cout, h, w", WIDTHS)
def test_plain_block_matches_pallas_and_xla_at_width(cin, cout, h, w):
    p, weights, tail = _params(cin, cout, seed=cin + cout)
    rng = np.random.default_rng(cin * 1000 + cout)
    x = rng.standard_normal((2, h, w, cin), dtype=np.float32)
    tb = rng.standard_normal((2, 1, 1, cout), dtype=np.float32)
    args = [_t(x), *weights, _t(tb), *tail]
    out = reference.fused_resblock(*args).numpy()
    assert out.shape == (2, h, w, cout)
    for ref in (pallas_kernels.fused_resblock, xla_ref.fused_resblock):
        want = np.asarray(ref(jnp.asarray(x), p, jnp.asarray(tb)))
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
    # The wrapper's CPU path is the plain version.
    np.testing.assert_array_equal(ops.fused_resblock(*args).numpy(), out)


def _split_case(skip: bool, up: int, seed: int = 0):
    """Two sources, x_a (2, 8 / up, 12 / up, 16) and x_b (2, 8, 12, 8), of
    a block to Cout 12 with a 1x1 skip, or to 24 with the identity."""
    ca, cb = 16, 8
    cout = 12 if skip else ca + cb
    p, weights, tail = _params(ca + cb, cout, seed, skip)
    rng = np.random.default_rng(seed + 10 * up + skip)
    x_a = rng.standard_normal((2, 8 // up, 12 // up, ca), dtype=np.float32)
    x_b = rng.standard_normal((2, 8, 12, cb), dtype=np.float32)
    tb = rng.standard_normal((2, 1, 1, cout), dtype=np.float32)
    return p, x_a, x_b, tb, [*weights, _t(tb), *tail]


def _jax_split(x_a, x_b, p, tb, up):
    up_a = jnp.repeat(jnp.repeat(x_a, up, axis=1), up, axis=2)
    return xla_ref.fused_resblock_split(up_a, x_b, p, tb)


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("skip", [True, False])
def test_plain_split_matches_xla(skip, up):
    p, x_a, x_b, tb, params = _split_case(skip, up)
    out = reference.fused_resblock_split(_t(x_a), _t(x_b), *params,
                                         upsample_a=up)
    want = np.asarray(_jax_split(jnp.asarray(x_a), jnp.asarray(x_b), p,
                                 jnp.asarray(tb), up))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    # The op's CPU path is the plain version, which is the one-source
    # block on the materialised concat.
    got = ops.fused_resblock_split(_t(x_a), _t(x_b), *params, upsample_a=up)
    np.testing.assert_array_equal(got.numpy(), out.numpy())
    concat = reference.concat_sources(_t(x_a), _t(x_b), up)
    np.testing.assert_array_equal(
        reference.fused_resblock(concat, *params).numpy(), out.numpy())


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("skip", [True, False])
def test_split_gradients_match_jax(skip, up):
    """Gradients through ``ops.fused_resblock_split`` (the autograd
    Function: both sources, every weight and bias, the time bias) against
    ``jax.grad`` of ``xla_ref.fused_resblock_split`` on the upsampled
    first source."""
    p, x_a, x_b, tb, params = _split_case(skip, up, seed=1)
    cout = params[0].shape[0]
    g = np.random.default_rng(2).standard_normal((2, 8, 12, cout),
                                                 dtype=np.float32)
    ga, gb, gp, gtb = jax.grad(
        lambda a, b, p, tb: jnp.sum(_jax_split(a, b, p, tb, up) * g),
        argnums=(0, 1, 2, 3))(jnp.asarray(x_a), jnp.asarray(x_b), p,
                              jnp.asarray(tb))
    leaves = [_t(x_a).requires_grad_(), _t(x_b).requires_grad_()] + [
        None if a is None else a.requires_grad_() for a in params]
    (ops.fused_resblock_split(*leaves, upsample_a=up) * _t(g)).sum() \
        .backward()
    want = [ga, gb, _oihw(gp["conv1"]["w"]), gp["conv1"]["b"],
            _oihw(gp["conv2"]["w"]), gp["conv2"]["b"], gtb]
    if skip:
        want += [_oihw(gp["skip"]["w"]), gp["skip"]["b"]]
    got = [t for t in leaves if t is not None]
    assert len(got) == len(want)
    for t, w in zip(got, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("split", ["0", "1"])
def test_unet_matches_both_jax_decoders(unet_pair, monkeypatch, split):
    """The port's UNet (rb4 always from two sources) against
    ``unet_apply`` with its decoder concatenating (``TDM_SPLIT_DECODER=0``)
    and split (``=1``)."""
    monkeypatch.setenv("TDM_SPLIT_DECODER", split)
    params, model = unet_pair
    x, t = _images(seed=int(split)), np.array([10, 500], np.int32)
    want = np.asarray(unet_apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(_t(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_unet_cpu_forward_is_the_concatenating_one(unet_pair):
    """On the CPU rb4's plain version builds cat(upsample(h3), h1), so the
    UNet is bit-equal to the forward that concatenates before rb4."""
    _, model = unet_pair
    x = _t(_images(seed=4))
    t = torch.tensor([3, 900])
    with torch.no_grad():
        t_scaled = (t.to(x.dtype) / model.timesteps)[:, None]
        h1 = model.rb1(x, t_scaled)
        b, h, w, c = h1.shape
        pooled = h1.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
        h3 = model.rb3(model.rb2(pooled, t_scaled), t_scaled)
        h4 = model.rb4(reference.concat_sources(h3, h1, 2), t_scaled)
        want = torch.nn.functional.linear(h4, model.out.weight.flatten(1),
                                          model.out.bias)
        got = model(x, t)
    assert torch.equal(got, want)


def _wgmma_layout_bytes(p, cin, cout, dtype):
    """The wgmma kernel's shared memory as ``WideSmem`` in
    csrc/resblock_wgmma.cuh lays it out: 1024 bytes of alignment, the ring
    (stages x planes x nc rows x kc channels), the x tile with its 2-pixel
    halo (every channel, or two buffers of kc), the h tile with its 1-pixel
    halo (every padded Cout channel), rows padded by 16 bytes, and two
    8-byte barriers a stage."""
    size = 4 if dtype == torch.float32 else 2
    step, pad = (8, 4) if dtype == torch.float32 else (16, 8)
    planes = 2 if dtype == torch.float32 else 1
    cin_pad, cout_pad = -(-cin // step) * step, -(-cout // 32) * 32
    x_cols = p.kc if p.x_chunked else cin_pad
    return (1024 + p.stages * planes * p.nc * p.kc * size
            + (2 if p.x_chunked else 1) * (p.tile + 4) ** 2 * (x_cols + pad)
            * size + (p.tile + 2) ** 2 * (cout_pad + pad) * size
            + 2 * 8 * p.stages)


def _check_plan(p, batch, h, w, cin, cout, dtype, sources):
    step = 8 if dtype == torch.float32 else 16
    cin_pad = -(-cin // step) * step
    cout_pad = -(-cout // 32) * 32
    assert p.smem_bytes <= resblock.SMEM_LIMIT == 232_448
    assert p.ctas == batch * -(-h // p.tile) * -(-w // p.tile)
    assert p.waves == -(-p.ctas // 132)
    assert p.sources == sources and p.kc % step == 0
    if p.kernel == "narrow":
        assert cout in (32, 64) and p.nc == cout and p.column_passes == 1
        assert p.kc == max(cin_pad, cout) and not p.x_chunked
        assert p.cluster == 1 and p.stages == 3
        assert p.smem_bytes == resblock.narrow_smem_bytes(
            p.tile, cin_pad, cout, dtype)
        return
    assert p.kernel == "wgmma"
    assert p.nc in (32, 64, 128, 256) and p.nc * p.column_passes == cout_pad
    # A stage holds 128, 64 or 32 bytes of channels, the swizzle's width.
    assert p.kc * (4 if dtype == torch.float32 else 2) in (32, 64, 128)
    assert p.x_chunked == (p.x_chunked and p.kc < cin_pad)
    assert p.cluster in (1, 2, 4) and p.ctas % p.cluster == 0
    assert (p.nc // p.cluster) % 8 == 0
    assert p.m_tiles == -(-(p.tile + 2) ** 2 // 64)
    assert p.m_tiles <= resblock.wgmma_m_tiles(p.nc, dtype)
    assert p.smem_bytes == resblock.wgmma_smem_bytes(
        p.tile, cin_pad, cout_pad, p.kc, p.x_chunked, p.nc, p.stages, dtype)
    assert p.smem_bytes == _wgmma_layout_bytes(p, cin, cout, dtype)


@pytest.mark.parametrize("sources", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_every_width(dtype, sources):
    """Every Cin and Cout of PLAN_WIDTHS has a plan whose shared memory
    fits SMEM_LIMIT and equals its kernel's layout, at the first tile edge
    and at forced ones (where a forced edge fits no plan, ValueError): the
    narrow kernel at Cout 32 and 64 where x fits whole, else the wgmma
    kernel, its k-chunk a multiple of the k step, its columns tiling Cout
    padded to 32, its cluster dividing the grid."""
    for cin in PLAN_WIDTHS:
        for cout in PLAN_WIDTHS:
            plans = [resblock.plan(2, 8, 8, cin, cout, dtype,
                                   sources=sources)]
            for tile in (1, 3, 7, 14):
                try:
                    plans.append(resblock.plan(2, 8, 8, cin, cout, dtype,
                                               sources=sources, tile=tile))
                except ValueError as e:
                    assert tile > 1 and "232448" in str(e), (cin, cout, e)
            for p in plans:
                _check_plan(p, 2, 8, 8, cin, cout, dtype, sources)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_every_square_width_up_to_1024(dtype):
    for c in range(1, 1025):
        assert resblock.plan(1, 28, 28, c, c, dtype).smem_bytes <= 232_448


@pytest.mark.parametrize("b", [1, 3, 25, 99, 100, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_keeps_the_unet_tiles(dtype, b):
    """At the UNet's blocks the plan is the narrow kernel's, as before the
    wgmma kernel: the tile rule's edge (14 from WIDE_TILE_CTAS CTAs, else
    7), all channels in one k-chunk, x whole, one column pass; rb4 from two
    sources the same."""
    for cin, cout, hw in UNET_BLOCKS:
        for sources in (1, 2) if cin == 96 else (1,):
            p = resblock.plan(b, hw, hw, cin, cout, dtype, sources=sources)
            step = 8 if dtype == torch.float32 else 16
            assert p.kernel == "narrow"
            assert p.tile == resblock.tile_for(b, hw, hw)
            assert p.kc == max(-(-cin // step) * step, cout)
            assert not p.x_chunked and p.column_passes == 1
            assert p.nc == cout


@pytest.mark.parametrize("b", [1, 3, 25, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wgmma_plan_takes_the_unet_blocks(dtype, b):
    """``kernel="wgmma"`` plans the UNet's blocks for the wgmma kernel (the
    comparison of the two kernels there), and ``kernel="narrow"`` refuses a
    width that is not the narrow kernel's."""
    for cin, cout, hw in UNET_BLOCKS:
        for sources in (1, 2) if cin == 96 else (1,):
            p = resblock.plan(b, hw, hw, cin, cout, dtype, sources=sources,
                              kernel="wgmma")
            _check_plan(p, b, hw, hw, cin, cout, dtype, sources)
    with pytest.raises(ValueError, match="not a plan of the narrow kernel"):
        resblock.plan(b, 8, 8, 16, 96, dtype, kernel="narrow")


@pytest.mark.parametrize("b, h, cin, cout, tile, ctas", [
    (8, 32, 256, 256, 8, 128), (8, 32, 128, 256, 8, 128), (1, 5, 1, 1, 6, 1),
    (3, 9, 3, 8, 6, 12)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wgmma_plan_of_the_wide_block(dtype, b, h, cin, cout, tile, ctas):
    """The wide blocks take an 8-pixel tile: conv1's 100 rows in two 64-row
    m-tiles, the output's 64 in one, 16 tiles an image and one wave of 128
    CTAs at batch 8. Clusters: CLUSTER CTAs by default; ``cluster=2``
    where the grid is even, else 1; ``cluster=4`` where 4 divides it."""
    p = resblock.plan(b, h, h, cin, cout, dtype)
    assert (p.kernel, p.tile, p.ctas) == ("wgmma", tile, ctas)
    assert p.cluster == resblock.CLUSTER
    _check_plan(p, b, h, h, cin, cout, dtype, 1)
    for cluster in (2, 4):
        q = resblock.plan(b, h, h, cin, cout, dtype, cluster=cluster)
        assert q.cluster == (cluster if ctas % cluster == 0 else 1)
        assert dataclasses.replace(q, cluster=p.cluster) == p
    with pytest.raises(ValueError, match="cluster must be 1, 2 or 4"):
        resblock.plan(b, h, h, cin, cout, dtype, cluster=3)


@pytest.mark.parametrize("cout, cin, k", [(40, 5, 3), (256, 96, 3),
                                          (7, 300, 1)])
def test_kmajor_taps_unpack_to_oihw(cout, cin, k):
    """The wgmma kernel's K-major packing, (k k, Cout_pad, K_pad) with
    zeros past Cout and Cin, unpacks to torch's OIHW weight bit for bit,
    in both dtypes."""
    rng = np.random.default_rng(cout + cin)
    w = torch.from_numpy(rng.standard_normal((cout, cin, k, k),
                                             dtype=np.float32))
    for dtype in DTYPES:
        wd = w.to(dtype)
        cout_pad, k_pad = -(-cout // 32) * 32, -(-cin // 16) * 16
        taps = resblock.kmajor_taps(wd, cout_pad, k_pad)
        assert taps.shape == (k * k, cout_pad, k_pad) and taps.is_contiguous()
        assert taps.dtype == dtype
        back = taps[:, :cout, :cin].reshape(k, k, cout, cin).permute(2, 3, 0, 1)
        assert torch.equal(back, wd)
        assert not taps[:, cout:].any() and not taps[:, :, cin:].any()
        planes = resblock.weight_planes(wd, cout_pad, k_pad)
        if dtype == torch.bfloat16:
            assert planes.shape == (1, *taps.shape)
            assert torch.equal(planes[0], taps)


def test_tf32_planes_of_float32_weights():
    """3xTF32's planes: big is the weight rounded to TF32 (its low 13
    mantissa bits 0, as the card's cvt.rna), small the rest rounded to
    TF32 likewise, and big + small gives the weight back within 2^-21
    relative; zero padding stays zero."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(
        rng.standard_normal((64, 48, 3, 3), dtype=np.float32)
        * np.exp2(rng.integers(-20, 20, (64, 48, 3, 3))).astype(np.float32))
    planes = resblock.weight_planes(w, 64, 48)
    assert planes.shape == (2, 9, 64, 48) and planes.dtype == torch.float32
    big, small = planes
    for plane in planes:
        assert not (plane.view(torch.int32) & 0x1FFF).any()
    taps = resblock.kmajor_taps(w, 64, 48)
    rel = ((big.double() + small.double() - taps.double()).abs()
           / taps.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    # Rounding to nearest: big is never more than half a TF32 step off.
    half_step = taps.abs() * 2.0 ** -11
    assert bool(((big - taps).abs() <= half_step).all())
    padded = resblock.weight_planes(w[:, :40], 64, 48)
    assert not padded[:, :, :, 40:].any()


def test_split_at_a_wide_width_matches_xla():
    """The concat-free block at a wide width, x_a 128 channels at half the
    resolution (upsampled 2x in the gather) and x_b 128 at full, Cout 256
    with a 1x1 skip: the port's ``fused_resblock_split`` (its CPU path, the
    plain version) against ``xla_ref.fused_resblock_split`` on the
    upsampled first source, at the two-source block's 1e-5, and equal to
    the one-source block on the concat."""
    ca, cb, cout = 128, 128, 256
    p, weights, tail = _params(ca + cb, cout, seed=9, skip=True)
    rng = np.random.default_rng(9)
    x_a = rng.standard_normal((1, 4, 4, ca), dtype=np.float32)
    x_b = rng.standard_normal((1, 8, 8, cb), dtype=np.float32)
    tb = rng.standard_normal((1, 1, 1, cout), dtype=np.float32)
    params = [*weights, _t(tb), *tail]
    got = ops.fused_resblock_split(_t(x_a), _t(x_b), *params, upsample_a=2)
    want = np.asarray(_jax_split(jnp.asarray(x_a), jnp.asarray(x_b), p,
                                 jnp.asarray(tb), 2))
    assert got.shape == (1, 8, 8, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    concat = reference.concat_sources(_t(x_a), _t(x_b), 2)
    np.testing.assert_array_equal(
        reference.fused_resblock(concat, *params).numpy(), got.numpy())


@pytest.mark.parametrize("cin, cout, dtype", [
    (8, 8192, torch.float32), (1024, 6144, torch.float32),
    (8, 12288, torch.bfloat16), (2048, 16384, torch.bfloat16)])
def test_plan_refuses_past_the_limit(cin, cout, dtype):
    with pytest.raises(ValueError, match=rf"Cout={cout} .* limit of 232448"):
        resblock.plan(2, 8, 8, cin, cout, dtype)


def test_trace_tool_patches_the_wgmma_kernel(tmp_path, monkeypatch):
    """``resblock_trace`` stamps a copy of the kernel's sources: each of
    its patches applies once to ``resblock_wgmma.cuh``, and each wgmma
    instance file gets its copy of the stamps to the host."""
    from tinydiffusionmodels_torch import resblock_trace

    monkeypatch.setattr(resblock_trace, "OUT", tmp_path)
    dst = resblock_trace.traced_sources()
    header = (dst / "resblock_wgmma.cuh").read_text()
    for _, stamped in resblock_trace.PATCHES:
        assert header.count(stamped) == 1
    files = sorted(dst.glob("fused_resblock_wgmma_*.cu"))
    assert len(files) == 4
    for i, path in enumerate(files):
        assert f"tdm_resblock_trace_{i}(" in path.read_text()
