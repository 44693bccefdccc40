"""Head widths above 128 and bfloat16 residual blocks: the torch package
against the JAX package on the CPU.

On the card the flash kernels take every head width up to 4096 (above
256 the wide forward, dq and dk/dv kernels, which split the width over a
cluster of CTAs) and the fused resblock kernel takes bfloat16. Here their
plain versions, which the kernels are held to on the card, are held to the
JAX package's Pallas kernels run as its own tests run them on the CPU
(interpret mode), on the same numpy inputs:

- flash attention at Dh = Dv = 192 (``--embed_dim 768``, 4 heads), Dh 160
  with Dv 256, Dh = Dv = 512 (``--embed_dim 2048``, the width of the text
  CLI's default Gemma-2B embedding), Dh 264 with Dv 320 (a ragged last
  chunk of 8 columns above 256), two widths that split raggedly over the
  wide kernels' CTAs: Dh = Dv = 1024 (eight CTAs of 128 columns) and Dh
  300 with Dv 520 (five of 112, Dh ending inside the third), and Dh 64
  with Dv 1024 (the first CTA of a cluster alone owns columns of Dh, and
  so of dq), forward (out and logsumexp) within 1e-5 and, with
  attention-weight dropout and an lse cotangent, dq, dk and dv within 1e-4
  (PERF.md's CPU tolerances; the TPU kernel scales q before the dot, the
  plain version the scores after it, and sums in another order);
- the residual block in bfloat16 at the four UNet block shapes, batch 2,
  against ``_fused_resblock_impl`` on bfloat16 inputs and parameters:
  both take float32 sums of the bfloat16 values, round h to bfloat16
  before the second conv and round the output, so they differ where a sum
  taken in another order flips a rounding of h or of the output by one
  bfloat16 step (2^-8 relative): rtol = atol = 1e-2. The float32 blocks
  stay pinned at 2e-4 by ``tests/test_torch_mnist.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.models.torch_init import (  # noqa: E402
    conv_params,
)
from tinydiffusionmodels_tpu.ops import pallas_kernels  # noqa: E402
from tinydiffusionmodels_torch.ops import flash_attention as fa  # noqa: E402
from tinydiffusionmodels_torch.ops import reference, resblock  # noqa: E402

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

# name: (B, H, Lq, Lk, Dh, Dv, causal, layout, q_off, k_off, rate, seed)
CASES = {
    "dh192": (1, 2, 40, 40, 192, 192, False, "blhd", 0, 0, 0.1, 192),
    "dh192_causal": (2, 1, 40, 40, 192, 192, True, "bhld", 0, 0, 0.1, -7),
    "dh160_dv256": (1, 2, 40, 40, 160, 256, False, "bhld", 0, 0, 0.1,
                    160_256),
    "dh160_dv256_causal_offsets": (1, 1, 24, 40, 160, 256, True, "bhld", 20,
                                   0, 0.0, 0),
    "dh512": (1, 2, 40, 40, 512, 512, False, "blhd", 0, 0, 0.1, 512),
    "dh264_dv320_causal": (1, 2, 40, 40, 264, 320, True, "bhld", 0, 0, 0.1,
                           264_320),
    "dh1024_causal": (1, 2, 40, 40, 1024, 1024, True, "blhd", 0, 0, 0.1,
                      1024),
    "dh300_dv520_causal": (1, 2, 40, 40, 300, 520, True, "bhld", 0, 0, 0.1,
                           300_520),
    "dh64_dv1024": (1, 2, 40, 40, 64, 1024, False, "blhd", 0, 0, 0.1,
                    64_1024),
}


def _inputs(b, h, lq, lk, dh, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dv),
                      (b, h, lq, dv), (b, h, lq))]


def _to_layout(layout):
    if layout == "bhld":
        return lambda a: a
    return lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_flash_forward(name):
    b, h, lq, lk, dh, dv, causal, layout, q_off, k_off, _, _ = CASES[name]
    q, k, v, _, _ = _inputs(b, h, lq, lk, dh, dv, len(name))
    out_j, lse_j = pallas_kernels.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, k_offset=k_off, block_q=16, block_k=16)
    to_l = _to_layout(layout)
    out_t, lse_t = fa.flash_attention_with_lse(
        *(torch.from_numpy(to_l(a)) for a in (q, k, v)), causal=causal,
        layout=layout, q_offset=q_off, k_offset=k_off)
    assert out_t.shape[-1] == dv
    np.testing.assert_allclose(out_t.numpy(), to_l(np.asarray(out_j)),
                               **FWD_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **FWD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_gradients_match_pallas_flash(name):
    """dq, dk and dv of the port's plain version (autograd) against the
    Pallas recompute backward, with the flash kernels' coordinate-hash
    dropout and an lse cotangent."""
    b, h, lq, lk, dh, dv, causal, layout, q_off, k_off, rate, seed = (
        CASES[name])
    q, k, v, g_out, g_lse = _inputs(b, h, lq, lk, dh, dv, len(name) + 1)
    sc = jnp.asarray([seed, q_off, k_off], jnp.int32)

    def loss(q, k, v):
        out, lse = pallas_kernels._flash_attention_lse_diffable(
            q, k, v, sc, causal, 16, 16, rate)
        return jnp.sum(out * g_out) + jnp.sum(lse * g_lse)

    grads_j = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    to_l = _to_layout(layout)
    inputs = [torch.from_numpy(to_l(a)).requires_grad_() for a in (q, k, v)]
    out_t, lse_t = fa.flash_attention_with_lse(
        *inputs, causal=causal, layout=layout, q_offset=q_off,
        k_offset=k_off, dropout_rate=rate,
        dropout_seed=torch.tensor([seed], dtype=torch.int32) if rate
        else None)
    grads_t = torch.autograd.grad(
        (out_t, lse_t), inputs,
        (torch.from_numpy(to_l(g_out)), torch.from_numpy(g_lse)))
    for what, got, want in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(got.numpy(), to_l(np.asarray(want)),
                                   err_msg=f"d{what}", **GRAD_TOL)


def test_widths_above_the_kernels_raise_before_a_launch(monkeypatch):
    """Widths above 256, where the kernels once stopped, pass the wrapper's
    check for the card: Dh 257 and Dv 1024 raise nothing, and the check
    still raises on what the kernels do not take (an empty head). The
    check's last step compares the tensor's device with the current CUDA
    device, which this CPU build cannot query: the tensors' index (None)
    stands in for it."""
    assert not hasattr(fa, "MAX_HEAD_DIM")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    wide = torch.zeros(1, 1, 4, 257)
    v = torch.zeros(1, 1, 4, 1024)
    fa._check_cuda_operands(wide, wide, v, "bhld")
    empty = torch.zeros(1, 1, 4, 0)
    with pytest.raises(ValueError, match="non-empty operands"):
        fa._check_cuda_operands(empty, empty, v, "bhld")


class _Library:
    """Stands in for the kernel library: records the entry points called
    and returns cudaSuccess."""

    def __init__(self):
        self.called = []

    def function(self, name, argtypes):
        return lambda *args: self.called.append(name) or 0


# (Dh, Dv): the forward's, the dk/dv kernel's and the dq kernel's entry
# points.
NARROW_ROUTE = ("tdm_flash_attention_fwd", "tdm_flash_attention_bwd_dkv",
                "tdm_flash_attention_bwd_dq")
WIDE_ROUTE = ("tdm_flash_attention_wide_fwd",
              "tdm_flash_attention_wide_bwd_dkv",
              "tdm_flash_attention_wide_bwd_dq")
ROUTES = {(256, 256): NARROW_ROUTE, (24, 256): NARROW_ROUTE,
          (257, 257): WIDE_ROUTE, (257, 8): WIDE_ROUTE,
          (64, 1024): WIDE_ROUTE, (4096, 4096): WIDE_ROUTE}


@pytest.mark.parametrize("dh, dv", sorted(ROUTES))
def test_widths_route_to_their_kernels(monkeypatch, dh, dv):
    """forward, backward_dkv and backward_dq pick the entry point by width
    alone: heads with max(Dh, Dv) above 256 reach the wide kernels, the
    rest the narrow ones, and each launch counts on its own kernel's
    counter. The library and the stream are stand-ins, so the wrappers run
    here on CPU tensors up to the launch."""
    lib = _Library()
    monkeypatch.setattr(fa._build, "function", lib.function)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    q, k = torch.zeros(2, 3, 8, dh), torch.zeros(2, 3, 8, dh)
    v = torch.zeros(2, 3, 8, dv)
    kw = dict(causal=True, layout="bhld", q_offset=0, k_offset=0,
              dropout_rate=0.0, dropout_seed=None)
    names = ("launches", "wide_launches", "dkv_launches", "wide_dkv_launches",
             "dq_launches", "wide_dq_launches")
    before = {n: getattr(fa, n) for n in names}
    out, lse = fa.forward(q, k, v, **kw)
    assert out.shape == (2, 3, 8, dv) and lse.shape == (2, 3, 8)
    delta = torch.zeros(2, 3, 8)
    fa.backward_dkv(q, k, v, out, lse, delta, torch.empty_like(k),
                    torch.empty_like(v), **kw)
    fa.backward_dq(q, k, v, out, lse, delta, torch.empty_like(q), **kw)
    assert lib.called == list(ROUTES[(dh, dv)])
    wide = fa.is_wide(dh, dv)
    assert wide == (max(dh, dv) > 256)
    grew = {n: getattr(fa, n) - before[n] for n in names}
    assert grew == {"launches": int(not wide), "wide_launches": int(wide),
                    "dkv_launches": int(not wide),
                    "wide_dkv_launches": int(wide),
                    "dq_launches": int(not wide),
                    "wide_dq_launches": int(wide)}


@pytest.mark.parametrize("shape_q, shape_v, match", [
    ((1, 1, 4, 4097), (1, 1, 4, 64), "up to 4096"),
    ((1, 1, 4, 300), (1, 1, 4, 5000), "up to 4096"),
    ((1, 1, 4, 0), (1, 1, 4, 520), "non-empty operands"),
    ((1, 1, 4, 520), (1, 2, 4, 520), "batch/head dims differ")])
def test_bad_wide_operands_raise_before_a_launch(monkeypatch, shape_q,
                                                 shape_v, match):
    """The wrapper's check for the card refuses what the wide kernels do not
    take (a head wider than 4096, an empty or mismatched operand) before
    any entry point is called; the check's device comparison stands in as
    in the test above."""
    lib = _Library()
    monkeypatch.setattr(fa._build, "function", lib.function)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    q = torch.zeros(shape_q)
    with pytest.raises(ValueError, match=match):
        fa._check_cuda_operands(q, q, torch.zeros(shape_v), "bhld")
    assert lib.called == []


# (Cin, Cout, H) of rb1..rb4 (models/unet.py:26).
BLOCK_SHAPES = [(1, 32, 28), (32, 64, 14), (64, 64, 14), (96, 32, 28)]


def _bf16_block(cin, cout, hw, seed=0):
    """bf16 JAX params, x and time bias, and the port's argument list of
    the same bf16 values."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    p = {"conv1": conv_params(k1, 3, 3, cin, cout),
         "conv2": conv_params(k2, 3, 3, cout, cout),
         "skip": conv_params(k3, 1, 1, cin, cout) if cin != cout else None}
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, hw, hw, cin), dtype=np.float32),
                    jnp.bfloat16)
    tb = jnp.asarray(rng.standard_normal((2, 1, 1, cout), dtype=np.float32),
                     jnp.bfloat16)

    def t(a, oihw=False):
        a = np.array(a.astype(jnp.float32))
        if oihw:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    args = [t(x), t(p["conv1"]["w"], True), t(p["conv1"]["b"]),
            t(p["conv2"]["w"], True), t(p["conv2"]["b"]), t(tb)]
    args += ([t(p["skip"]["w"], True), t(p["skip"]["b"])] if p["skip"]
             else [None, None])
    return p, x, tb, args


@pytest.mark.parametrize("cin, cout, hw", BLOCK_SHAPES)
def test_plain_bf16_block_matches_pallas(cin, cout, hw):
    p, x, tb, args = _bf16_block(cin, cout, hw)
    want = pallas_kernels._fused_resblock_impl(x, p, tb)
    assert want.dtype == jnp.bfloat16
    out = reference.fused_resblock(*args)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)
    # The wrapper's CPU path is the plain version.
    torch.testing.assert_close(resblock.fused_resblock(*args), out, rtol=0,
                               atol=0)


def test_plain_bf16_block_rounds_h():
    """h is rounded to bf16 before conv2: the bf16 block differs from the
    f32 block of the same bf16 values, and a version that keeps h in f32
    is farther from the Pallas kernel than the plain version is."""
    p, x, tb, args = _bf16_block(64, 64, 14, seed=1)
    want = np.asarray(pallas_kernels._fused_resblock_impl(x, p, tb).astype(
        jnp.float32))
    got = reference.fused_resblock(*args).float().numpy()
    f32 = reference.fused_resblock(
        *[None if a is None else a.float() for a in args])
    unrounded_h = f32.to(torch.bfloat16).float().numpy()
    assert np.abs(got - want).max() < np.abs(unrounded_h - want).max()


def test_resblock_wrapper_takes_one_dtype():
    _, _, _, args = _bf16_block(32, 64, 14)
    mixed = [args[0].float(), *args[1:]]
    with pytest.raises(TypeError, match="one dtype"):
        resblock._check(*mixed)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resblock._check(*[None if a is None else a.half() for a in args])


def _meta_block(cin, cout, hw, dtype):
    """A block's arguments as meta tensors: shapes and dtype, no memory."""
    def t(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    return [t(2, hw, hw, cin), t(cout, cin, 3, 3), t(cout), t(cout, cout, 3, 3),
            t(cout), t(2, 1, 1, cout), t(cout, cin, 1, 1), t(cout)]


@pytest.mark.parametrize("cout, dtype, refused", [
    (48, torch.bfloat16, False), (1, torch.float32, False),
    (1024, torch.float32, False), (1024, torch.bfloat16, False),
    (8192, torch.float32, True), (12288, torch.bfloat16, True)])
def test_resblock_wrapper_rejects_other_widths(cout, dtype, refused):
    """The kernel takes every Cout up to 1024 (and more, while its plan
    fits the card's shared memory); the wrapper's check refuses a width
    past that before a launch, naming the limit."""
    args = _meta_block(32, cout, 14, dtype)
    if not refused:
        plan = resblock._check(*args)
        assert plan.smem_bytes <= resblock.SMEM_LIMIT
        return
    with pytest.raises(ValueError, match=rf"Cout={cout} .* limit of 232448"):
        resblock._check(*args)


@pytest.mark.parametrize("b, hw, tile", [
    (1, 28, 7), (3, 28, 7), (25, 28, 14), (128, 28, 14),
    (1, 14, 7), (25, 14, 7), (99, 14, 7), (100, 14, 14), (128, 14, 14)])
def test_resblock_tile_rule(b, hw, tile):
    """The wrapper's tile edge: 14 where it gives at least WIDE_TILE_CTAS
    CTAs, else 7."""
    assert resblock.tile_for(b, hw, hw) == tile
