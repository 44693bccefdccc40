"""The CUDA kernels and their wrappers, on an NVIDIA GPU: flash attention,
the persistent guided-decode kernel, the fused UNet residual block, the
single-block attention pair and the random draws; and the CUDA graphs that
replay them (the trainers' steps, the guided decoder) against eager runs.

Every test here needs a card and ``nvcc``, carries the ``cuda`` marker and
skips on a machine without a GPU. The file imports nothing of jax, so it runs
on a GPU machine that has none; ``tests/conftest.py`` imports jax, so skip it
there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are ``chip_smoke.py``'s: f32 ``atol = rtol = 1e-4`` on O and lse,
``2e-4`` on the gradients (the cancellation in ds = p (dp - D) amplifies the
rounding of the two sums, which the kernel and cuBLAS add in other orders).
The residual block is held to its plain version at f32
``atol = rtol = 1e-4`` with cuDNN's TF32 off, and in bf16 at ``2e-2`` (both
round h and the output to bf16, the kernel after f32 sums taken in another
order, so a rounding of h may flip by one bf16 step); the single-block pair at f32
``1e-4`` (forward) and ``2e-4`` (gradients), bf16 ``2e-2``, and in bf16
each of its outputs must equal its plain version in more elements than it
equals plain attention or its autograd (the rounding points). The decode
kernel is a bf16 draft: scored by its plain version teacher-forced on the
kernel's tokens, every position's token is within ``DECODE_RTOL`` of
the best score (relative), and rows agree until a first divergence past L/2
on average. The draw kernel (``csrc/rng.cu``) is held to ``core/rng.py``
run on the card: integers and masks bit-equal, normals within 2 ulp.
"""

import numpy as np
import pytest
import torch

from tinydiffusionmodels_torch.models import SimpleUNet, TinyGPT, TinyGPTConfig
from tinydiffusionmodels_torch.models.unet import BLOCKS
from tinydiffusionmodels_torch.ops import decode_kernel as dk
from tinydiffusionmodels_torch.ops import flash_attention as fa
from tinydiffusionmodels_torch.ops import reference
from tinydiffusionmodels_torch.ops import resblock as rb
from tinydiffusionmodels_torch.ops import rng as rng_ops
from tinydiffusionmodels_torch.ops import single_block as sb
from tinydiffusionmodels_torch.sample.guided import guided_generate_verified
from tinydiffusionmodels_torch.core.rng import prng_key, substream

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py and this file run "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, lq, lk, dh, dv, device, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
            device, dtype)
        for s in ((b, h, lq, dh), (b, h, lk, dh), (b, h, lk, dv))
    )


# name: (B, H, Lq, Lk, Dh, Dv, causal, q_offset, k_offset)
CASES = {
    "slice": (8, 4, 64, 64, 64, 64, False, 0, 0),
    "ragged_causal": (2, 4, 100, 100, 64, 64, True, 0, 0),
    # Rows 0-39 see no key (k_offset > q_offset) and Lk is ragged: both
    # versions average V over the Lk keys there.
    "fully_masked_rows": (2, 4, 100, 100, 64, 64, True, 0, 40),
    "lq_ne_lk": (2, 2, 48, 130, 32, 128, False, 0, 0),
    # The grid the kernels split: one 16-row warp per CTA at L 64 and
    # B * H 32 (128 CTAs), four at L 2048.
    "long_L2048": (2, 4, 2048, 2048, 64, 64, False, 0, 0),
    # Widths other than 32, 64, 128: one in each padded instance, and
    # Dv != Dh, narrower and wider, on both sides of 128.
    "dh12_dv24_causal": (2, 4, 100, 100, 12, 24, True, 0, 0),
    "dh160_dv256_causal": (2, 2, 100, 100, 160, 256, True, 0, 0),
    "dh256_dv24": (2, 2, 100, 80, 256, 24, False, 0, 0),
}
# One width in each padded instance (16, 32, 64, 128, 256), the text CLI's at
# --embed_dim 32, 48, 64, 96, 384, 640 and 768, and the widest.
WIDTHS = (8, 12, 16, 24, 96, 160, 192, 256)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(cuda, name):
    b, h, lq, lk, dh, dv, causal, q_off, k_off = CASES[name]
    q, k, v = _qkv(b, h, lq, lk, dh, dv, cuda)
    out, lse = fa.flash_attention_with_lse(
        q, k, v, causal=causal, q_offset=q_off, k_offset=k_off)
    ref_out, ref_lse = reference.attention(
        q, k, v, causal=causal, q_offset=q_off, k_offset=k_off)
    torch.testing.assert_close(out, ref_out, **TOL)
    torch.testing.assert_close(lse, ref_lse, **TOL)


def test_one_launch_counted_per_call(cuda):
    q, k, v = _qkv(1, 1, 8, 8, 32, 32, cuda)
    before = fa.launches
    fa.flash_attention(q, k, v)
    fa.flash_attention(q, k, v, layout="blhd")
    assert fa.launches == before + 2


@pytest.mark.parametrize("make, match", [
    (lambda d: _qkv(1, 1, 8, 8, 32, 32, d, torch.float16), "float32 or bfloat16"),
    (lambda d: tuple(x.transpose(-1, -2) for x in _qkv(1, 1, 32, 32, 32, 32, d)),
     "contiguous in its last dim"),
])
def test_wrapper_rejects_before_launch(cuda, make, match):
    q, k, v = make(cuda)
    before = fa.launches
    with pytest.raises((TypeError, ValueError), match=match):
        fa.flash_attention(q, k, v)
    assert fa.launches == before


# (Dh, Dv) above 256, where the D 256 instances walk the head width in
# chunks of 256 columns: one column past it on either side, the text CLI's
# --embed_dim 2048 (Dh 512) and a ragged last chunk of 8 with Dv != Dh.
WIDE = {"dh257": (257, 257), "dh64_dv257": (64, 257), "dh512": (512, 512),
        "dh264_dv320": (264, 320)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(WIDE))
def test_kernels_match_plain_above_256(cuda, name, dtype):
    """Widths the wrapper once refused: the forward (O, lse) and, with
    dropout and an lse cotangent, dq, dk and dv against the plain version,
    one launch of each kernel. bf16 gradients take chip_smoke.py's
    BF16_LONG_GRAD_TOL (4e-2): the forward rounds each kept weight
    p / (1 - rate) to bf16 before P V, where the TPU kernel does, and D
    takes that output while dP takes the f32 factor, so ds is off by about
    0.0016 |dp|, and |dp| grows as sqrt(Dv); the plain version multiplies
    f32 weights. The f32 case holds the arithmetic to 2e-4."""
    dh, dv = WIDE[name]
    inputs = tuple(x.requires_grad_() for x in _qkv(
        2, 2, 40, 40, dh, dv, cuda, dtype))
    rng = np.random.default_rng(6)
    g_out = torch.from_numpy(rng.standard_normal(
        (2, 2, 40, dv), dtype=np.float32)).to(cuda, dtype)
    g_lse = torch.from_numpy(rng.standard_normal(
        (2, 2, 40), dtype=np.float32)).to(cuda)
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=_seed(cuda))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    results = []
    for fn in (fa.flash_attention_with_lse, reference.attention):
        out, lse = fn(*inputs, **kw)
        results.append((out, lse, torch.autograd.grad(
            (out, lse), inputs, (g_out, g_lse))))
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    (out, lse, grads), (r_out, r_lse, r_grads) = results
    bf = dtype == torch.bfloat16
    tol_o = dict(rtol=2e-2, atol=2e-2) if bf else TOL
    torch.testing.assert_close(out, r_out, **tol_o)
    torch.testing.assert_close(
        lse, r_lse, **(dict(rtol=1e-2, atol=1e-2) if bf else TOL))
    tol_g = dict(rtol=4e-2, atol=4e-2) if bf else GRAD_TOL
    for got, want in zip(grads, r_grads):
        torch.testing.assert_close(got, want, **tol_g)


def _views(b, length, h, d, device, dtype, seed=3):
    """q, k, v as the model passes them: (B, L, H, Dh) views of one fused
    (B, L, 3, H, Dh) projection, never copied."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal(
        (b, length, 3, h, d), dtype=np.float32)).to(device, dtype)
    return qkv, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", WIDTHS)
def test_kernel_matches_plain_at_every_width(cuda, dh, dtype):
    """Forward on the model's strided views at head widths the kernels
    once refused; bf16 Dh 12 rows start on 8 bytes."""
    _, (q, k, v) = _views(8, 64, 4, dh, cuda, dtype)
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, layout="blhd")
    assert fa.launches == before + 1
    ref_out, ref_lse = reference.attention(q, k, v, layout="blhd")
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else TOL
    torch.testing.assert_close(out, ref_out, **tol)
    torch.testing.assert_close(
        lse, ref_lse, **(dict(rtol=1e-2, atol=1e-2)
                         if dtype == torch.bfloat16 else TOL))


def _seed(device, value=-123456789):
    return torch.tensor([value], dtype=torch.int32, device=device)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_plain_autograd(cuda, name, rate):
    """dq, dk and dv of the kernels (with an lse cotangent) against autograd
    of the plain version, the same dropout seed on both."""
    b, h, lq, lk, dh, dv, causal, q_off, k_off = CASES[name]
    inputs = tuple(x.requires_grad_() for x in _qkv(b, h, lq, lk, dh, dv, cuda))
    rng = np.random.default_rng(1)
    g_out = torch.from_numpy(
        rng.standard_normal((b, h, lq, dv), dtype=np.float32)).to(cuda)
    g_lse = torch.from_numpy(
        rng.standard_normal((b, h, lq), dtype=np.float32)).to(cuda)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off,
              dropout_rate=rate, dropout_seed=_seed(cuda) if rate else None)
    grads = []
    for fn in (fa.flash_attention_with_lse, reference.attention):
        out, lse = fn(*inputs, **kw)
        grads.append(torch.autograd.grad((out, lse), inputs, (g_out, g_lse)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_bf16_backward_matches_plain_autograd(cuda):
    """bf16 operands: the kernels accumulate in f32 and round dq, dk, dv to
    bf16; D comes from the bf16-rounded O. Tolerance 2e-2."""
    inputs = tuple(x.requires_grad_() for x in _qkv(
        2, 4, 64, 64, 64, 64, cuda, torch.bfloat16))
    g_out = torch.randn(2, 4, 64, 64, device=cuda).to(torch.bfloat16)
    grads = []
    for fn in (fa.flash_attention, lambda *a, **k: reference.attention(
            *a, **k)[0]):
        out = fn(*inputs, dropout_rate=0.1, dropout_seed=_seed(cuda))
        grads.append(torch.autograd.grad(out, inputs, g_out))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_dq_matches_plain_autograd_at_L2048(cuda):
    """The dq kernel alone at the kernel bench's longest shape, f32 with
    dropout: one launch, within 2e-4 of autograd of the plain version."""
    q, k, v = _qkv(2, 4, 2048, 2048, 64, 64, cuda, seed=5)
    q.requires_grad_()
    g_out = torch.randn(2, 4, 2048, 64, device=cuda)
    kw = dict(dropout_rate=0.1, dropout_seed=_seed(cuda))
    before = fa.dq_launches
    (got,) = torch.autograd.grad(fa.flash_attention(q, k, v, **kw), q, g_out)
    assert fa.dq_launches == before + 1
    (want,) = torch.autograd.grad(reference.attention(q, k, v, **kw)[0], q,
                                  g_out)
    torch.testing.assert_close(got, want, **GRAD_TOL)


def test_backward_launches_each_kernel_once(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(1, 2, 40, 40, 32, 32, cuda))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=_seed(cuda))
    out.sum().backward()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    assert q.grad.shape == q.shape and v.grad.shape == v.shape


def test_strided_views_get_gradients(cuda):
    """The model's operands: (B, L, H, Dh) views of one fused QKV tensor;
    their gradients fill that tensor's gradient as the plain version's do."""
    rng = np.random.default_rng(2)
    base = torch.from_numpy(
        rng.standard_normal((2, 48, 3, 4, 64), dtype=np.float32)).to(cuda)
    g_out = torch.from_numpy(
        rng.standard_normal((2, 48, 4, 64), dtype=np.float32)).to(cuda)
    grads = []
    for fn in (fa.flash_attention, lambda *a, **k: reference.attention(
            *a, **k)[0]):
        qkv = base.clone().requires_grad_()
        out = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], layout="blhd",
                 dropout_rate=0.1, dropout_seed=_seed(cuda))
        (grad,) = torch.autograd.grad(out, qkv, g_out)
        grads.append(grad)
    torch.testing.assert_close(grads[0], grads[1], **GRAD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", WIDTHS)
def test_backward_matches_plain_autograd_at_every_width(cuda, dh, dtype):
    """dq, dk and dv through the fused QKV tensor's gradient, with dropout,
    at the widths the kernels once refused (bf16 Dh 12: 8-byte rows)."""
    base, _ = _views(8, 64, 4, dh, cuda, dtype)
    rng = np.random.default_rng(4)
    g_out = torch.from_numpy(rng.standard_normal(
        (8, 64, 4, dh), dtype=np.float32)).to(cuda, dtype)
    grads = []
    for fn in (fa.flash_attention, lambda *a, **k: reference.attention(
            *a, **k)[0]):
        qkv = base.clone().requires_grad_()
        out = fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], layout="blhd",
                 dropout_rate=0.1, dropout_seed=_seed(cuda))
        (grad,) = torch.autograd.grad(out, qkv, g_out)
        grads.append(grad)
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
           else GRAD_TOL)
    torch.testing.assert_close(grads[0], grads[1], **tol)


def test_unaligned_bf16_views_launch_copy_free(cuda):
    """bf16 heads of width 9 start on 2-byte boundaries: the kernels load
    them without cp.async and give what the plain version gives."""
    base, (q, k, v) = _views(2, 40, 4, 9, cuda, torch.bfloat16)
    assert fa.vector_bytes(q, k, v) == 2
    out = fa.flash_attention(q, k, v, layout="blhd")
    torch.testing.assert_close(
        out, reference.attention(q, k, v, layout="blhd")[0], rtol=2e-2,
        atol=2e-2)


def test_dropout_seed_must_be_a_device_int32(cuda):
    q, k, v = _qkv(1, 1, 8, 8, 32, 32, cuda)
    with pytest.raises(ValueError, match="one-element int32 tensor"):
        fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3)


DECODE_RTOL = 1e-2
# name: (B, V, dim, depth, L, normalize, temperature)
# B 1, 16, 17 and 257 cross the row tiles of the kernel's plan (16 rows a
# unit); D 72 (H 4: Dh 18, F 288) leaves K and the head width off the k32
# chunks and N off the 128-column groups, V 4097 off the n8 blocks; D 30
# (H 2: Dh 15, F 120) takes the kernel's paths for D not a multiple of 4
# and Dh not a multiple of 8; L 300 walks the attention's cache in two
# chunks of scores; D 2304 (H 1) and 2302 (H 2: Dh 1151) stage their rows
# in several K tiles and take a head's output 256 columns a pass, the
# second with D not a multiple of 4. 4 heads unless the name says.
DECODE_CASES = {
    "b8_v97_d64": (8, 97, 64, 2, 16, False, 1.0),
    "b5_v97_d30_h2": (5, 97, 30, 2, 16, False, 1.0),
    "b3_v97_d64_l300": (3, 97, 64, 1, 300, False, 1.0),
    "b13_v500_d256_norm": (13, 500, 256, 2, 32, True, 1.0),
    "b3_v4096_d256_t0.7": (3, 4096, 256, 1, 24, False, 0.7),
    "b1_v97_d64": (1, 97, 64, 2, 16, False, 1.0),
    "b16_v4097_d72": (16, 4097, 72, 2, 24, False, 1.0),
    "b17_v500_d72_norm_t0.7": (17, 500, 72, 2, 24, True, 0.7),
    "b257_v4096_d256": (257, 4096, 256, 1, 16, False, 1.0),
    "b257_v97_d72_norm": (257, 97, 72, 2, 16, True, 1.0),
    "b3_v97_d2304_h1": (3, 97, 2304, 1, 12, False, 1.0),
    "b2_v97_d2302_h2": (2, 97, 2302, 1, 12, False, 1.0),
}


def _gpt(vocab, dim, depth, max_len, seed, device, heads=4):
    cfg = TinyGPTConfig(vocab_size=vocab, dim=dim, n_heads=heads, depth=depth,
                        max_len=max_len)
    return TinyGPT(cfg, key=prng_key(seed)).to(
        device).eval()


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain(cuda, name):
    b, v, dim, depth, seq_len, norm, temp = DECODE_CASES[name]
    heads = int(name.rsplit("_h", 1)[1]) if "_h" in name else 4
    w = dk.pack_weights(_gpt(v, dim, depth, seq_len + 1, 0, cuda, heads))
    rng = np.random.default_rng(1)
    diff = torch.from_numpy(
        rng.standard_normal((b, seq_len, v), dtype=np.float32)).to(cuda)
    kw = dict(alpha=0.3, temperature=temp, normalize=norm)
    tokens = dk.fused_guided_decode(w, diff, 0, **kw)
    ref = reference.fused_guided_decode(w, diff, 0, **kw)
    _, forced = reference.fused_guided_decode(
        w, diff, 0, return_scores=True, forced_tokens=tokens, **kw)
    top = forced.max(-1).values
    gap = top - forced.gather(-1, tokens.long()[..., None])[..., 0]
    assert float((gap / top.abs()).max()) <= DECODE_RTOL
    differ = (tokens != ref).cpu().numpy()
    firsts = [row.argmax() if row.any() else seq_len for row in differ]
    assert np.mean(firsts) > seq_len / 2


def test_decode_launches_once_per_call(cuda):
    model = _gpt(97, 128, 2, 17, 0, cuda)
    diff = torch.randn(4, 16, 97, device=cuda)
    before = dk.launches
    dk.fused_guided_decode(model, diff, 0, alpha=0.3)
    guided_generate_verified(model, diff, 0, alpha=0.3, draft="fused")
    _, grid = dk._launch(dk.pack_weights(model), diff, 0, alpha=0.3,
                         temperature=1.0, normalize=False)
    assert dk.launches == before + 3 and grid >= 1


@pytest.mark.parametrize("b, normalize", [(8, False), (64, True),
                                          (256, False)])
def test_decode_two_launches_identical(cuda, b, normalize):
    """Split-K partials are added in a fixed order, never by float atomics:
    two launches on the same inputs give the same tokens."""
    w = dk.pack_weights(_gpt(4096, 256, 2, 33, 0, cuda))
    rng = np.random.default_rng(2)
    diff = torch.from_numpy(
        rng.standard_normal((b, 32, 4096), dtype=np.float32)).to(cuda)
    kw = dict(alpha=0.3, temperature=1.0, normalize=normalize)
    first = dk.fused_guided_decode(w, diff, 0, **kw)
    assert torch.equal(first, dk.fused_guided_decode(w, diff, 0, **kw))


def test_decode_rejects_before_launch(cuda):
    w = dk.pack_weights(_gpt(97, 64, 2, 17, 0, cuda))
    before = dk.launches
    with pytest.raises(ValueError, match="outside 1..max_len=17"):
        dk.fused_guided_decode(w, torch.randn(2, 18, 97, device=cuda), 0)
    with pytest.raises(ValueError, match="weights on cpu"):
        dk.fused_guided_decode(dk.pack_weights(_gpt(97, 64, 2, 17, 0, "cpu")),
                               torch.randn(2, 4, 97, device=cuda), 0)
    assert dk.launches == before


def _block_args(name, b, device, seed=0):
    """Inputs of UNet block ``name`` at batch ``b``: N(0, 1) activations
    and time bias, weights at torch's init scale."""
    cin, cout = BLOCKS[name]
    hw = 28 if name in ("rb1", "rb4") else 14
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            scale * rng.standard_normal(shape, dtype=np.float32)).to(device)

    args = [r(b, hw, hw, cin), r(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
            r(cout, scale=0.1), r(cout, cout, 3, 3, scale=(9 * cout) ** -0.5),
            r(cout, scale=0.1), r(b, 1, 1, cout)]
    if cin == cout:
        return args + [None, None]
    return args + [r(cout, cin, 1, 1, scale=cin ** -0.5), r(cout, scale=0.1)]


@pytest.mark.parametrize("tile", [7, 14])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_resblock_kernel_matches_plain(cuda, name, b, tile):
    args = _block_args(name, b, cuda)
    out = rb._launch(*args, tile=tile)
    torch.testing.assert_close(out, reference.fused_resblock(*args), **TOL)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_resblock_bf16_matches_plain(cuda, name):
    """bf16 operands: h rounded to bf16 before conv2 and a bf16 output, in
    the kernel and in its plain version."""
    args = [None if a is None else a.to(torch.bfloat16)
            for a in _block_args(name, 2, cuda)]
    before = rb.launches
    out = rb.fused_resblock(*args)
    assert rb.launches == before + 1 and out.dtype == torch.bfloat16
    torch.testing.assert_close(out, reference.fused_resblock(*args),
                               rtol=2e-2, atol=2e-2)


def test_resblock_one_launch_per_call(cuda):
    args = _block_args("rb3", 2, cuda)
    before = rb.launches
    rb.fused_resblock(*args)
    leaves = [None if a is None else a.requires_grad_() for a in args]
    rb.fused_resblock(*leaves).sum().backward()  # backward: no launch
    assert rb.launches == before + 2 and leaves[1].grad is not None
    model = SimpleUNet().to(cuda)
    with torch.no_grad():
        model(torch.zeros(2, 28, 28, 1, device=cuda),
              torch.tensor([1, 2], device=cuda))
    assert rb.launches == before + 6


@pytest.mark.parametrize("change, error, match", [
    (lambda a: [a[0].double(), *a[1:]], TypeError,
     "takes float32 or bfloat16"),
    (lambda a: [a[0], a[1].cpu(), *a[2:]], ValueError, "w1 is on cpu"),
    (lambda a: [a[0], a[1][:, :, :2], *a[2:]], ValueError, "w1 must be"),
    (lambda a: [*a[:6], None, None], ValueError, "identity skip"),
    (lambda a: [a[0].bfloat16(), *a[1:]], TypeError, "one dtype"),
])
def test_resblock_rejects_before_launch(cuda, change, error, match):
    args = change(_block_args("rb2", 1, cuda))
    before = rb.launches
    with pytest.raises(error, match=match):
        rb.fused_resblock(*args)
    assert rb.launches == before


# name: (B, H, L, Dh): the sampler's shape, a ragged L, a narrow L, L 128
# at Dh 128 (the old backward stopped at L 96 there) and widths once
# refused, one in each padded instance below 256 and the widest.
SINGLE_BLOCK_CASES = {"sampler": (8, 4, 64, 64),
                      "ragged_L100": (3, 2, 100, 64),
                      "L16_dh32": (2, 4, 16, 32),
                      "dh128_L96": (2, 2, 96, 128),
                      "dh128_L128": (1, 2, 128, 128),
                      "dh8": (2, 4, 40, 8), "dh24": (2, 2, 64, 24),
                      "dh96": (2, 2, 64, 96), "dh256": (2, 2, 48, 256)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SINGLE_BLOCK_CASES))
def test_single_block_matches_plain(cuda, name, dtype):
    """Both single-block kernels against their plain versions: the forward,
    and dq, dk, dv through the autograd Function for a cos(arange)
    cotangent."""
    b, h, length, dh = SINGLE_BLOCK_CASES[name]
    q, k, v = (x.requires_grad_() for x in _qkv(
        b, h, length, length, dh, dh, cuda, dtype))
    g = torch.cos(torch.arange(q.numel(), device=cuda, dtype=torch.float32)
                  ).reshape(q.shape).to(dtype)
    before = (sb.launches, sb.bwd_launches)
    out = sb.single_block_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    assert (sb.launches, sb.bwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want = reference.single_block_attention(q, k, v)
        want_grads = reference.single_block_attention_bwd(q, k, v, g)
    tol = 2e-2 if dtype == torch.bfloat16 else None
    torch.testing.assert_close(out, want, **(dict(rtol=tol, atol=tol) if tol
                                             else TOL))
    for got, ref in zip(grads, want_grads):
        assert got.dtype == dtype
        torch.testing.assert_close(got, ref, **(dict(rtol=tol, atol=tol)
                                                if tol else GRAD_TOL))
    if dtype == torch.bfloat16:
        # The rounding points: the kernels round p and ds to bf16 where the
        # TPU kernels do, and plain attention (and its autograd) does not,
        # so each output equals its plain version in more elements.
        att = reference.attention(q, k, v)[0]
        auto = torch.autograd.grad(att, (q, k, v), g)
        for got, ref, other in zip((out, *grads), (want, *want_grads),
                                   (att, *auto)):
            assert int((got != ref).sum()) < int((got != other).sum())


def test_single_block_backward_repeats_its_bits(cuda):
    """No float atomics: two backward calls on the same inputs give the
    same bits."""
    q, k, v = _qkv(8, 4, 64, 64, 64, 64, cuda)
    g = torch.cos(torch.arange(q.numel(), device=cuda,
                               dtype=torch.float32)).reshape(q.shape)
    first = sb.backward(q, k, v, g)
    second = sb.backward(q, k, v, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape, grad, match", [
    ((1, 1, 129, 64), False, "limit of 128"),
    ((1, 1, 64, 257), True, "Dh=257"),
])
def test_single_block_rejects_before_launch(cuda, shape, grad, match):
    x = torch.zeros(shape, device=cuda, requires_grad=grad)
    before = (sb.launches, sb.bwd_launches)
    with pytest.raises(ValueError, match=match):
        sb.single_block_attention(x, x, x)
    assert (sb.launches, sb.bwd_launches) == before


def _graph_step_runs(kind, eager, device):
    """Eight steps of a trainer's chunk runner (``text_train.TextSteps``:
    dim 64, depth 2, dropout 0.1, self-conditioning, an EMA; or
    ``mnist_train.MnistSteps`` at batch 16) from fixed seeds, eagerly or
    replayed from its CUDA graph; (losses, every parameter, the flash and
    resblock launches)."""
    import copy

    from torch import nn

    from tinydiffusionmodels_torch.core import make_schedule, rng
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.train import mnist_train, text_train
    from tinydiffusionmodels_torch.train.optim import adamw

    steps, batch = 8, 16 if kind == "mnist" else 4
    sched = make_schedule(device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    order = np.random.default_rng(2).permutation(steps * batch).reshape(
        steps, batch)
    if kind == "mnist":
        model = SimpleUNet(key=substream(prng_key(0), "init")).to(device)
        images = torch.rand((steps * batch, 28, 28, 1), device=device,
                            generator=gen) * 2 - 1
        optimizer = adamw(model.parameters(), 1e-3)
        runner = mnist_train.MnistSteps(
            model, optimizer, images, sched, batch_size=batch, steps=steps,
            key=rng.prng_key(1), eager=eager)
        runner.start(order)
    else:
        cfg = TransformerConfig(dim=64, n_heads=4, depth=2, dropout=0.1,
                                self_cond=True)
        model = nn.ModuleDict({
            "diffusion_model": TinyTransformer(
                cfg, key=substream(prng_key(0), "diffusion")),
            "rounding_fn": LearnedRounding(
                64, 50, key=substream(prng_key(0), "rounding")),
            "embedding_fn": LearnedEmbedding(
                50, 64, key=substream(prng_key(0), "embedding")),
        }).to(device)
        ema = copy.deepcopy(model).requires_grad_(False)
        tokens = torch.randint(0, 50, (steps * batch, 16), device=device,
                               generator=gen)
        optimizer = adamw(model.parameters(), 1e-3)
        runner = text_train.TextSteps(
            model, optimizer, tokens, batch_size=batch, steps=steps,
            key=rng.prng_key(3), ema=ema, ema_decay=0.9, lr_at=lambda s: 1e-3 * min(1.0, (s + 1) / 4),
            eager=eager, sched=sched, use_learned_embeddings=True,
            pretrained_matrix=None)
        runner.start(order, 0.5)
        model = nn.ModuleList([model, ema])
    before = (fa.launches, fa.dq_launches, fa.dkv_launches, rb.launches,
              rng_ops.launches)
    losses = runner.run(steps)
    after = (fa.launches, fa.dq_launches, fa.dkv_launches, rb.launches,
             rng_ops.launches)
    captured = any(s.captured for s in runner.kinds.values())
    return (losses, [p.detach().clone() for p in model.parameters()],
            [a - b for a, b in zip(after, before)], captured)


@pytest.mark.parametrize("kind", ["text", "mnist"])
def test_replayed_steps_equal_eager_steps(cuda, kind):
    """A trainer's step captured as a CUDA graph and replayed gives the
    eager steps' losses and parameters bit for bit, and the launch
    counters count each replay's launches. The MNIST step runs cuDNN's
    deterministic algorithms: its default f32 weight-gradient convolution
    differs from run to run by itself (PERF.md §6)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = _graph_step_runs(kind, True, cuda)
        replayed = _graph_step_runs(kind, False, cuda)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert replayed[3] and not eager[3]
    np.testing.assert_array_equal(replayed[0], eager[0])
    for a, b in zip(replayed[1], eager[1]):
        assert torch.equal(a, b)
    assert replayed[2] == eager[2] and max(eager[2]) > 0


@pytest.mark.parametrize("draft, b", [("plain", 8), ("plain", 96),
                                      ("scan_bf16", 96), ("fused", 8),
                                      ("fused", 96)])
def test_guided_decoder_replays_equal_eager(cuda, draft, b):
    """``GuidedDecoder``'s replayed scan, draft and Jacobi rounds give the
    eager decode's tokens and rounds bit for bit, from the first call on
    and on new logits; a later call launches a scan's L x depth flash
    forwards, depth a round, one decode kernel for the fused draft."""
    from tinydiffusionmodels_torch.sample.guided import GuidedDecoder

    depth, seq_len = 2, 32
    model = _gpt(512, 128, depth, seq_len + 1, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    diffs = [torch.randn(b, seq_len, 512, generator=g, device=cuda)
             for _ in range(2)]
    decoder = GuidedDecoder(model, b, seq_len, 0, alpha=0.3, draft=draft)
    for diff in diffs + diffs[:1]:
        before = (fa.launches, dk.launches)
        tokens, rounds = decoder(diff, return_rounds=True)
        launched = (fa.launches - before[0], dk.launches - before[1])
        want, want_rounds = guided_generate_verified(
            model, diff, 0, alpha=0.3, draft=draft, return_rounds=True)
        assert torch.equal(tokens, want) and rounds == want_rounds
    assert decoder.draft_step.captured
    scan = seq_len * depth if draft != "fused" else 0
    assert launched == (scan + rounds * depth, int(draft == "fused"))


# --- the random draws (csrc/rng.cu) ------------------------------------------

DRAW_WINDOWS = [None, ((2, 3), (0, 16), (0, 24)), ((0, 5), (8, 8), (0, 24)),
                ((0, 5), (0, 16), (12, 12))]


def _ulps(a, b) -> float:
    a, b = a.double(), b.double()
    mag = torch.maximum(a.abs(), b.abs()).float()
    step = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
            - mag).double()
    return float(((a - b).abs() / step).max())


@pytest.mark.parametrize("window", range(len(DRAW_WINDOWS)))
def test_draw_kernel_matches_plain(cuda, window, monkeypatch):
    """Each kind of draw from a key path with a device counter, over the
    whole shape and over rows, positions and columns of it, against
    ``core/rng.py`` on the same device."""
    from tinydiffusionmodels_torch.core import rng

    win, shape = DRAW_WINDOWS[window], (5, 16, 24)
    root = rng.substream(rng.prng_key(11), "train")
    path = rng.substream(rng.KeyPath(root.to(cuda),
                                     torch.tensor([77], device=cuda)), "x")
    host = rng.substream(rng.fold_in(root, 77), "x")
    for kernel, plain in ((rng_ops.normal, rng.normal),
                          (rng_ops.counter_normal, rng.counter_normal)):
        assert _ulps(kernel(path, shape, window=win),
                     plain(host, shape, window=win, device=cuda)) <= 2
    rows = (win[0],) if win else None
    assert torch.equal(
        rng_ops.randint(path, (5,), 0, 1000, window=rows),
        rng.randint(host, (5,), 0, 1000, window=rows, device=cuda).long())
    size = tuple(n for _, n in rng.window_of(shape, win))
    for fast in ("0", "1"):
        monkeypatch.setenv("TDM_FAST_NOISE", fast)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(size, device=cuda).to(dtype)
            keep = rng.draw_keep(host, 0.9, shape, win, device=cuda)
            want = torch.where(keep, x / torch.tensor(
                0.9, dtype=dtype, device=cuda), torch.zeros(
                    (), dtype=dtype, device=cuda))
            got = rng_ops.dropout(x, path, 0.1, shape=shape, window=win)
            assert torch.equal(got, want)


def test_draw_kernel_counts_one_launch_per_draw(cuda):
    from tinydiffusionmodels_torch.core import rng

    key = rng.prng_key(1).to(cuda)
    before = rng_ops.launches
    rng_ops.normal(key, (4, 4))
    rng_ops.attention_seed(key)
    x = torch.ones(8, device=cuda, requires_grad=True)
    rng_ops.dropout(x, key, 0.5).sum().backward()
    assert rng_ops.launches - before == 4


def test_flash_batch_offset_is_the_global_batchs_mask(cuda):
    """Rows 2-3 of a batch of 4 at ``batch_offset`` 2, with dropout,
    against the plain version of the whole batch, sliced (forward and
    gradients)."""
    q, k, v = _qkv(4, 2, 40, 40, 32, 32, cuda, seed=9)
    seed = torch.tensor([123], dtype=torch.int32, device=cuda)
    kw = dict(dropout_rate=0.1, dropout_seed=seed)
    whole = [x.clone().requires_grad_() for x in (q, k, v)]
    r_out, _ = reference.attention(*whole, **kw)
    g = torch.randn_like(r_out)
    r_grads = torch.autograd.grad(r_out, whole, g)
    part = [x[2:].clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*part, batch_offset=2, **kw)
    grads = torch.autograd.grad(out, part, g[2:].contiguous())
    torch.testing.assert_close(out, r_out[2:], **TOL)
    for a, b in zip(grads, r_grads):
        torch.testing.assert_close(a, b[2:], **GRAD_TOL)
