"""The CUDA kernels and their wrappers, on an NVIDIA GPU: flash attention,
the persistent guided-decode kernel and the fused UNet residual block.

Every test here needs a card and ``nvcc``, carries the ``cuda`` marker and
skips on a machine without a GPU. The file imports nothing of jax, so it runs
on a GPU machine that has none; ``tests/conftest.py`` imports jax, so skip it
there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are ``chip_smoke.py``'s: f32 ``atol = rtol = 1e-4`` on O and lse,
``2e-4`` on the gradients (the cancellation in ds = p (dp - D) amplifies the
rounding of the two sums, which the kernel and cuBLAS add in other orders).
The residual block is held to its plain version at f32
``atol = rtol = 1e-4`` with cuDNN's TF32 off. The decode kernel is a bf16
draft: scored by its plain version teacher-forced
on the kernel's tokens, every position's token is within ``DECODE_RTOL`` of
the best score (relative), and rows agree until a first divergence past L/2
on average.
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
from tinydiffusionmodels_torch.sample.guided import guided_generate_verified

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
}


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
    (lambda d: _qkv(1, 1, 8, 8, 48, 48, d), "Dh=48"),
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


def test_dropout_seed_must_be_a_device_int32(cuda):
    q, k, v = _qkv(1, 1, 8, 8, 32, 32, cuda)
    with pytest.raises(ValueError, match="one-element int32 tensor"):
        fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3)


DECODE_RTOL = 1e-2
# name: (B, V, dim, depth, L, normalize, temperature)
DECODE_CASES = {
    "b8_v97_d64": (8, 97, 64, 2, 16, False, 1.0),
    "b13_v500_d256_norm": (13, 500, 256, 2, 32, True, 1.0),
    "b3_v4096_d256_t0.7": (3, 4096, 256, 1, 24, False, 0.7),
}


def _gpt(vocab, dim, depth, max_len, seed, device):
    cfg = TinyGPTConfig(vocab_size=vocab, dim=dim, n_heads=4, depth=depth,
                        max_len=max_len)
    return TinyGPT(cfg, generator=torch.Generator().manual_seed(seed)).to(
        device).eval()


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain(cuda, name):
    b, v, dim, depth, seq_len, norm, temp = DECODE_CASES[name]
    w = dk.pack_weights(_gpt(v, dim, depth, seq_len + 1, 0, cuda))
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
    # dim 128: the verify forward's flash kernels take Dh 32 and up.
    model = _gpt(97, 128, 2, 17, 0, cuda)
    diff = torch.randn(4, 16, 97, device=cuda)
    before = dk.launches
    dk.fused_guided_decode(model, diff, 0, alpha=0.3)
    guided_generate_verified(model, diff, 0, alpha=0.3, draft="fused")
    _, grid = dk._launch(dk.pack_weights(model), diff, 0, alpha=0.3,
                         temperature=1.0, normalize=False)
    assert dk.launches == before + 3 and grid >= 1


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


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_resblock_kernel_matches_plain(cuda, name, b):
    args = _block_args(name, b, cuda)
    out = rb._launch(*args)
    torch.testing.assert_close(out, reference.fused_resblock(*args), **TOL)


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
    (lambda a: [a[0].double(), *a[1:]], TypeError, "takes float32"),
    (lambda a: [a[0], a[1].cpu(), *a[2:]], ValueError, "w1 is on cpu"),
    (lambda a: [a[0], a[1][:, :, :2], *a[2:]], ValueError, "w1 must be"),
    (lambda a: [*a[:6], None, None], ValueError, "identity skip"),
])
def test_resblock_rejects_before_launch(cuda, change, error, match):
    args = change(_block_args("rb2", 1, cuda))
    before = rb.launches
    with pytest.raises(error, match=match):
        rb.fused_resblock(*args)
    assert rb.launches == before
