"""The CUDA flash-attention kernel and its wrapper, on an NVIDIA GPU.

Every test here needs a card and ``nvcc``, carries the ``cuda`` marker and
skips on a machine without a GPU. The file imports nothing of jax, so it runs
on a GPU machine that has none; ``tests/conftest.py`` imports jax, so skip it
there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are ``chip_smoke.py``'s: f32 ``atol = rtol = 1e-4`` on O and lse.
"""

import numpy as np
import pytest
import torch

from tinydiffusionmodels_torch.ops import flash_attention as fa
from tinydiffusionmodels_torch.ops import reference

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py and this file run "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
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
