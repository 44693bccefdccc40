"""Attention in the torch package against the JAX package's flash kernel.

The port's ``flash_attention_with_lse`` on CPU tensors runs its plain
PyTorch version (``ops/reference.py``); here it is held against
``pallas_kernels.flash_attention_with_lse`` of the JAX package, run in
interpret mode on the CPU as ``tests/test_flash_dropout.py`` runs it, on the
same numpy inputs. Tolerance: f32 ``rtol = atol = 1e-5`` on both the output
and the logsumexp (the TPU kernel scales q before the dot, the plain version
scales the scores after it, so the two differ in the last ulps).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the plain version there.
"""

import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tinydiffusionmodels_tpu.ops import pallas_kernels  # noqa: E402
from tinydiffusionmodels_torch import ops  # noqa: E402
from tinydiffusionmodels_torch.ops import _build  # noqa: E402
from tinydiffusionmodels_torch.ops import flash_attention as fa  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

# name: (B, H, Lq, Lk, Dh, Dv, causal, layout, q_offset, k_offset)
CASES = {
    "ragged_L": (2, 2, 100, 100, 32, 32, False, "bhld", 0, 0),
    "causal": (2, 2, 100, 100, 32, 32, True, "bhld", 0, 0),
    "causal_offsets": (1, 2, 48, 80, 32, 32, True, "bhld", 40, 0),
    "dv_ne_dh": (2, 2, 64, 64, 32, 64, False, "bhld", 0, 0),
    "blhd": (2, 4, 64, 64, 64, 64, False, "blhd", 0, 0),
    # The head widths of the text CLI at --embed_dim 32, 48, 64, 96, 384
    # (4 heads), one in each padded width of the CUDA kernels, and Dv != Dh.
    "dh8": (2, 2, 70, 70, 8, 8, False, "blhd", 0, 0),
    "dh12": (2, 2, 70, 70, 12, 12, True, "blhd", 0, 0),
    "dh16": (2, 2, 70, 70, 16, 16, False, "bhld", 0, 0),
    "dh24": (2, 2, 70, 70, 24, 24, True, "bhld", 0, 0),
    "dh96": (1, 2, 70, 70, 96, 96, False, "blhd", 0, 0),
    "dh12_dv24": (2, 2, 70, 70, 12, 24, True, "bhld", 0, 0),
}


def _inputs(b, h, lq, lk, dh, dv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, dh), dtype=np.float32)
    k = rng.standard_normal((b, h, lk, dh), dtype=np.float32)
    v = rng.standard_normal((b, h, lk, dv), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_flash(name):
    b, h, lq, lk, dh, dv, causal, layout, q_off, k_off = CASES[name]
    q, k, v = _inputs(b, h, lq, lk, dh, dv)
    # Blocks of 32 make every case walk several ragged KV tiles.
    out_j, lse_j = pallas_kernels.flash_attention_with_lse(
        jax.numpy.asarray(q), jax.numpy.asarray(k), jax.numpy.asarray(v),
        causal=causal, q_offset=q_off, k_offset=k_off,
        block_q=32, block_k=32,
    )
    to_layout = (lambda a: a) if layout == "bhld" else (
        lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))
    )
    out_t, lse_t = fa.flash_attention_with_lse(
        *(torch.from_numpy(to_layout(a)) for a in (q, k, v)),
        causal=causal, layout=layout, q_offset=q_off, k_offset=k_off,
    )
    np.testing.assert_allclose(
        out_t.numpy(), to_layout(np.asarray(out_j)), **TOL
    )
    assert lse_t.shape == (b, h, lq)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


def test_ops_attention_blhd_matches_bhld():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 24, 24, 32, 32))
    bhld = ops.attention(q, k, v, layout="bhld")
    blhd = ops.attention(
        *(a.transpose(1, 2) for a in (q, k, v)), layout="blhd"
    )
    np.testing.assert_allclose(
        blhd.transpose(1, 2).numpy(), bhld.numpy(), rtol=0, atol=0
    )


def test_cpu_call_builds_and_counts_nothing():
    """A CPU tensor takes the plain version: no nvcc, no library, no
    launch counted."""
    before = fa.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 32, 32))
    fa.flash_attention(q, k, v)
    assert fa.launches == before
    assert _build._lib is None


def test_import_builds_nothing():
    """Importing the wrappers compiles and loads nothing (the CPU tests
    import every module; the card machine builds at first launch)."""
    code = (
        "import sys\n"
        "import tinydiffusionmodels_torch.ops.flash_attention as fa\n"
        "import tinydiffusionmodels_torch.ops.decode_kernel as dk\n"
        "from tinydiffusionmodels_torch.ops import _build\n"
        "assert _build._lib is None and fa.launches == dk.launches == 0\n"
        "assert 'triton' not in sys.modules\n"
        "print(_build.library_path().name)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("libtdm_kernels-")


def test_vector_bytes_follow_address_and_strides():
    """The widest copy the kernels may make of a row: views of one fused
    (B, L, 3, H, Dh) projection, as the model passes them."""
    def heads(dh, dtype):
        qkv = torch.zeros(2, 8, 3, 4, dh, dtype=dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    assert fa.vector_bytes(torch.zeros(2, 4, 8, 64)) == 16
    assert fa.vector_bytes(*heads(64, torch.bfloat16)) == 16
    assert fa.vector_bytes(*heads(12, torch.float32)) == 16
    # bf16 Dh 12: a head starts every 24 bytes.
    assert fa.vector_bytes(*heads(12, torch.bfloat16)) == 8
    assert fa.vector_bytes(*heads(6, torch.bfloat16)) == 4
    assert fa.vector_bytes(*heads(9, torch.bfloat16)) == 2
    assert fa.vector_bytes(*heads(9, torch.float32)) == 4
    # A dim of length 1 constrains nothing; an offset view does.
    assert fa.vector_bytes(torch.zeros(1, 1, 8, 10)[:, :, :, :8]) == 8
    assert fa.vector_bytes(torch.zeros(2, 1, 8, 64)[..., 1:]) == 4


def test_no_fallback_for_other_devices():
    q = torch.empty(1, 1, 8, 32, device="meta")
    with pytest.raises(NotImplementedError, match="no path for meta"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("kwargs, error, match", [
    # Training-port dropout needs the seed its mask is hashed from.
    pytest.param(dict(dropout_rate=0.1), ValueError, "requires dropout_seed",
                 id="kwargs0-training port"),
    # Ring attention is ported: an axis with no registered mesh raises the
    # JAX package's ValueError (the case keeps the id it had when the ring
    # was not yet ported).
    pytest.param(dict(seq_axis="seq"), ValueError,
                 "no mesh is registered", id="kwargs1-not yet ported"),
])
def test_ops_attention_rejects_unported(kwargs, error, match):
    q = torch.zeros(1, 1, 4, 32)
    with pytest.raises(error, match=match):
        ops.attention(q, q, q, **kwargs)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("fast", ["0", "1"])
def test_masked_attention_with_dropout_matches_xla_ref(layout, fast,
                                                       monkeypatch):
    """``ops.attention(mask=...)``, which the JAX package sends to
    ``xla_ref.attention`` whatever the shape: the port's plain masked
    attention, its weight dropout drawn from the same key by ``draw_keep``
    (``TDM_FAST_NOISE`` 0 and 1), at dropout 0 and 0.1; f32 1e-5."""
    import jax.numpy as jnp

    from tinydiffusionmodels_tpu.ops import xla_ref
    from tinydiffusionmodels_torch.core import rng

    monkeypatch.setenv("TDM_FAST_NOISE", fast)
    q, k, v = _inputs(2, 3, 24, 24, 16, 16, seed=4)
    if layout == "blhd":
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
    mask = np.random.default_rng(5).random((2, 1, 24, 24)) > 0.3
    mask[..., 0] = True
    for rate in (0.0, 0.1):
        want = np.asarray(xla_ref.attention(
            *(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(mask),
            dropout_rate=rate, dropout_key=jax.random.PRNGKey(6),
            layout=layout))
        got = ops.attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            mask=torch.from_numpy(mask), dropout_rate=rate,
            dropout_key=rng.prng_key(6), layout=layout)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
