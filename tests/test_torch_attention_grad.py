"""Training attention of the torch package against the JAX flash kernels.

The port's plain attention (``ops/reference.py``, what the CUDA kernels are
held to on the card) with attention-weight dropout, forward and autograd
backward, against the JAX package's Pallas flash path run as its own tests
run it on the CPU (interpret mode). Both sides use the flash kernels'
coordinate-hash mask stream (``pallas_kernels._dropout_scale``), not the XLA
path's ``draw_keep`` stream: the JAX custom VJPs are called with an explicit
``[seed, q_off, k_off]`` scalar block, so no ``jax.random`` draw sits
between the two, and the same int32 seed goes to the port.

Tolerances are ``tests/test_flash_dropout.py``'s CPU ones: 2e-4 on the
output and the logsumexp, 2e-3 on dq, dk and dv. The mask itself is
compared bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.ops import pallas_kernels  # noqa: E402
from tinydiffusionmodels_torch.ops import flash_attention as fa  # noqa: E402
from tinydiffusionmodels_torch.ops import reference  # noqa: E402

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)

SEEDS = [0, 1, -1, 2**31 - 1, -2**31, 123_456_789, -987_654_321]


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_scale_is_bit_exact(seed, rate):
    q_pos = np.arange(0, 4200, 31, dtype=np.int32)[:, None]
    k_pos = np.arange(0, 3000, 23, dtype=np.int32)[None, :]
    for bh in (0, 1, 7, 31, 1000):
        want = pallas_kernels._dropout_scale(
            jnp.int32(seed), bh, jnp.asarray(q_pos), jnp.asarray(k_pos), rate)
        got = reference.dropout_scale(
            torch.tensor(seed, dtype=torch.int32), bh,
            torch.from_numpy(q_pos), torch.from_numpy(k_pos), rate)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dropout_scale_takes_ints_and_threshold_edges():
    q_pos = torch.arange(64)[:, None]
    k_pos = torch.arange(64)[None, :]
    as_tensor = reference.dropout_scale(torch.tensor([5], dtype=torch.int32),
                                        3, q_pos, k_pos, 0.25)
    as_int = reference.dropout_scale(5, 3, q_pos, k_pos, 0.25)
    torch.testing.assert_close(as_int, as_tensor, rtol=0, atol=0)
    assert reference.dropout_threshold(0.1) == int(0.1 * 2**32)
    assert reference.dropout_threshold(1.0) == 2**32 - 1
    kept = float((as_int > 0).float().mean())
    assert abs(kept - 0.75) < 0.03


# name: (B, H, Lq, Lk, Dh, Dv, causal, layout, q_off, k_off, rate, seed,
#        lse cotangent)
CASES = {
    "ragged_L": (1, 2, 100, 100, 32, 32, False, "bhld", 0, 0, 0.1, 7, False),
    "ragged_L_g_lse": (1, 2, 100, 100, 32, 32, False, "bhld", 0, 0, 0.1,
                       -5, True),
    "causal": (2, 2, 100, 100, 32, 32, True, "bhld", 0, 0, 0.3,
               -2**31, True),
    "causal_offsets": (1, 2, 48, 80, 32, 32, True, "bhld", 40, 0, 0.1,
                       987_654, True),
    "blhd": (2, 2, 64, 64, 64, 64, False, "blhd", 0, 0, 0.1, 11, True),
    "blhd_causal": (1, 4, 70, 70, 32, 32, True, "blhd", 0, 0, 0.1, 3, False),
    "dv_ne_dh": (1, 4, 64, 64, 32, 64, False, "bhld", 0, 0, 0.1, 2**31 - 1,
                 True),
    "no_dropout": (2, 2, 130, 130, 32, 32, False, "bhld", 0, 0, 0.0, 0,
                   True),
    # The text CLI's head widths (one in each padded width of the CUDA
    # kernels) and Dv != Dh.
    "dh8": (1, 2, 70, 70, 8, 8, False, "blhd", 0, 0, 0.1, 8, True),
    "dh12": (1, 2, 70, 70, 12, 12, True, "blhd", 0, 0, 0.1, -12, True),
    "dh16": (1, 2, 70, 70, 16, 16, False, "bhld", 0, 0, 0.1, 16, False),
    "dh24": (1, 2, 70, 70, 24, 24, True, "bhld", 0, 0, 0.1, 24, True),
    "dh96": (1, 2, 70, 70, 96, 96, False, "blhd", 0, 0, 0.1, 96, True),
    "dh12_dv24": (1, 2, 70, 70, 12, 24, True, "bhld", 0, 0, 0.1, 1224,
                  True),
}


def _jax_flash(q, k, v, g_out, g_lse, *, causal, q_off, k_off, rate, seed):
    """Out, lse and (dq, dk, dv) of the Pallas flash path with an explicit
    scalar block; blocks of 32 make every case walk several ragged tiles."""
    sc = jnp.asarray([seed, q_off, k_off], jnp.int32)

    def loss(q, k, v):
        out, lse = pallas_kernels._flash_attention_lse_diffable(
            q, k, v, sc, causal, 32, 32, rate)
        return jnp.sum(out * g_out) + jnp.sum(lse * g_lse), (out, lse)

    grads, (out, lse) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return out, lse, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_training_attention_matches_pallas_flash(name):
    (b, h, lq, lk, dh, dv, causal, layout, q_off, k_off, rate, seed,
     with_g_lse) = CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((b, h, lq, dh), dtype=np.float32)
    k = rng.standard_normal((b, h, lk, dh), dtype=np.float32)
    v = rng.standard_normal((b, h, lk, dv), dtype=np.float32)
    g_out = rng.standard_normal((b, h, lq, dv), dtype=np.float32)
    g_lse = (rng.standard_normal((b, h, lq), dtype=np.float32) if with_g_lse
             else np.zeros((b, h, lq), np.float32))
    out_j, lse_j, grads_j = _jax_flash(
        q, k, v, g_out, g_lse, causal=causal, q_off=q_off, k_off=k_off,
        rate=rate, seed=seed)

    # The port in the case's layout: (B, L, H, D) is the model's.
    to_l = (lambda a: a) if layout == "bhld" else (
        lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    inputs = [torch.from_numpy(to_l(a)).requires_grad_() for a in (q, k, v)]
    out_t, lse_t = fa.flash_attention_with_lse(
        *inputs, causal=causal, layout=layout, q_offset=q_off,
        k_offset=k_off, dropout_rate=rate,
        dropout_seed=torch.tensor([seed], dtype=torch.int32) if rate
        else None)
    grads_t = torch.autograd.grad(
        (out_t, lse_t), inputs,
        (torch.from_numpy(to_l(g_out)), torch.from_numpy(g_lse)))

    np.testing.assert_allclose(out_t.detach().numpy(), to_l(np.asarray(out_j)),
                               **FWD_TOL)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j),
                               **FWD_TOL)
    for what, got, want in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(got.numpy(), to_l(np.asarray(want)),
                                   err_msg=f"d{what}", **GRAD_TOL)


def test_dropout_leaves_the_logsumexp_and_normalizer_alone():
    """Torch semantics: weights are dropped after the softmax, so lse is
    the undropped one and the output is (softmax * mask) @ v."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 32),
                                                    dtype=np.float32))
               for _ in range(3))
    seed = torch.tensor([42], dtype=torch.int32)
    out, lse = reference.attention(q, k, v, dropout_rate=0.2,
                                   dropout_seed=seed)
    out0, lse0 = reference.attention(q, k, v)
    torch.testing.assert_close(lse, lse0, rtol=0, atol=0)
    mask = reference.dropout_scale(seed, torch.arange(2).reshape(1, 2, 1, 1),
                                   torch.arange(40)[:, None],
                                   torch.arange(40)[None, :], 0.2)
    weights = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(32), dim=-1)
    torch.testing.assert_close(out, (weights * mask) @ v, rtol=1e-5,
                               atol=1e-5)
    assert not torch.allclose(out, out0)


def test_dropout_needs_a_seed():
    q = torch.zeros(1, 1, 4, 32)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        fa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        reference.attention(q, q, q, dropout_rate=0.1)
