"""Single-block attention in the torch package against the JAX package's
Pallas pair.

``pallas_kernels._attention_diffable`` (forward ``_attention_kernel``,
backward ``_attention_bwd_kernel``) runs in interpret mode on the CPU, as
``tests/test_ops.py`` runs it; the port's ``ops.single_block_attention`` on
CPU tensors runs its autograd Function with the plain versions
(``reference.single_block_attention`` and ``single_block_attention_bwd``).
Both get the same numpy inputs. Tolerances: the forward f32
``atol = rtol = 1e-5``, bf16 ``1e-2``; the gradients, for a cos(arange)
cotangent, f32 ``1e-4`` (ds = p (dp - D) cancels), bf16 ``2e-2``.

The CUDA kernels run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against the plain versions there.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tinydiffusionmodels_tpu.ops import pallas_kernels  # noqa: E402
from tinydiffusionmodels_torch import ops  # noqa: E402
from tinydiffusionmodels_torch.ops import reference  # noqa: E402
from tinydiffusionmodels_torch.ops import single_block as sb  # noqa: E402

torch.set_num_threads(1)

# (B, H, L, Dh): the shapes of tests/test_ops.py, a ragged L, L 128 at Dh
# 128 (the backward kernel once stopped at L 96 there), and head widths the
# kernels once refused, one in each padded instance below 256 and the
# widest.
SHAPES = {"L64": (2, 4, 64, 64), "L128": (2, 4, 128, 64),
          "L16_dh32": (2, 4, 16, 32), "ragged_L100": (1, 2, 100, 64),
          "dh128": (1, 2, 128, 128), "dh8": (1, 2, 24, 8),
          "dh24": (1, 2, 40, 24), "dh96": (1, 2, 48, 96),
          "dh256": (1, 2, 32, 256)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"f32": 1e-5, "bf16": 1e-2}
GRAD_TOL = {"f32": 1e-4, "bf16": 2e-2}
CASES = [(s, d) for s in sorted(SHAPES) for d in DTYPES]


def _inputs(shape, dtype, seed=0):
    """q, k, v and the cos(arange) cotangent, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    arrays.append(np.cos(np.arange(np.prod(shape), dtype=np.float32))
                  .reshape(shape))
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape, dtype", CASES)
def test_forward_matches_pallas(shape, dtype):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(SHAPES[shape], dtype)
    want = pallas_kernels._attention_diffable(jq, jk, jv)
    got = ops.single_block_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and str(want.dtype) == str(tq.dtype)[6:]
    _close(got, want, FWD_TOL[dtype])


@pytest.mark.parametrize("shape, dtype", CASES)
def test_grads_match_pallas(shape, dtype):
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(SHAPES[shape], dtype)
    want = jax.grad(
        lambda q, k, v: jnp.sum(
            (pallas_kernels._attention_diffable(q, k, v) * jg)
            .astype(jnp.float32)),
        argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    got = torch.autograd.grad(ops.single_block_attention(*leaves), leaves, tg)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        _close(g, w, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_shared_qkv_grad_matches_pallas(dtype):
    """The kernel bench's case: one tensor as q, k and v, the gradient of
    the output's sum (three terms summed)."""
    (jx, _, _, _), (tx, _, _, _) = _inputs((2, 4, 64, 64), dtype, seed=3)
    want = jax.grad(lambda x: jnp.sum(
        pallas_kernels._attention_diffable(x, x, x).astype(jnp.float32)))(jx)
    tx.requires_grad_()
    (got,) = torch.autograd.grad(
        ops.single_block_attention(tx, tx, tx).float().sum(), tx)
    _close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_is_autograd_of_plain_forward_in_f32(shape):
    """In f32 every rounding is a no-op, so the written-out backward is the
    forward's autograd."""
    _, (q, k, v, g) = _inputs(SHAPES[shape], "f32", seed=1)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(reference.single_block_attention(*leaves),
                               leaves, g)
    got = reference.single_block_attention_bwd(q, k, v, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_bf16_pair_differs_from_attention_within_tolerance():
    """In bf16 the TPU pair rounds p to bf16 before P V, and the port's
    ``reference.attention`` does not. At N(0, 1) inputs the outputs differ
    (not bit-equal) but only within the bf16 tolerance of 1e-2, so the
    separate plain version matters for bit-level agreement with the TPU
    kernel, not for the tolerance."""
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs((2, 4, 128, 64), "bf16")
    pair = torch.tensor(np.asarray(
        pallas_kernels._attention_diffable(jq, jk, jv).astype(jnp.float32)))
    plain = reference.attention(tq, tk, tv)[0].float()
    mine = reference.single_block_attention(tq, tk, tv).float()
    assert not torch.equal(pair, plain)
    torch.testing.assert_close(plain, pair, atol=1e-2, rtol=1e-2)
    differ = lambda a: float((a != pair).float().mean())  # noqa: E731
    assert differ(mine) < differ(plain)


def test_cpu_runs_the_plain_version_without_a_launch():
    _, (q, k, v, g) = _inputs((1, 2, 20, 32), "f32")
    before = (sb.launches, sb.bwd_launches)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = ops.single_block_attention(*leaves)
    torch.autograd.grad(out, leaves, g)
    assert (sb.launches, sb.bwd_launches) == before
    torch.testing.assert_close(out, reference.single_block_attention(q, k, v))


def test_other_devices_raise():
    x = torch.zeros(1, 1, 8, 32, device="meta")
    with pytest.raises(NotImplementedError, match="no path for meta"):
        ops.single_block_attention(x, x, x)


# The domain is one for both kernels: L 1 to 128, Dh 1 to 256. The L 129
# case at Dh 128 stands where the backward's old limit (L 96 at Dh 128)
# was checked.
@pytest.mark.parametrize("shape, dtype, match", [
    ((1, 1, 129, 64), torch.float32, "above the kernels' limit of 128"),
    ((1, 1, 64, 257), torch.float32, "Dh=257 is outside the kernels' widths "
                                     "1 to 256"),
    ((1, 1, 129, 128), torch.float32, "above the kernels' limit of 128"),
    ((1, 1, 64, 64), torch.float16, "float32 or bfloat16"),
    ((1, 0, 64, 64), torch.float32, "non-empty"),
])
def test_domain_is_checked_before_a_launch(shape, dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises((TypeError, ValueError), match=match):
        sb._check_cuda_operands(x, x, x)


def test_operands_must_agree():
    x = torch.zeros(1, 1, 16, 32)
    with pytest.raises(ValueError, match="one \\(B, H, L, Dh\\) shape"):
        sb._check_cuda_operands(x, x, x[:, :, :8])
    with pytest.raises(ValueError, match="contiguous in its last dim"):
        y = torch.zeros(1, 1, 32, 16).transpose(-1, -2)
        sb._check_cuda_operands(y, y, y)
