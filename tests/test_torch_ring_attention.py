"""Ring attention of the torch package (``parallel/ring_attention.py``) on
the CPU, where every block runs the flash kernels' plain version.

The ring over a gloo group of 2 and of 4 processes (``ring_attention_shard``,
each rank its shard, the blocks rotated by ``batch_isend_irecv``; spawned as
in ``test_torch_parallel.py``), and the ring of n shards in one process
(``ring_attention``), at causal or not, bidirectional or not, dropout 0 and
0.1: the output, its logsumexp and the q, k and v gradients (an lse
cotangent included) against plain attention over the whole sequence; the
output and gradients against the JAX package's ``ring_attention(...,
block_impl="flash")`` on its 8-device virtual mesh, its Pallas kernels in
interpret mode as its own tests run them, from the same numpy inputs and
the same int32 dropout seed (the one the JAX flash kernel derives from its
key). A data 2 x ring 2 group of 4 against the in-process ring on the same
mesh. Tolerances: forward 1e-5, gradients 1e-4, as
``tests/test_ring_attention.py``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import shared_spawn, worker_main  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
SHAPE = (2, 2, 32, 16)          # B, H, L, Dh
# The JAX ring's dropout key, and the int32 seed its flash kernel draws
# from it (pallas_kernels._pack_scalars), which the port's rings take.
KEY = 1234567
SEED = -1553242029
# (causal, bidirectional, dropout rate)
CONFIGS = [(c, b, r) for c in (False, True) for b in (False, True)
           for r in (0.0, 0.1)]
DP_SP_CONFIGS = [(True, False, 0.1), (False, True, 0.1)]
JAX_CASES = [(2, (True, True, 0.1)), (2, (False, False, 0.0)),
             (4, (True, False, 0.1)), (4, (False, True, 0.1))]


def _cid(config) -> str:
    causal, bidir, rate = config
    return (f"{'causal' if causal else 'full'}-"
            f"{'bidir' if bidir else 'uni'}-p{rate}")


def _inputs(seed: int = 0):
    """q, k, v, the output cotangent and the lse cotangent, from numpy."""
    rng = np.random.default_rng(seed)
    b, h, l, d = SHAPE
    arrays = [rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(4)]
    return (*arrays, rng.standard_normal((b, h, l), dtype=np.float32))


def _grads(torch, fn, q, k, v, g_out, g_lse):
    """(out, lse, dq, dk, dv) of ``fn(q, k, v) -> (out, lse)``, and the
    gradients with the output cotangent alone."""
    q, k, v = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out, lse = fn(q, k, v)
    with_lse = torch.autograd.grad((out, lse), (q, k, v),
                                   (torch.as_tensor(g_out),
                                    torch.as_tensor(g_lse)),
                                   retain_graph=True)
    out_only = torch.autograd.grad(out, (q, k, v), torch.as_tensor(g_out))
    return {"out": out.detach().numpy(), "lse": lse.detach().numpy(),
            **{f"d{n}": g.numpy() for n, g in zip("qkv", with_lse)},
            **{f"d{n}_out": g.numpy() for n, g in zip("qkv", out_only)}}


def _seed(torch):
    return torch.tensor([SEED], dtype=torch.int32)


def _ring_task() -> dict:
    """Every config on this rank's shard of a ring over the whole group,
    and on a data 2 x ring 2 mesh when the group has 4 ranks."""
    import torch

    from tinydiffusionmodels_torch.parallel import (
        make_mesh,
        ring_attention_shard,
        shard_batch,
    )

    q, k, v, g_out, g_lse = _inputs()
    out = {}
    meshes = [("ring", make_mesh({"seq": -1}), CONFIGS)]
    if make_mesh().size == 4:
        meshes.append(("dpsp", make_mesh({"data": 2, "seq": 2}),
                       DP_SP_CONFIGS))
    for name, mesh, configs in meshes:
        def local(x):
            # Rows of dim 0, then positions of dim 2: (B, H, L, ...).
            x = shard_batch(mesh, torch.as_tensor(x)).transpose(1, 2)
            return np.ascontiguousarray(shard_batch(
                mesh, x, axis=None, seq_axis="seq").transpose(1, 2).numpy())

        rows = q.shape[0] // mesh.axis_size("data")
        for causal, bidir, rate in configs:
            res = _grads(torch, lambda a, b, c: ring_attention_shard(
                a, b, c, mesh=mesh, axis="seq", causal=causal,
                bidirectional=bidir, dropout_rate=rate,
                dropout_seed=_seed(torch) if rate else None,
                batch_offset=mesh.index("data") * rows, with_lse=True),
                *(local(x) for x in (q, k, v, g_out, g_lse)))
            key = f"{name}/{_cid((causal, bidir, rate))}"
            out.update({f"{key}/{k_}": v_ for k_, v_ in res.items()})
    return out


TASKS = {"ring": _ring_task}


def _assemble(ranks: list[dict], key: str, dp: int = 1) -> dict:
    """The global arrays from every rank's shard (ranks row-major over
    (data, seq))."""
    sp = len(ranks) // dp
    out = {}
    for name in ranks[0]:
        if not name.startswith(key + "/"):
            continue
        field = name[len(key) + 1:]
        rows = [np.concatenate([ranks[d * sp + s][name] for s in range(sp)],
                               axis=2) for d in range(dp)]
        out[field] = np.concatenate(rows, axis=0)
    return out


@pytest.fixture(scope="module")
def torch_cpu():
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    return torch


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    return {n: shared_spawn(tmp_path_factory, n, "test_torch_ring_attention",
                            "ring") for n in (2, 4)}


def _plain(torch, config) -> dict:
    """Plain attention over the whole sequence and batch: each data shard
    hashes its rows' global batch index, so the ring over any data shards
    drops what one device drops (``dp`` is not needed)."""
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    causal, _, rate = config
    q, k, v, g_out, g_lse = _inputs()

    def fn(q, k, v):
        return fa.flash_attention_with_lse(
            q, k, v, causal=causal, dropout_rate=rate,
            dropout_seed=_seed(torch) if rate else None)

    return _grads(torch, fn, q, k, v, g_out, g_lse)


def _assert_close(got: dict, want: dict, fields=None) -> None:
    for field in fields or want:
        tol = FWD if field in ("out", "lse") else GRAD
        np.testing.assert_allclose(got[field], want[field], **tol,
                                   err_msg=field)


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
@pytest.mark.parametrize("world", [2, 4])
def test_ring_of_processes_equals_full_attention(world, config, rings,
                                                 torch_cpu):
    got = _assemble(rings[world], f"ring/{_cid(config)}")
    _assert_close(got, _plain(torch_cpu, config))


@pytest.mark.parametrize("config", CONFIGS, ids=_cid)
@pytest.mark.parametrize("n", [2, 4])
def test_ring_in_one_process_equals_full_attention(n, config, torch_cpu):
    from tinydiffusionmodels_torch.parallel import ring_attention

    causal, bidir, rate = config
    q, k, v, g_out, g_lse = _inputs()
    got = _grads(torch_cpu, lambda a, b, c: ring_attention(
        a, b, c, seq=n, causal=causal, bidirectional=bidir,
        dropout_rate=rate, dropout_seed=_seed(torch_cpu) if rate else None,
        with_lse=True), q, k, v, g_out, g_lse)
    _assert_close(got, _plain(torch_cpu, config))


@pytest.mark.parametrize("config", DP_SP_CONFIGS, ids=_cid)
def test_data_and_sequence_ring_of_processes(config, rings, torch_cpu):
    """Data 2 x ring 2 on 4 ranks: the in-process ring on the same mesh
    and plain attention over the whole batch (each shard hashes its rows'
    global index)."""
    from tinydiffusionmodels_torch.parallel import ring_attention

    causal, bidir, rate = config
    got = _assemble(rings[4], f"dpsp/{_cid(config)}", dp=2)
    q, k, v, g_out, g_lse = _inputs()
    in_process = _grads(torch_cpu, lambda a, b, c: ring_attention(
        a, b, c, seq=2, data=2, causal=causal, bidirectional=bidir,
        dropout_rate=rate, dropout_seed=_seed(torch_cpu), with_lse=True),
        q, k, v, g_out, g_lse)
    _assert_close(got, in_process)
    _assert_close(got, _plain(torch_cpu, config))


def test_ring_checks(torch_cpu):
    """The JAX package's refusals: a sequence the ring does not divide, a
    batch the data axis does not divide, dropout without a seed, an odd
    shard in a bidirectional ring."""
    from tinydiffusionmodels_torch.parallel import ring_attention

    q = torch_cpu.zeros(3, 1, 12, 8)
    with pytest.raises(ValueError, match="not divisible by ring size"):
        ring_attention(q, q, q, seq=5)
    with pytest.raises(ValueError, match="batch 3"):
        ring_attention(q, q, q, seq=2, data=2)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        ring_attention(q, q, q, seq=2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="even per-device shard"):
        ring_attention(q, q, q, seq=4, bidirectional=True)


@pytest.mark.parametrize("n, config", JAX_CASES,
                         ids=[f"{n}-{_cid(c)}" for n, c in JAX_CASES])
def test_ring_equals_the_jax_flash_ring(n, config, rings, torch_cpu,
                                        eight_devices):
    """The port's ring, of processes and in one process, against the JAX
    package's flash ring over n virtual devices."""
    import jax
    import jax.numpy as jnp

    from tinydiffusionmodels_torch.parallel import ring_attention
    from tinydiffusionmodels_tpu.parallel import make_mesh
    from tinydiffusionmodels_tpu.parallel import (
        ring_attention as jax_ring_attention,
    )

    causal, bidir, rate = config
    q, k, v, g_out, _ = _inputs()
    key = jax.random.PRNGKey(KEY)
    assert int(jax.random.randint(
        key, (1,), minval=jnp.iinfo(jnp.int32).min,
        maxval=jnp.iinfo(jnp.int32).max, dtype=jnp.int32)[0]) == SEED
    mesh = make_mesh({"seq": n}, devices=eight_devices[:n])

    def jax_fn(q, k, v):
        return jax_ring_attention(
            q, k, v, mesh, axis="seq", causal=causal, bidirectional=bidir,
            dropout_rate=rate, dropout_key=key if rate else None,
            block_impl="flash")

    out_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(g_out))
    torch = torch_cpu
    port = _grads(torch, lambda a, b, c: ring_attention(
        a, b, c, seq=n, causal=causal, bidirectional=bidir,
        dropout_rate=rate, dropout_seed=_seed(torch) if rate else None,
        with_lse=True), q, k, v, g_out, np.zeros(SHAPE[:3], np.float32))
    want = {"out": np.asarray(out_j),
            **{f"d{x}_out": np.asarray(g) for x, g in zip("qkv", grads_j)}}
    _assert_close(port, want)
    _assert_close(_assemble(rings[n], f"ring/{_cid(config)}"), want)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("TDM_PLATFORM", "cpu")
    worker_main(TASKS)
