"""Ring attention: sequence-parallel attention on the flash kernels (port of
``parallel/ring_attention.py``).

The sequence is cut into n contiguous shards, one per rank of a ring. Each
rank keeps its query shard and passes its key and value shard around the
ring; at each of the n steps it attends its queries to the block it holds
and merges the block's partial result into a running one through the
block's logsumexp. After n steps every query has seen the whole sequence
and no rank has held more than two shards of keys.

Every block runs ``ops.flash_attention.flash_attention_with_lse`` with the
block's global offsets, ``q_offset = r * L_shard`` and ``k_offset = src *
L_shard``: the CUDA flash kernels on the card, their plain versions on the
CPU, by the wrapper's own dispatch. The merge is the JAX package's
``attend_flash``: the carry starts at float32's lowest value, a block whose
keys all lie in the causal future has an lse near it and weighs 0. The
JAX package's einsum block (its default, ``block_impl="einsum"``) is the
same algebra, so the port has no ``block_impl`` and no ``TDM_RING_BLOCK``;
it has no ``TDM_RING_KV_CHUNK`` either, because the kernels already tile
the keys.

``causal`` masks by global position; ``bidirectional`` splits each key
shard in halves and rotates them in opposite directions, so both links of
a ring carry traffic. Attention-weight dropout hashes the global (query,
key) coordinates in the kernels, so for one seed the ring drops exactly
the weights that single-device attention drops.

The rotation is differentiable: ``_Rotate`` sends each block one step
around the ring (``dist.batch_isend_irecv``) and its backward sends the
gradient one step back, the transpose of the JAX package's ``ppermute``.
Autograd then runs the dq and dk/dv kernels for every block, the lse
cotangent of the merge folded into their D term.

One code path serves two uses. ``ring_attention_shard`` is the per-rank
function (one shard per process, the rotation over the process group);
``ops.attention`` routes to it when a sequence axis is registered.
``ring_attention`` holds every shard of a ring in one process, on global
tensors, and rotates by moving blocks between them: the same block calls,
the same merge, the same offsets, with no process group (the CPU tests and
the card's check, where one GPU cannot hold a NCCL ring of two ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tinydiffusionmodels_torch.ops.flash_attention import (
    flash_attention_with_lse,
)

_LOWEST = torch.finfo(torch.float32).min


class _Rotate(torch.autograd.Function):
    """One step around the ring for each tensor: sent to the rank
    ``shift`` places on, received from the rank ``shift`` places back, all
    in one ``batch_isend_irecv``. The backward sends each gradient the
    other way."""

    @staticmethod
    def forward(ctx, mesh, axis, shifts, *tensors):
        ctx.mesh, ctx.axis, ctx.shifts = mesh, axis, shifts
        return _exchange(mesh, axis, shifts, tensors)

    @staticmethod
    def backward(ctx, *grads):
        back = tuple(-s for s in ctx.shifts)
        return (None, None, None,
                *_exchange(ctx.mesh, ctx.axis, back, grads))


def _exchange(mesh, axis, shifts, tensors):
    group = mesh.groups[axis]
    ops, out = [], []
    for i, (x, s) in enumerate(zip(tensors, shifts)):
        x = x.contiguous()
        recv = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, mesh.peer(axis, s), group,
                              tag=i))
        ops.append(dist.P2POp(dist.irecv, recv, mesh.peer(axis, -s), group,
                              tag=i))
        out.append(recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(out)


def _rotate_shards(blocks: list, shifts: tuple) -> list:
    """The in-process rotation: ``blocks[i]`` lists the tensor of every
    shard; shard j receives the block of shard j - shift."""
    out = []
    for shards, s in zip(blocks, shifts):
        s %= len(shards)
        out.append(shards[-s:] + shards[:-s] if s else list(shards))
    return out


def _ring(qs, ks, vs, *, ranks, n, rotate, causal, bidirectional,
          dropout_rate, seed, batch_offset, layout):
    """The ring over the shards one process holds: ``qs``, ``ks`` and
    ``vs`` list them, ``ranks`` their places on the ring of ``n``, ``seed``
    the dropout seed and ``batch_offset`` their first row in the global
    batch; ``rotate(blocks, shifts)`` moves blocks around the ring.
    Returns the (out, lse) of every shard."""
    ldim = 2 if layout == "bhld" else 1
    l_shard = ks[0].shape[ldim]
    states = [None] * len(qs)

    def attend(j, k_blk, v_blk, k_offset):
        out_b, lse_b = flash_attention_with_lse(
            qs[j], k_blk, v_blk, causal=causal, layout=layout,
            q_offset=ranks[j] * l_shard, k_offset=k_offset,
            dropout_rate=dropout_rate, dropout_seed=seed,
            batch_offset=batch_offset)
        # lse (B, H, L) beside out's rows: (B, H, L, 1) or (B, L, H, 1).
        lse_b = (lse_b if layout == "bhld" else lse_b.transpose(1, 2))[
            ..., None]
        if states[j] is None:
            m = torch.full_like(lse_b, _LOWEST)
            l_acc = torch.zeros_like(lse_b)
            acc = torch.zeros(out_b.shape, dtype=torch.float32,
                              device=out_b.device)
        else:
            m, l_acc, acc = states[j]
        # m only keeps the exponents in range: the result does not depend
        # on it, so it carries no gradient.
        m_new = torch.maximum(m, lse_b).detach()
        corr = torch.exp(m - m_new)
        w_b = torch.exp(lse_b - m_new)
        states[j] = (m_new, corr * l_acc + w_b,
                     corr * acc + w_b * out_b.float())

    if bidirectional:
        if l_shard % 2:
            raise ValueError("bidirectional ring needs an even per-device "
                             "shard")
        half = l_shard // 2
        ka = [k.narrow(ldim, 0, half) for k in ks]
        kb = [k.narrow(ldim, half, half) for k in ks]
        va = [v.narrow(ldim, 0, half) for v in vs]
        vb = [v.narrow(ldim, half, half) for v in vs]
        for i in range(n):
            for j, r in enumerate(ranks):
                # First half of the shard from r - i (forward ring), second
                # half of the one from r + i (backward ring).
                attend(j, ka[j], va[j], ((r - i) % n) * l_shard)
                attend(j, kb[j], vb[j], ((r + i) % n) * l_shard + half)
            if i < n - 1:
                ka, va, kb, vb = rotate([ka, va, kb, vb], (1, 1, -1, -1))
    else:
        kb, vb = list(ks), list(vs)
        for i in range(n):
            for j, r in enumerate(ranks):
                attend(j, kb[j], vb[j], ((r - i) % n) * l_shard)
            if i < n - 1:
                kb, vb = rotate([kb, vb], (1, 1))
    results = []
    for q, (m, l_acc, acc) in zip(qs, states):
        lse = (m + torch.log(l_acc))[..., 0]
        if layout == "blhd":
            lse = lse.transpose(1, 2)
        results.append(((acc / l_acc).to(q.dtype), lse.contiguous()))
    return results


def _check(dropout_rate, dropout_seed):
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")


def ring_attention_shard(q, k, v, *, mesh, axis: str, causal: bool = False,
                         bidirectional: bool = False,
                         dropout_rate: float = 0.0, dropout_seed=None,
                         batch_offset: int = 0, layout: str = "bhld",
                         with_lse: bool = False):
    """Per-rank ring attention over ``mesh``'s ``axis``.

    q, k, v: this rank's sequence shard, (B, H, L_shard, D) or, with
    ``layout='blhd'``, (B, L_shard, H, D). Returns this rank's output (and
    with ``with_lse`` its (B, H, L_shard) float32 logsumexp over the whole
    sequence). ``dropout_seed`` must be the same on every rank of the ring
    (a one-element int32 tensor on the card); ``batch_offset`` is the
    shard's first row in the global batch (a data-parallel rank's), which
    the mask hashes. Without a process group the
    mesh's ring has one rank: one block, no rotation."""
    _check(dropout_rate, dropout_seed)
    n = mesh.axis_size(axis)

    def rotate(blocks, shifts):
        moved = _Rotate.apply(mesh, axis, shifts, *(b[0] for b in blocks))
        return [[x] for x in moved]

    (out, lse), = _ring(
        [q], [k], [v], ranks=[mesh.index(axis)], n=n, rotate=rotate,
        causal=causal, bidirectional=bidirectional,
        dropout_rate=float(dropout_rate), seed=dropout_seed,
        batch_offset=int(batch_offset), layout=layout)
    return (out, lse) if with_lse else out


def ring_attention(q, k, v, *, seq: int, data: int = 1,
                   causal: bool = False, bidirectional: bool = False,
                   dropout_rate: float = 0.0, dropout_seed=None,
                   layout: str = "bhld", with_lse: bool = False):
    """Ring attention over global tensors in one process: the sequence cut
    into ``seq`` shards and the batch into ``data`` shards, each batch
    shard its own ring, as the JAX package's ``ring_attention`` runs on a
    ('data', 'seq') mesh. Each data shard hashes its rows' global batch
    index, so the dropout mask is the one-device mask. Returns the (B, H,
    L, D) output (and its lse) assembled from the shards."""
    _check(dropout_rate, dropout_seed)
    ldim = 2 if layout == "bhld" else 1
    length, batch = q.shape[ldim], q.shape[0]
    if length % seq:
        raise ValueError(f"sequence {length} not divisible by ring size "
                         f"{seq}")
    if batch % data:
        raise ValueError(f"batch {batch} not divisible by 'data' axis size "
                         f"{data}")
    outs, lses = [], []
    for d, (qd, kd, vd) in enumerate(zip(*(x.chunk(data, 0)
                                           for x in (q, k, v)))):
        shards = [list(x.chunk(seq, ldim)) for x in (qd, kd, vd)]
        res = _ring(*shards, ranks=list(range(seq)), n=seq,
                    rotate=_rotate_shards, causal=causal,
                    bidirectional=bidirectional,
                    dropout_rate=float(dropout_rate), seed=dropout_seed,
                    batch_offset=d * (batch // data), layout=layout)
        outs.append(torch.cat([o for o, _ in res], ldim))
        lses.append(torch.cat([s for _, s in res], 2))
    out, lse = torch.cat(outs, 0), torch.cat(lses, 0)
    return (out, lse) if with_lse else out
