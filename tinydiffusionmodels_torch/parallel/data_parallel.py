"""The data-parallel gradient reduction, written out (port of
``parallel/shard_map_step.py``).

The JAX package has two forms of the same data-parallel step: GSPMD
inserts the gradient all-reduce in the trainers, and ``shard_map_step``
places an explicit ``psum`` over the 'data' axis; its tests hold the two
equal. The port has the explicit form only: after the backward, one
coalesced ``all_reduce`` over every gradient, flattened into one buffer
with the step's losses appended, and a division by the world size, before
AdamW. No DDP and no bucket hooks: the trainers' steps are captured as
CUDA graphs (``train/chunks.py``, ``graphs.Step``) and the collective is
captured with them.

Each rank's loss is the mean over its share of the global batch (its rows
and, on a ring, its positions), and every share has the same size, so the
mean of the ranks' losses is the loss of the global batch and the mean of
their gradients is its gradient. On a sequence ring the backward of the
ring's rotations has already returned to each rank the cotangents of its
keys and values from the other ranks' queries, so the sum over all ranks
is again the whole gradient: one reduction over the world serves data,
sequence and combined meshes. With a tensor-parallel 'model' axis
(``parallel/tp.py``) the ranks of that axis hold different slices of the
split parameters and the same whole gradient of the replicated ones, so
the reduction runs over the 'data' axis's group alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tinydiffusionmodels_torch.parallel.mesh import Mesh


def all_reduce_mean(tensors: list[torch.Tensor], world: int,
                    group=None) -> list[torch.Tensor]:
    """The mean of each tensor (float32, one device) over the ``world``
    ranks of ``group`` (default: the process group), as views of one flat
    buffer that one all-reduce sums: one kernel packs the tensors and one
    divides (none at world 1, where the sum is the tensor)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if world > 1:
        flat.div_(world)
    parts = flat.split([t.numel() for t in tensors])
    return [part.view_as(t) for part, t in zip(parts, tensors)]


def reduction(mesh: Mesh) -> tuple[int, object]:
    """(ranks, group) a step's means run over: the world, or with a
    tensor-parallel 'model' axis the 'data' axis's group."""
    if mesh.axis_size("model") == 1:
        return mesh.size, None
    if mesh.size != mesh.axis_size("model") * mesh.axis_size("data"):
        raise NotImplementedError(
            f"a 'model' axis with axes other than 'data': {dict(mesh.shape)}")
    return mesh.axis_size("data"), mesh.groups.get("data")


def average_gradients(optimizer, losses: torch.Tensor,
                      mesh: Mesh | None) -> None:
    """The step's collective: average every gradient of the optimizer's
    parameters and ``losses`` over the mesh's ranks, with one all-reduce.
    Each gradient becomes a view of the reduced buffer, which AdamW then
    reads (no copy back); ``losses`` is overwritten. Without a process
    group (no torchrun, or no mesh) it launches nothing; with one it runs
    at every world size, 1 included. A parameter without a gradient keeps
    none on every rank alike (the ranks run the same graph)."""
    if mesh is None or not mesh.distributed:
        return
    params = [p for group in optimizer.param_groups
              for p in group["params"] if p.grad is not None]
    *grads, mean = all_reduce_mean([*(p.grad for p in params), losses],
                                   *reduction(mesh))
    for p, g in zip(params, grads):
        p.grad = g
    losses.copy_(mean)
