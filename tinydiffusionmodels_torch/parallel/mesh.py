"""The process mesh and this rank's share of a batch (port of
``parallel/mesh.py``).

The JAX package lays global arrays over a ``jax.sharding.Mesh`` of
devices; here a ``Mesh`` lays the ranks of the process group (one GPU
each) over named axes, row-major as ``make_mesh`` reshapes the JAX
package's device list, with one ``torch.distributed`` group per line of
ranks along each axis. There is no global array: the batch helpers return
the slice of a global batch that this rank holds, its rows on the
``data`` axis and, on a ``seq`` axis, its token positions.

``make_mesh()`` in a process with no process group is the mesh of one rank
and no groups: every helper is then the identity and no collective runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the ranks of the process group (or of one process).

    ``shape`` maps axis name -> size, ``rank`` is this process's global
    rank, ``coords`` its index on each axis; ``groups`` holds, per axis, the
    process group of the ranks that share this rank's other coordinates
    (None without a process group), and ``lines`` their global ranks in
    axis order."""

    shape: dict
    rank: int = 0
    coords: dict = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    lines: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans a process group (collectives run)."""
        return dist.is_initialized() and bool(self.groups)

    def axis_size(self, axis: str | None) -> int:
        return int(self.shape.get(axis, 1)) if axis is not None else 1

    def index(self, axis: str | None) -> int:
        return int(self.coords.get(axis, 0)) if axis is not None else 0

    def peer(self, axis: str, shift: int) -> int:
        """The global rank ``shift`` places along ``axis`` from this one,
        around the ring."""
        line = self.lines[axis]
        return line[(self.index(axis) + shift) % len(line)]


def make_mesh(axes: dict[str, int] | None = None, *,
              world: int | None = None) -> Mesh:
    """A Mesh; default: every rank on the 'data' axis.

    ``axes`` maps axis name -> size, e.g. {'data': 2, 'seq': 2}. A size of
    -1 means "whatever is left" (at most one axis). The sizes must multiply
    to the world size: the process group's, else ``world`` (default 1),
    which lays out a mesh without groups (the rules alone). With a process
    group every rank must call this, in the same order: it creates the
    groups of every axis."""
    group_world = dist.get_world_size() if dist.is_initialized() else None
    if world is None:
        world = group_world or 1
    elif group_world is not None and world != group_world:
        raise ValueError(f"world {world} != the process group's "
                         f"{group_world}")
    if axes is None:
        axes = {"data": world}
    names = tuple(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if world % known:
            raise ValueError(f"{world} devices not divisible by {known}")
        sizes[sizes.index(-1)] = world // known
    total = int(np.prod(sizes))
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {world} devices")
    shape = dict(zip(names, sizes))
    if group_world is None:
        return Mesh(shape, coords=dict.fromkeys(names, 0),
                    lines={n: [0] for n in names})
    rank = dist.get_rank()
    grid = np.arange(world).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    groups, lines = {}, {}
    for a, name in enumerate(names):
        # Every line of ranks along this axis, in a fixed order.
        for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]):
            line = [int(r) for r in line]
            group = dist.new_group(line)
            if rank in line:
                groups[name], lines[name] = group, line
    return Mesh(shape, rank=rank, coords=coords, groups=groups, lines=lines)


def _take(x: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    if parts == 1:
        return x
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of length {n} not divisible by "
                         f"{parts} ranks")
    return x.narrow(dim, index * (n // parts), n // parts)


def shard_batch(mesh: Mesh, batch, axis: str = "data",
                seq_axis: str | None = None, *, batch_dim: int = 0):
    """This rank's part of each tensor of ``batch`` (a tensor, or a tuple
    or list of them): its rows of dim ``batch_dim`` on ``axis`` and, with
    ``seq_axis``, its positions of dim ``batch_dim + 1`` (the sequence dim
    of (B, L, ...) token and noise tensors) on that axis; 1-D tensors (the
    timesteps) are split by rows alone. Axes absent from the mesh are
    skipped, so the same call works on a pure ('seq',) mesh. A view, no
    copy."""
    def take(x):
        x = _take(x, batch_dim, mesh.index(axis), mesh.axis_size(axis))
        if seq_axis is not None and x.dim() > batch_dim + 1:
            x = _take(x, batch_dim + 1, mesh.index(seq_axis),
                      mesh.axis_size(seq_axis))
        return x

    if isinstance(batch, (tuple, list)):
        return type(batch)(take(x) for x in batch)
    return take(batch)


def shard_stacked_batch(mesh: Mesh, batch, axis: str = "data",
                        seq_axis: str | None = None):
    """``shard_batch`` of (K, B, ...) stacks: dim 1 (batch) on ``axis`` and,
    with ``seq_axis``, dim 2 (the sequence of (K, B, L) token stacks)."""
    return shard_batch(mesh, batch, axis, seq_axis, batch_dim=1)


def replicate_tree(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Check that every rank of the mesh holds the same parameters and
    buffers as rank 0 (each rank initialises them from the same seed), in
    one broadcast; raises ValueError on a rank that differs. Returns
    ``module``. Without a process group it does nothing."""
    if not mesh.distributed:
        return module
    tensors = [t for t in (*module.parameters(), *module.buffers())
               if t.is_floating_point()]
    if not tensors:
        return module
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        same = torch.tensor([float(torch.equal(flat, ref))],
                            device=flat.device)
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if same.item() != 1.0:
        raise ValueError(
            "the ranks start from different weights; initialise every rank "
            "from the same --seed")
    return module


def gather_positions(mesh: Mesh, x: torch.Tensor, seq_axis: str,
                     dim: int = 1) -> torch.Tensor:
    """The whole sequence from every rank's positions of ``x`` along
    ``dim`` (an all-gather over the ``seq_axis`` ring), outside autograd."""
    n = mesh.axis_size(seq_axis)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.groups[seq_axis])
    return torch.cat(parts, dim=dim)


class SequenceSharded(nn.Module):
    """A denoiser with ``cfg.seq_axis`` set, called on whole sequences:
    each rank runs ``model`` on its positions of ``x`` (and ``x0_prev``),
    attention through the ring, and the output is gathered back along the
    sequence. This is how the samplers run a sequence-parallel model: every
    rank of the ring samples the same global batch."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        super().__init__()
        self.model = model
        self.mesh = mesh
        self.cfg = model.cfg

    def forward(self, x, t, *, x0_prev=None, **kw):
        axis = self.cfg.seq_axis
        local = shard_batch(self.mesh, (x,) if x0_prev is None
                            else (x, x0_prev), axis=None, seq_axis=axis)
        out = self.model(local[0], t, x0_prev=(local[1] if len(local) > 1
                                               else None), **kw)
        return gather_positions(self.mesh, out, axis)
