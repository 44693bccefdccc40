"""Megatron tensor parallelism of the transformer denoiser (port of
``parallel/tp.py``).

The JAX package states the split as PartitionSpecs (``transformer_tp_rules``)
and ``apply_rules`` lays the parameters out, GSPMD inserting the
all-reduces. Here the split is made by hand over the ranks of a 'model'
mesh axis and the collectives are written out:

- column-parallel, split by output features: each layer's fused
  ``in_proj`` (by heads: rank r holds heads ``[r H/tp, (r+1) H/tp)`` of
  each of q, k and v, so its attention is whole heads) and ``linear1``,
  biases with them;
- row-parallel, split by input features: ``out_proj`` (the same heads) and
  ``linear2``; the partial products are summed by one all-reduce over the
  axis, and the bias, held whole on every rank, is added once after it;
- everything else replicated: the norms, ``time_emb``, the position table
  and the self-conditioning projection, and outside the denoiser the
  embedding and the rounding head.

Autograd sees the Megatron pair: ``copy_to_model`` (identity forward,
all-reduce of the gradient backward) on the input of a column-parallel
product, and ``reduce_from_model`` (all-reduce forward, identity backward)
on the output of a row-parallel one. Every replicated parameter then gets
the same whole gradient on every rank of the axis, so the data-parallel
reduction runs over the 'data' axis alone (``data_parallel``).

Randomness matches one device for the same key: every dropout mask is the
rank's part of the whole layer's (the FFN's feature mask drawn at the
rank's columns, ``core/rng.py``'s windows) and the attention kernels hash
the layer's head index (``ops.attention``'s ``head_offset``).

As in the JAX package, no CLI flag reaches this: the dry run
(``python -m tinydiffusionmodels_torch.dryrun``) and the tests do.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from tinydiffusionmodels_torch.parallel.mesh import Mesh


def transformer_tp_rules() -> dict:
    """How each parameter of an encoder layer splits over the 'model'
    axis (the port's names of ``transformer_tp_rules``'s PartitionSpecs):
    'heads' (rows of each of q, k and v by head), 'rows' (output
    features), 'columns' (input features); absent: replicated."""
    return {"self_attn.in_proj_weight": "heads",
            "self_attn.in_proj_bias": "heads",
            "self_attn.out_proj.weight": "columns",
            "linear1.weight": "rows",
            "linear1.bias": "rows",
            "linear2.weight": "columns"}


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """This rank's place on the 'model' axis: its index of ``size`` and
    the axis's process group (None without a process group)."""

    index: int
    size: int
    group: object = None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """The input of a column-parallel product."""
    if split.group is None:
        return x
    return _CopyToModel.apply(x, split.group)


def reduce_from_model(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """The output of a row-parallel product, summed over the axis."""
    if split.group is None:
        return x
    return _ReduceFromModel.apply(x, split.group)


def _split_of(mesh: Mesh, axis: str) -> TensorSplit:
    return TensorSplit(mesh.index(axis), mesh.axis_size(axis),
                       mesh.groups.get(axis) if mesh.distributed else None)


def _part(x: torch.Tensor, kind: str, index: int, size: int,
          heads: int) -> torch.Tensor:
    """This rank's part of a whole parameter."""
    if kind == "heads":            # (3 d[, d]): each of q, k, v by head
        parts = x.reshape(3, heads, -1, *x.shape[1:])
        per = heads // size
        return parts[:, index * per:(index + 1) * per].reshape(
            -1, *x.shape[1:])
    dim = 0 if kind == "rows" else 1
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


def _whole(parts: list, kind: str, heads: int) -> torch.Tensor:
    """A whole parameter from every rank's part, in axis order."""
    if kind == "heads":
        return torch.cat([p.reshape(3, heads // len(parts), -1,
                                    *p.shape[1:]) for p in parts],
                         dim=1).reshape(-1, *parts[0].shape[1:])
    return torch.cat(parts, dim=0 if kind == "rows" else 1)


def _check(model, size: int) -> None:
    cfg = model.cfg
    if cfg.n_heads % size or cfg.ffn_dim % size:
        raise ValueError(f"{cfg.n_heads} heads and FFN width {cfg.ffn_dim} "
                         f"must divide by the 'model' axis size {size}")
    if cfg.seq_axis is not None and size > 1:
        raise NotImplementedError(
            "tensor parallelism with a sequence axis is not ported")


def shard_transformer(model: nn.Module, mesh: Mesh,
                      axis: str = "model") -> nn.Module:
    """Keep this rank's part of every split parameter of ``model`` (a whole
    ``TinyTransformer``, the same on every rank) and route its layers
    through the axis's collectives; in place, returns ``model``. Make the
    optimizer after this. A mesh without ``axis`` (or of size 1 on it)
    leaves the model as it is."""
    size = mesh.axis_size(axis)
    if size == 1:
        return model
    _check(model, size)
    if not mesh.distributed:
        raise ValueError(f"a 'model' axis of {size} needs a process group")
    split = _split_of(mesh, axis)
    rules = transformer_tp_rules()
    with torch.no_grad():
        for layer in model.encoder.layers:
            for name, kind in rules.items():
                owner, attr = _owner(layer, name)
                part = _part(getattr(owner, attr), kind, split.index, size,
                             model.cfg.n_heads)
                setattr(owner, attr, nn.Parameter(part.clone()))
            layer.tp = layer.self_attn.tp = split
    return model


def gather_transformer(model: nn.Module, mesh: Mesh,
                       axis: str = "model") -> nn.Module:
    """The inverse of ``shard_transformer``: every split parameter made
    whole again on every rank (an all-gather over the axis each), in place;
    returns ``model``, which then computes as one device's and saves the
    checkpoint one device saves."""
    size = mesh.axis_size(axis)
    if size == 1:
        return model
    split = _split_of(mesh, axis)
    rules = transformer_tp_rules()
    with torch.no_grad():
        for layer in model.encoder.layers:
            for name, kind in rules.items():
                owner, attr = _owner(layer, name)
                local = getattr(owner, attr).detach().contiguous()
                parts = [torch.empty_like(local) for _ in range(size)]
                dist.all_gather(parts, local, group=split.group)
                setattr(owner, attr, nn.Parameter(
                    _whole(parts, kind, model.cfg.n_heads)))
            layer.tp = layer.self_attn.tp = None
    return model


def _owner(layer: nn.Module, name: str):
    *path, attr = name.split(".")
    owner = layer
    for p in path:
        owner = getattr(owner, p)
    return owner, attr
