"""Hot ops of the port (counterpart of ``ops/registry.py``).

Dispatch is on the tensor's device alone, inside each kernel's wrapper: a
CUDA tensor runs the hand-written kernels (the flash-attention forward, in
training its recompute backward, the persistent guided-decode kernel of
``decode_kernel``, the UNet residual block of ``resblock`` and the
single-block attention pair of ``single_block``, the random draws of
``rng``), a CPU tensor their plain
PyTorch version. There is no environment knob and no size threshold; the
JAX package's routing rules (score-footprint thresholds between XLA and
flash, the residual block sent to XLA) were TPU measurements and do not
carry over. ``attention`` runs the flash kernels on every model path; the
single-block pair has no route from a model, as in the JAX package, and
runs from the kernel bench (``kernel_bench.py``).

Sequence parallelism (counterpart of ``ops/registry.py``'s
``register_sequence_mesh``): a model configured with a sequence axis
(``TransformerConfig.seq_axis``) passes it to ``attention``, which then
runs ring attention (``parallel/ring_attention.py``) over the mesh
registered for that axis, on the flash kernels of every block.
"""

from __future__ import annotations

from tinydiffusionmodels_torch.ops import (
    decode_kernel,
    flash_attention,
    reference,
    resblock,
    rng,
    single_block,
)
from tinydiffusionmodels_torch.ops.resblock import fused_resblock
from tinydiffusionmodels_torch.ops.single_block import single_block_attention


# Sequence axis -> the mesh whose ring it names.
_SEQ_MESHES: dict = {}


def register_sequence_mesh(mesh, axis: str = "seq") -> None:
    """Register ``mesh`` (``parallel.mesh.Mesh``) as the ring of sequence
    axis ``axis``; every rank registers it before its first step."""
    _SEQ_MESHES[axis] = mesh


def sequence_mesh(axis: str):
    """The mesh registered for ``axis``; ValueError when there is none."""
    mesh = _SEQ_MESHES.get(axis)
    if mesh is None:
        raise ValueError(
            f"seq_axis={axis!r} routed to ring attention but no mesh "
            "is registered; call ops.register_sequence_mesh(mesh, axis)"
        )
    return mesh


def sequence_shard(axis: str | None) -> tuple[int, int]:
    """(this rank's place on the ring, the ring's size) of ``axis``; (0, 1)
    for None."""
    if axis is None:
        return 0, 1
    mesh = sequence_mesh(axis)
    return mesh.index(axis), mesh.axis_size(axis)


def attention(
    q,
    k,
    v,
    *,
    mask=None,
    causal: bool = False,
    layout: str = "bhld",
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_key=None,
    seq_axis: str | None = None,
    head_offset: int = 0,
    total_heads: int | None = None,
    batch_offset: int = 0,
):
    """Attention over (B, H, L, Dh) or, with ``layout='blhd'``,
    (B, L, H, Dh) tensors; returns the output in the same layout.

    ``dropout_rate`` > 0 (training) drops attention weights with the flash
    kernels' coordinate-hash mask, seeded by ``dropout_seed`` (a one-element
    int32 tensor on the operands' device).

    ``head_offset`` and ``total_heads``: the operands hold heads
    ``head_offset`` on of a layer's ``total_heads`` (a tensor-parallel
    rank's), and the dropout mask is that slice of the layer's;
    ``batch_offset`` the same for the operands' rows in the global batch
    (a data-parallel rank's).

    ``seq_axis``: the operands are this rank's shard of the sequence, and
    attention is the ring over the mesh registered for that axis (every
    block on the flash kernels; ValueError when none is registered).
    ``mask``: an arbitrary boolean mask goes, as in the JAX package, to
    the plain masked attention (``reference.masked_attention``, the
    counterpart of ``xla_ref.attention``) on either device, its dropout
    drawn from ``dropout_key`` (``core/rng.py``'s ``draw_keep``); the flash
    kernels take ``causal`` or no mask."""
    if seq_axis is not None:
        from tinydiffusionmodels_torch.parallel.ring_attention import (
            ring_attention_shard,
        )

        mesh = sequence_mesh(seq_axis)
        if head_offset or total_heads is not None:
            raise NotImplementedError(
                "ring attention over a slice of the heads (sequence and "
                "tensor parallelism together) is not ported")
        if mask is not None:
            raise NotImplementedError(
                "ring attention supports causal=True or unmasked; arbitrary "
                "masks stay on the single-chip path"
            )
        return ring_attention_shard(
            q, k, v, mesh=mesh, axis=seq_axis, causal=causal, layout=layout,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            batch_offset=batch_offset)
    if mask is not None:
        if head_offset or total_heads is not None or batch_offset:
            raise NotImplementedError(
                "masked attention on a slice of the heads or rows is not "
                "ported")
        return reference.masked_attention(
            q, k, v, mask, layout=layout, dropout_rate=dropout_rate,
            dropout_key=dropout_key)
    return flash_attention.flash_attention(
        q, k, v, causal=causal, layout=layout, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, head_offset=head_offset,
        total_heads=total_heads, batch_offset=batch_offset,
    )


__all__ = ["attention", "decode_kernel", "flash_attention", "fused_resblock",
           "reference", "register_sequence_mesh", "resblock", "rng",
           "sequence_mesh",
           "sequence_shard", "single_block", "single_block_attention"]
