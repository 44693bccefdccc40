"""Hot ops of the port (counterpart of ``ops/registry.py``).

Dispatch is on the tensor's device alone, inside each kernel's wrapper: a
CUDA tensor runs the hand-written kernels (the flash-attention forward, in
training its recompute backward, the persistent guided-decode kernel of
``decode_kernel``, the UNet residual block of ``resblock`` and the
single-block attention pair of ``single_block``), a CPU tensor their plain
PyTorch version. There is no environment knob and no size threshold; the
JAX package's routing rules (score-footprint thresholds between XLA and
flash, the residual block sent to XLA) were TPU measurements and do not
carry over. ``attention`` runs the flash kernels on every model path; the
single-block pair has no route from a model, as in the JAX package, and
runs from the kernel bench (``kernel_bench.py``).
"""

from __future__ import annotations

from tinydiffusionmodels_torch.ops import (
    decode_kernel,
    flash_attention,
    reference,
    resblock,
    single_block,
)
from tinydiffusionmodels_torch.ops.resblock import fused_resblock
from tinydiffusionmodels_torch.ops.single_block import single_block_attention


def attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    layout: str = "bhld",
    dropout_rate: float = 0.0,
    dropout_seed=None,
    seq_axis: str | None = None,
):
    """Attention over (B, H, L, Dh) or, with ``layout='blhd'``,
    (B, L, H, Dh) tensors; returns the output in the same layout.

    ``dropout_rate`` > 0 (training) drops attention weights with the flash
    kernels' coordinate-hash mask, seeded by ``dropout_seed`` (a one-element
    int32 tensor on the operands' device)."""
    if seq_axis is not None:
        raise NotImplementedError(
            "sequence-parallel (ring) attention is not yet ported to the "
            "torch package"
        )
    return flash_attention.flash_attention(
        q, k, v, causal=causal, layout=layout, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
    )


__all__ = ["attention", "decode_kernel", "flash_attention", "fused_resblock",
           "reference", "resblock", "single_block", "single_block_attention"]
