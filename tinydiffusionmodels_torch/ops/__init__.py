"""Hot ops of the port (counterpart of ``ops/registry.py``).

Dispatch is on the tensor's device alone, inside each kernel's wrapper: a
CUDA tensor runs the hand-written kernel, a CPU tensor its plain PyTorch
version. There is no environment knob and no size threshold; the JAX
package's routing rules were TPU measurements and do not carry over.
"""

from __future__ import annotations

from tinydiffusionmodels_torch.ops import flash_attention, reference


def attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    layout: str = "bhld",
    dropout_rate: float = 0.0,
    seq_axis: str | None = None,
):
    """Attention over (B, H, L, Dh) or, with ``layout='blhd'``,
    (B, L, H, Dh) tensors; returns the output in the same layout."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-weight dropout lands with the training port (the "
            "flash backward kernels and the dropout hash); sampling runs at "
            "dropout 0"
        )
    if seq_axis is not None:
        raise NotImplementedError(
            "sequence-parallel (ring) attention is not yet ported to the "
            "torch package"
        )
    return flash_attention.flash_attention(
        q, k, v, causal=causal, layout=layout
    )


__all__ = ["attention", "flash_attention", "reference"]
