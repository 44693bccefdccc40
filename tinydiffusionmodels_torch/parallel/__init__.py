"""Data- and sequence-parallel training over ``torch.distributed`` (port of
``parallel/``).

One process per GPU, started by ``torchrun``: ``multihost.initialize``
joins the process group (NCCL on the card, gloo on the CPU), a ``Mesh``
names its axes ('data', 'seq'), each rank trains on its share of the
global batch, and the collectives GSPMD inserts in the JAX package are
written out: one gradient all-reduce a step (``data_parallel``) and the
ring of key and value blocks around a sequence axis (``ring_attention``).
Tensor parallelism (the JAX package's ``tp.py``) is not ported.
"""

from tinydiffusionmodels_torch.parallel.data_parallel import (
    all_reduce_mean,
    average_gradients,
)
from tinydiffusionmodels_torch.parallel.mesh import (
    Mesh,
    SequenceSharded,
    gather_positions,
    make_mesh,
    replicate_tree,
    shard_batch,
    shard_stacked_batch,
)
from tinydiffusionmodels_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_shard,
)

__all__ = [
    "Mesh",
    "SequenceSharded",
    "all_reduce_mean",
    "average_gradients",
    "gather_positions",
    "make_mesh",
    "replicate_tree",
    "ring_attention",
    "ring_attention_shard",
    "shard_batch",
    "shard_stacked_batch",
]
