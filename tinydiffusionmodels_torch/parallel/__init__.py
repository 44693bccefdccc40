"""Data-, sequence- and tensor-parallel training over ``torch.distributed``
(port of ``parallel/``).

One process per GPU, started by ``torchrun``: ``multihost.initialize``
joins the process group (NCCL on the card, gloo on the CPU), a ``Mesh``
names its axes ('data', 'seq', 'model'), each rank trains on its share of
the global batch, and the collectives GSPMD inserts in the JAX package are
written out: one gradient all-reduce a step (``data_parallel``), the ring
of key and value blocks around a sequence axis (``ring_attention``) and
the Megatron column and row splits of the transformer over a 'model' axis
(``tp``; reached by the dry run and the tests only, as in the JAX package).
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
from tinydiffusionmodels_torch.parallel.tp import (
    gather_transformer,
    shard_transformer,
    transformer_tp_rules,
)

__all__ = [
    "Mesh",
    "SequenceSharded",
    "all_reduce_mean",
    "average_gradients",
    "gather_positions",
    "gather_transformer",
    "make_mesh",
    "replicate_tree",
    "ring_attention",
    "ring_attention_shard",
    "shard_batch",
    "shard_stacked_batch",
    "shard_transformer",
    "transformer_tp_rules",
]
