"""The parallel layer (counterpart of ``flaxdiff_tpu/parallel/``): the device
mesh over a ``torch.distributed`` process group, the active-mesh context,
and sequence parallelism (ring and Ulysses attention on the flash kernels).
The train state's FSDP sharding lives in ``trainer/train_state.py``.

One process drives one card (``torchrun --nproc_per_node N``; gloo ranks on
the CPU). Not ported yet (ROADMAP.md A12's second half): the partition
rules with the tensor axis and head-parallel flash (``partition.py``), the
pipeline (``pipeline.py``) and the planner (``planner.py``).
"""
from .collectives import InProcessTransport, ProcessGroupTransport
from .context import (get_active_mesh, get_seq_axis, seq_parallel_active, set_active_mesh,
                      use_mesh)
from .mesh import (MeshAxes, axis_group, axis_rank, axis_size, batch_shard, batch_spec,
                   create_mesh, local_batch_size, mesh_shape_for)
from .ring_attention import (RingAttentionFn, ring_attention_sharded, ring_backward,
                             ring_forward, ring_self_attention)
from .sequence import sequence_region
from .ulysses import ulysses_attention_sharded, ulysses_self_attention

__all__ = [
    "InProcessTransport",
    "MeshAxes",
    "ProcessGroupTransport",
    "RingAttentionFn",
    "axis_group",
    "axis_rank",
    "axis_size",
    "batch_shard",
    "batch_spec",
    "create_mesh",
    "get_active_mesh",
    "get_seq_axis",
    "local_batch_size",
    "mesh_shape_for",
    "ring_attention_sharded",
    "ring_backward",
    "ring_forward",
    "ring_self_attention",
    "seq_parallel_active",
    "sequence_region",
    "set_active_mesh",
    "ulysses_attention_sharded",
    "ulysses_self_attention",
    "use_mesh",
]
