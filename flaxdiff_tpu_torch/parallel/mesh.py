"""The device mesh (counterpart of ``flaxdiff_tpu/parallel/mesh.py``).

``create_mesh(axes={"data": 2, "fsdp": 2})`` lays the process group's ranks
out as a ``torch.distributed.device_mesh.DeviceMesh`` with named dims, in
the order the axes are given (the CLI passes data, fsdp, seq, tensor, as the
JAX CLI does). A size of -1 is inferred from the world size, size-1 dims are
kept (a config runs unchanged on fewer ranks), and a size of 0 drops its
dim. One process drives one card (or, on the CPU, one gloo rank), so the
JAX package's devices are the port's ranks.

data: batch parallel; fsdp: the train state sharded (and the batch, with
data); seq: sequence parallel (ring or Ulysses attention); tensor: tensor
parallel (not ported: ROADMAP.md A12's second half).

Not ported: ``local_data_mesh`` (elastic worlds, ROADMAP.md A14's second
half).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
CANONICAL_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, AXIS_SEQ)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """A mesh request; -1 means infer from the world size."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1

    def as_dict(self) -> Dict[str, int]:
        return {AXIS_DATA: self.data, AXIS_FSDP: self.fsdp, AXIS_TENSOR: self.tensor,
                AXIS_SEQ: self.seq}


def _resolve_sizes(axes: Dict[str, int], n_devices: int) -> Dict[str, int]:
    """The dims' sizes with a -1 filled in; raises as the JAX package does."""
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    known = math.prod(v for v in sizes.values() if v != -1)
    if len(unknown) > 1:
        raise ValueError(f"At most one axis may be -1, got {unknown}")
    if unknown:
        if n_devices % known != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {known}")
        sizes[unknown[0]] = n_devices // known
    total = math.prod(sizes.values())
    if total != n_devices:
        raise ValueError(
            f"Mesh axes {sizes} use {total} devices but {n_devices} available")
    return sizes


def create_mesh(axes: Optional[Dict[str, int]] = None, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the initialised process group's ranks, one dim
    per axis (size-0 axes dropped, size-1 axes kept). `device_type`:
    ``"cuda"`` on an NCCL group, ``"cpu"`` on gloo, by default."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if axes is None:
        axes = {AXIS_DATA: -1}
    axes = {k: v for k, v in axes.items() if v != 0}
    sizes = _resolve_sizes(axes, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def mesh_shape_for(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, name: str) -> int:
    """The size of dim `name` (1 when the mesh has no such dim)."""
    return mesh_shape_for(mesh).get(name, 1)


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along dim `name` (0 when there is no such dim)."""
    return mesh.get_local_rank(name) if name in mesh.mesh_dim_names else 0


def axis_group(mesh, name: str):
    """The process group of this rank's line along dim `name`; None when
    the mesh has no such dim (nothing to reduce over)."""
    return mesh.get_group(name) if name in mesh.mesh_dim_names else None


def batch_spec(mesh) -> Tuple[str, ...]:
    """The dims that shard the batch (``batch_spec``'s PartitionSpec entry):
    data and fsdp where present with more than one rank; tensor and seq
    replicate it; ``("data",)`` when neither shards and the mesh has data."""
    shape = mesh_shape_for(mesh)
    dims = tuple(a for a in (AXIS_DATA, AXIS_FSDP) if shape.get(a, 1) > 1)
    if not dims:
        dims = (AXIS_DATA,) if AXIS_DATA in shape else ()
    return dims


def batch_shard(mesh) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of the global batch's rows:
    data x fsdp blocks, data the major one, as the batch's sharding lays the
    rows out. Ranks that differ only in seq or tensor hold the same block."""
    fsdp = axis_size(mesh, AXIS_FSDP)
    return (axis_rank(mesh, AXIS_DATA) * fsdp + axis_rank(mesh, AXIS_FSDP),
            axis_size(mesh, AXIS_DATA) * fsdp)


def local_batch_size(global_batch_size: int, mesh=None) -> int:
    """The rows of the global batch one rank takes: the global batch over
    the mesh's data x fsdp blocks (without a mesh, over the world size)."""
    if mesh is not None:
        blocks = batch_shard(mesh)[1]
    else:
        blocks = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % blocks != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{blocks} processes")
    return global_batch_size // blocks
