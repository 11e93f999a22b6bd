"""The collectives the parallel layer issues, each over one process group.

Every call checks that its tensors live where the group's backend works:
CUDA tensors on an NCCL group, CPU tensors on a gloo group. Gloo would take
a CUDA tensor and stage it through the host; here that raises, so a run
never moves its data through a device it did not ask for. No collective is
skipped on a group of one rank: a one-rank NCCL group still runs NCCL on the
card. Collectives are issued on the current stream's order (the call
returns once the group's stream has been joined to it), so the fit loop's
events keep their meaning.

The gather and reduce-scatter over one flat tensor are spelled
``all_gather_single`` / ``reduce_scatter_single`` where torch has them and
``all_gather_into_tensor`` / ``reduce_scatter_tensor`` before that (newer
torch deprecates the older names).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def check_device(group, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lives where `group`'s backend works."""
    backend = dist.get_backend(group)
    for t in tensors:
        if backend == "gloo" and t.is_cuda:
            raise RuntimeError("a CUDA tensor on a gloo process group: gloo would stage it "
                               "through the host; use an NCCL group for CUDA tensors")
        if backend == "nccl" and not t.is_cuda:
            raise RuntimeError(f"a {t.device} tensor on an NCCL process group: NCCL takes "
                               "CUDA tensors only")


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `t` in place over `group` and return it."""
    check_device(group, t)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """Fill `out` with the group's equal-sized `inp` along dim 0, in rank order."""
    check_device(group, out, inp)
    _all_gather(out, inp.contiguous(), group=group)
    return out


def all_gather_flat(inp: torch.Tensor, group) -> torch.Tensor:
    """The group's equal-sized tensors concatenated along dim 0, in rank order."""
    inp = inp.contiguous()
    out = torch.empty((dist.get_world_size(group) * inp.shape[0], *inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    return all_gather_into(out, inp, group)


def reduce_scatter_flat(inp: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of its ranks' `inp`, this rank's equal slice of
    dim 0."""
    n = dist.get_world_size(group)
    inp = inp.contiguous()
    out = torch.empty((inp.shape[0] // n, *inp.shape[1:]), dtype=inp.dtype, device=inp.device)
    check_device(group, inp)
    _reduce_scatter(out, inp, group=group)
    return out


def all_to_all_flat(inp: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j; chunk j of the result came from rank j."""
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    check_device(group, inp)
    dist.all_to_all_single(out, inp, group=group)
    return out


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's equal-sized `t` concatenated along `dim`, in rank order."""
    return all_gather_flat(t.movedim(dim, 0), group).movedim(0, dim)


class ProcessGroupTransport:
    """The ring's rotation over a process group: each rank sends its
    tensors to the next rank of the group and takes the previous rank's,
    with one ``batch_isend_irecv``. A rank holds one shard."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def start(self, shards: Sequence[Sequence[torch.Tensor]]):
        """Post the rotation of each tensor of this rank's one shard;
        ``finish`` returns the received ones."""
        (tensors,) = shards
        sent = [t.contiguous() for t in tensors]
        check_device(self.group, *sent)
        recv = [torch.empty_like(t) for t in sent]
        ops = []
        for t, r in zip(sent, recv):
            ops.append(dist.P2POp(dist.isend, t, self._next, group=self.group))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, group=self.group))
        # the sent tensors stay referenced until the rotation is finished
        return dist.batch_isend_irecv(ops), sent, recv

    @staticmethod
    def finish(pending):
        works, _, recv = pending
        for w in works:
            w.wait()
        return [recv]


class InProcessTransport:
    """The ring's rotation within one process that holds all `size` shards:
    shard i takes shard i - 1's tensors. It drives the ring's hop loop on one
    card (``chip_smoke.py``) with the same body a process group runs."""

    def __init__(self, size: int):
        self.size = size

    def start(self, shards: Sequence[Sequence[torch.Tensor]]):
        return [shards[(i - 1) % self.size] for i in range(self.size)]

    @staticmethod
    def finish(pending):
        return pending
