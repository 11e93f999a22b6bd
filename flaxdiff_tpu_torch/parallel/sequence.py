"""The sequence-parallel region: where the model's replicated tensors enter
the seq group's sharded attention and leave it.

In the JAX package GSPMD keeps the model replicated across the seq devices
and shards only inside the attention's ``shard_map``. Here every rank of a
seq group runs the whole model on the same rows, so:

- entering the region takes the rank's sequence shard of q, k and v; its
  backward all-gathers the shard gradients, so every rank gets the whole
  dq, dk and dv;
- leaving it all-gathers the output shards; its backward takes the rank's
  slice of the (identical on every rank) output gradient.

Every parameter gradient is then the same on all seq ranks, and the
gradient reduction runs over data x fsdp only.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import gather_dim


def _shard(x: torch.Tensor, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[1] // n
    return x.narrow(1, r * size, size)


class _EnterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shard(x, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, 1, ctx.group), None


class _LeaveSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _shard(g, ctx.group).contiguous(), None


def sequence_region(fn: Callable, group, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """``fn(q_shard, k_shard, v_shard) -> out_shard`` on this rank's
    sequence shards of [B, S, H, D] tensors the seq group holds whole; the
    output gathered whole."""
    shards = [_EnterSeq.apply(t, group) for t in (q, k, v)]
    return _LeaveSeq.apply(fn(*shards), group)
