"""Ulysses sequence parallelism (counterpart of
``flaxdiff_tpu/parallel/ulysses.py``; DeepSpeed-Ulysses, Jacobs et al.
2023).

Where the ring rotates k/v shards n - 1 times, Ulysses re-shards once each
way: one ``all_to_all_single`` over the seq group turns the sequence-sharded,
all-head q/k/v (stacked, one collective) into full-sequence, head-sharded
ones; each rank runs exact attention over the whole sequence for its heads
through the flash dispatch (the flash kernels); one reverse all-to-all
brings the output back to sequence shards. The backward is the two
all-to-alls reversed around the flash backward kernels. Needs heads and
sequence divisible by the seq dim.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .collectives import all_to_all_flat


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[..., B, S/n, H, D] sequence shards -> [..., B, S, H/n, D] head shards
    (leading dims, such as the stacked q/k/v, ride along)."""
    n = dist.get_world_size(group)
    *lead, b, s, h, d = x.shape
    # chunk j (heads j h/n ...) goes to rank j; chunk j of the result is
    # sequence shard j of this rank's heads
    parts = x.reshape(*lead, b, s, n, h // n, d).movedim(-3, 0)
    got = all_to_all_flat(parts, group)
    return got.movedim(0, -4).reshape(*lead, b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse: [..., B, S, H/n, D] -> [..., B, S/n, H, D]."""
    n = dist.get_world_size(group)
    *lead, b, s, h, d = x.shape
    parts = x.reshape(*lead, b, n, s // n, h, d).movedim(-4, 0)
    got = all_to_all_flat(parts, group)
    return got.movedim(0, -3).reshape(*lead, b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def ulysses_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                              scale: Optional[float] = None,
                              model_head_dim: Optional[int] = None) -> torch.Tensor:
    """One rank's output shard from its q/k/v sequence shards [B, S/n, H, D]
    (a head dim a flash kernel takes), differentiable."""
    from ..ops.flash_attention import flash_attention
    qkv = _SeqToHeads.apply(torch.stack([q, k, v]), group)
    out = flash_attention(qkv[0], qkv[1], qkv[2], scale=scale, model_head_dim=model_head_dim)
    return _HeadsToSeq.apply(out, group)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                           seq_axis: str = "seq", scale: Optional[float] = None,
                           model_head_dim: Optional[int] = None) -> torch.Tensor:
    """Self-attention over [B, S, H, D] tensors the seq group holds whole
    (``sequence_region``); heads and S must divide the seq dim."""
    from .mesh import axis_group, axis_size
    from .sequence import sequence_region
    n = axis_size(mesh, seq_axis)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by {seq_axis} axis size {n}")
    if q.shape[1] % n != 0:
        raise ValueError(f"sequence {q.shape[1]} not divisible by {seq_axis} axis size {n}")
    group = axis_group(mesh, seq_axis)
    return sequence_region(
        lambda a, b, c: ulysses_attention_sharded(a, b, c, group, scale, model_head_dim),
        group, q, k, v)
