"""Ring attention: exact sequence-parallel attention over the mesh's seq dim
(counterpart of ``flaxdiff_tpu/parallel/ring_attention.py``; Liu et al.
2023, Ring Attention with Blockwise Transformers).

Each rank holds one sequence shard of q and of k/v. The k/v shards rotate
around the ring while every rank attends its q shard to each visiting one,
so the [S, S] scores never exist. Each hop runs the flash forward kernel
(``flash_fwd``, or ``flash_fwd_wide`` above head dim 256), which returns
the hop's output and logsumexp; the hops merge in f32 through their
logsumexp weights,

    out = sum_h o_h exp(lse_h - lse),  lse = logaddexp_h lse_h,

which is softmax attention over the whole sequence. The backward re-rotates
k/v and runs the two backward kernels (``flash_bwd_dq``, ``flash_bwd_dkv``)
per hop under the global (out, lse), with delta = rowsum(dO O) computed
once: the flash backward is exact per k/v block given the global lse and
delta. The dk/dv accumulators ride the ring with their shard and are home
after n hops. Nothing per hop is kept for the backward.

The hop loop takes its rotation from a transport
(``parallel/collectives.py``): ``ProcessGroupTransport`` over the seq
group, which a model uses, each rank holding one shard; or
``InProcessTransport``, one process holding every shard, which drives the
same loop on one card. Each hop's rotation is posted before the hop's
kernels run, so it overlaps them; at n = 1 nothing rotates.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from .. import profiling
from ..ops.flash_attention import _kernels, _scale, flash_delta

Shards = Sequence[torch.Tensor]


def _merge(o: torch.Tensor, lse: torch.Tensor, o_h: torch.Tensor, lse_h: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one hop's (o_h [B, L, H, D], lse_h [B, H, L]) into the running
    f32 (o, lse) through logsumexp weights."""
    lse_new = torch.logaddexp(lse, lse_h)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_h - lse_new).transpose(1, 2)[..., None]
    return o * w_old + o_h.float() * w_new, lse_new


def ring_forward(qs: Shards, ks: Shards, vs: Shards, transport, scale: Optional[float] = None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring's forward over the shards this process holds ([B, L/n, H, D]
    each; one under a process group): (outputs in q's dtype, f32 logsumexps
    [B, H, L/n])."""
    fwd = _kernels(qs[0].shape[-1])[0]
    n = transport.size
    kv = [(k, v) for k, v in zip(ks, vs)]
    outs: List[Optional[torch.Tensor]] = [None] * len(qs)
    lses: List[Optional[torch.Tensor]] = [None] * len(qs)
    for hop in range(n):
        pending = transport.start(kv) if hop < n - 1 else None
        for j, q in enumerate(qs):
            o_h, lse_h = fwd(q, kv[j][0], kv[j][1], scale)
            if outs[j] is None:
                # the first hop's weights are exactly 1 (lse starts at -inf)
                outs[j], lses[j] = o_h.float(), lse_h
            else:
                outs[j], lses[j] = _merge(outs[j], lses[j], o_h, lse_h)
        if pending is not None:
            kv = transport.finish(pending)
    return [o.to(q.dtype) for o, q in zip(outs, qs)], lses


def ring_backward(qs: Shards, ks: Shards, vs: Shards, outs: Shards, lses: Shards,
                  dos: Shards, transport, scale: Optional[float] = None
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """The ring's backward over this process's shards, from the forward's
    (outputs, logsumexps) and the output gradients: (dq, dk, dv) in the
    inputs' dtypes, each for its own shard. The hops' gradients are summed
    in f32."""
    _, bwd_dq, bwd_dkv = _kernels(qs[0].shape[-1])
    n = transport.size
    deltas = [flash_delta(o, do) for o, do in zip(outs, dos)]
    kv = [(k, v) for k, v in zip(ks, vs)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    acc = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device)) for k, v in kv]
    acc_pending = None
    for hop in range(n):
        kv_pending = transport.start(kv) if hop < n - 1 else None
        hops = []
        for j, q in enumerate(qs):
            k, v = kv[j]
            args = (q, k, v, dos[j], lses[j], deltas[j], scale)
            hops.append((bwd_dq(*args), *bwd_dkv(*args)))
        if acc_pending is not None:
            acc = transport.finish(acc_pending)
        new_acc = []
        for j, (dq_h, dk_h, dv_h) in enumerate(hops):
            dq[j] += dq_h.float()
            new_acc.append((acc[j][0] + dk_h.float(), acc[j][1] + dv_h.float()))
        acc = new_acc
        # the accumulators travel with the shard they belong to; after the
        # last hop one more rotation brings each home
        acc_pending = transport.start(acc) if n > 1 else None
        if kv_pending is not None:
            kv = transport.finish(kv_pending)
    if acc_pending is not None:
        acc = transport.finish(acc_pending)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)],
            [a[0].to(k.dtype) for a, k in zip(acc, ks)],
            [a[1].to(v.dtype) for a, v in zip(acc, vs)])


class RingAttentionFn(torch.autograd.Function):
    """One rank's ring attention: the forward hops, and the backward hops
    from the saved (q, k, v, out, lse), as ``ring_attention_sharded``'s
    custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, transport, scale, model_head_dim):
        ctx.transport, ctx.scale = transport, scale
        ctx.model_head_dim = q.shape[-1] if model_head_dim is None else model_head_dim
        with _counted(q, k, ctx.model_head_dim, transport.size, backward=False):
            (out,), (lse,) = ring_forward([q], [k], [v], transport, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        with _counted(q, k, ctx.model_head_dim, ctx.transport.size, backward=True):
            (dq,), (dk,), (dv,) = ring_backward([q], [k], [v], [out], [lse], [do.contiguous()],
                                                ctx.transport, ctx.scale)
        return dq, dk, dv, None, None, None


def _counted(q, k, head_dim: int, hops: int, backward: bool):
    """A ``profiling.FlopCounter`` counts the hops' products by formula."""
    if not profiling.live_counters:
        return contextlib.nullcontext()
    return profiling.count_product(hops * profiling.attention_flops(q, k, head_dim, backward))


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, transport,
                           scale: Optional[float] = None,
                           model_head_dim: Optional[int] = None) -> torch.Tensor:
    """One rank's output shard from its q/k/v shards [B, S/n, H, D] (a head
    dim a flash kernel takes; the dispatch pads others), differentiable."""
    scale = _scale(model_head_dim or q.shape[-1], scale)
    return RingAttentionFn.apply(q, k, v, transport, scale, model_head_dim)


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                        seq_axis: str = "seq", scale: Optional[float] = None,
                        model_head_dim: Optional[int] = None) -> torch.Tensor:
    """Self-attention over [B, S, H, D] tensors that every rank of the seq
    group holds whole (the rest of the model is replicated over seq): each
    rank takes its sequence shard, the ring runs over the seq group, and
    the output shards are gathered back to the whole sequence. Gradients
    come back whole on every rank (``sequence_region``)."""
    from .collectives import ProcessGroupTransport
    from .mesh import axis_group
    from .sequence import sequence_region
    group = axis_group(mesh, seq_axis)
    transport = ProcessGroupTransport(group)
    return sequence_region(
        lambda a, b, c: ring_attention_sharded(a, b, c, transport, scale, model_head_dim),
        group, q, k, v)
