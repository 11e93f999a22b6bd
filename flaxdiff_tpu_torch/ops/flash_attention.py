"""Flash attention, forward and backward: the CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), their plain PyTorch versions,
and the autograd Function that joins them.

Counterpart of ``flaxdiff_tpu/ops/flash_attention.py``: ``flash_fwd`` replaces
the Pallas kernel ``_fwd_kernel``, ``flash_bwd_dq`` replaces ``_bwd_dq_kernel``
and ``flash_bwd_dkv`` replaces ``_bwd_dkv_kernel``. As in JAX, the backward
recomputes the probabilities from the forward's logsumexp, and
delta = rowsum(dO * O) is one torch reduction before the two kernels.

Head dims: the kernels take 32, 64, 128 and 256, and any multiple of 64
above 256 through the wide kernels (``flash_fwd_wide``, ``flash_bwd_dq_wide``,
``flash_bwd_dkv_wide``), which split the output columns over a third grid
dimension; ``FlashAttentionFn`` picks them by head dim. Every grid takes
any batch * heads (tile on x, batch * heads over y and z).

Layout: [B, L, H, D] at the interface, the JAX package's BTNH convention.
The kernels take explicit (batch, seq, head) strides, so a [B, L, H*D]
projection viewed as [B, L, H, D] reaches them without a copy.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .. import profiling

HEAD_DIMS = (32, 64, 128, 256)
# above 256 the wide kernels take any multiple of WIDE_STEP; each block
# keeps WIDE_COLS of the output's columns (csrc/flash_common.cuh)
WIDE_STEP = 64
WIDE_COLS = {torch.float32: 64, torch.bfloat16: 128, torch.float16: 128}


def wide_head_dim(d: int) -> bool:
    """Whether the wide kernels take head dim ``d``."""
    return d > HEAD_DIMS[-1] and d % WIDE_STEP == 0


def padded_head_dim(d: int) -> int:
    """The head dim the dispatch pads ``d`` to: the next of HEAD_DIMS up to
    256, the next multiple of WIDE_STEP above; ``d`` itself where some flash
    kernel takes it."""
    if d <= HEAD_DIMS[-1]:
        return next(w for w in HEAD_DIMS if w >= d)
    return -(-d // WIDE_STEP) * WIDE_STEP


def _scale(d: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _bhld(t: torch.Tensor) -> torch.Tensor:
    """[B, L, H, D] -> [B, H, L, D] in f32."""
    return t.float().permute(0, 2, 1, 3)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, H, D] in q's dtype, lse [B, H, Lq] f32): the kernel's
    arithmetic on whole rows. Scores and softmax are f32; the unnormalized
    probabilities are rounded to v's dtype before the product with v and
    normalized after it, as the kernel (and the TPU kernel) does."""
    scale = _scale(q.shape[-1], scale)
    s = torch.matmul(_bhld(q), _bhld(k).transpose(-1, -2)) * scale
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), _bhld(v)) * (1.0 / l)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype).permute(0, 2, 1, 3), lse


def _bwd_recompute(q, k, v, do, lse, delta, scale):
    """(p, ds) [B, H, Lq, Lk] f32 from the saved logsumexp:
    p = exp(scale q k^T - lse), ds = p (dO v^T - delta) scale, as the TPU
    kernels compute them (flash_attention.py:153-161)."""
    s = torch.matmul(_bhld(q), _bhld(k).transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(_bhld(do), _bhld(v).transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: Optional[float] = None) -> torch.Tensor:
    """dq = ds k with ds rounded to k's dtype first (flash_attention.py:162);
    [B, Lq, H, D] in q's dtype."""
    _, ds = _bwd_recompute(q, k, v, do, lse, delta, _scale(q.shape[-1], scale))
    dq = torch.matmul(ds.to(k.dtype).float(), _bhld(k))
    return dq.to(q.dtype).permute(0, 2, 1, 3)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = ds^T q and dv = p^T dO, with p and ds rounded to the input dtype
    first (flash_attention.py:197,203); [B, Lk, H, D] in k's and v's dtype."""
    p, ds = _bwd_recompute(q, k, v, do, lse, delta, _scale(q.shape[-1], scale))
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), _bhld(q))
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), _bhld(do))
    return dk.to(k.dtype).permute(0, 2, 1, 3), dv.to(v.dtype).permute(0, 2, 1, 3)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, L, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")


def _check_cuda(*named: Tuple[str, torch.Tensor], wide: bool = False) -> None:
    """What every flash kernel needs of its [B, L, H, D] operands; ``wide``
    for the kernels of head dims above 256."""
    _build.require_cuda(*(t for _, t in named))
    d = named[0][1].shape[-1]
    if wide and not wide_head_dim(d):
        raise ValueError(f"head dim {d}: the wide kernels take multiples of {WIDE_STEP} "
                         f"above {HEAD_DIMS[-1]}")
    if not wide and d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    vec = 16 // named[0][1].element_size()
    for name, t in named:
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head dim must be contiguous")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides and data pointer must be 16-byte aligned")


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _check_rows(name: str, t: torch.Tensor, b: int, h: int, lq: int) -> None:
    if tuple(t.shape) != (b, h, lq) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous f32 {(b, h, lq)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _launch_fwd(entry: str, q, k, v, scale, lse: torch.Tensor, *extra) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, lq, h, d = q.shape
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        b, h, lq, k.shape[1], d, _scale(d, scale), _build.dtype_code(q), *extra,
        _build.stream_handle(q.device))
    _build.check(err, entry)
    return out


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (B1): (out [B, Lq, H, D], lse [B, H, Lq] f32).
    CUDA tensors launch it, CPU tensors take the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    _check_cuda(("q", q), ("k", k), ("v", v))
    b, lq, h, _ = q.shape
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    out = _launch_fwd("flash_fwd", q, k, v, scale, lse)
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_fwd_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None, chunk_lse: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel at head dims above 256 (B1, column-chunked):
    (out [B, Lq, H, D], lse [B, H, Lq] f32). With ``chunk_lse`` (CUDA only),
    lse is [chunks, B, H, Lq], each column chunk's own copy, which the
    kernel's design makes bit-equal."""
    _check(q, k, v)
    if q.device.type == "cpu":
        if chunk_lse:
            raise ValueError("chunk_lse reads the kernel's column chunks: CUDA tensors only")
        return flash_fwd_plain(q, k, v, scale)
    _check_cuda(("q", q), ("k", k), ("v", v), wide=True)
    b, lq, h, d = q.shape
    chunks = -(-d // WIDE_COLS[q.dtype]) if chunk_lse else 1
    lse = torch.empty((chunks, b, h, lq), dtype=torch.float32, device=q.device)
    out = _launch_fwd("flash_fwd_wide", q, k, v, scale, lse, b * h * lq if chunk_lse else 0)
    flash_fwd_wide.launches += 1
    return out, (lse if chunk_lse else lse[0])


flash_fwd_wide.launches = 0


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO: want {q.dtype} {tuple(q.shape)}, got {do.dtype} "
                         f"{tuple(do.shape)}")


def _launch_bwd(entry: str, q, k, v, do, lse, delta, scale, grads, wide: bool) -> None:
    _check_cuda(("q", q), ("k", k), ("v", v), ("dO", do), wide=wide)
    b, lq, h, d = q.shape
    _check_rows("lse", lse, b, h, lq)
    _check_rows("delta", delta, b, h, lq)
    _build.require_cuda(q, lse, delta)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(g.data_ptr() for g in grads),
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(grads[0]),
        b, h, lq, k.shape[1], d, _scale(d, scale), _build.dtype_code(q),
        _build.stream_handle(q.device))
    _build.check(err, entry)


def _dq(entry: str, wrapper, q, k, v, do, lse, delta, scale, wide: bool) -> torch.Tensor:
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd(entry, q, k, v, do, lse, delta, scale, (dq,), wide)
    wrapper.launches += 1
    return dq


def _dkv(entry: str, wrapper, q, k, v, do, lse, delta, scale, wide: bool
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd(entry, q, k, v, do, lse, delta, scale, (dk, dv), wide)
    wrapper.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel (B2): one block per (q tile, batch*head), looping over
    the kv tiles. lse and delta are [B, H, Lq] f32."""
    return _dq("flash_bwd_dq", flash_bwd_dq, q, k, v, do, lse, delta, scale, wide=False)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel (B3): one block per (kv tile, batch*head), looping
    over the q tiles. lse and delta are [B, H, Lq] f32."""
    return _dkv("flash_bwd_dkv", flash_bwd_dkv, q, k, v, do, lse, delta, scale, wide=False)


flash_bwd_dkv.launches = 0


def flash_bwd_dq_wide(q, k, v, do, lse, delta, scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel at head dims above 256 (B2, column-chunked)."""
    return _dq("flash_bwd_dq_wide", flash_bwd_dq_wide, q, k, v, do, lse, delta, scale, wide=True)


flash_bwd_dq_wide.launches = 0


def flash_bwd_dkv_wide(q, k, v, do, lse, delta, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel at head dims above 256 (B3, column-chunked)."""
    return _dkv("flash_bwd_dkv_wide", flash_bwd_dkv_wide, q, k, v, do, lse, delta, scale,
                wide=True)


flash_bwd_dkv_wide.launches = 0


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32 as [B, H, Lq], computed once before the
    two backward kernels (flash_attention.py:343)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _kernels(d: int):
    """(forward, dq, dk/dv) wrappers for head dim ``d``."""
    if d > HEAD_DIMS[-1]:
        return flash_fwd_wide, flash_bwd_dq_wide, flash_bwd_dkv_wide
    return flash_fwd, flash_bwd_dq, flash_bwd_dkv


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel; the dq and dk/dv kernels backward, from the saved
    (q, k, v, out, lse), as ``flash_attention``'s custom VJP does. Head dims
    above 256 take the wide kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale, model_head_dim=None):
        ctx.model_head_dim = q.shape[-1] if model_head_dim is None else model_head_dim
        fwd = _kernels(q.shape[-1])[0]
        if profiling.live_counters:
            flops = profiling.attention_flops(q, k, ctx.model_head_dim, backward=False)
            with profiling.count_product(flops):
                out, lse = fwd(q, k, v, scale)
        else:
            out, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        saved = ctx.saved_tensors
        if profiling.live_counters:
            flops = profiling.attention_flops(saved[0], saved[1], ctx.model_head_dim,
                                              backward=True)
            with profiling.count_product(flops):
                return _flash_backward(ctx.scale, do, *saved)
        return _flash_backward(ctx.scale, do, *saved)


def _flash_backward(scale, do, q, k, v, out, lse):
    """The dq and dk/dv kernels from the forward's saved tensors."""
    do = do.contiguous()
    delta = flash_delta(out, do)
    _, bwd_dq, bwd_dkv = _kernels(q.shape[-1])
    dq = bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, return_lse: bool = False,
                    model_head_dim: Optional[int] = None):
    """softmax(scale * q k^T) v over [B, L, H, D] tensors; with
    ``return_lse`` also the per-row logsumexp [B, H, Lq] (f32).

    Differentiable through ``FlashAttentionFn``: the forward kernel, and the
    two backward kernels when autograd asks. CUDA tensors launch the
    kernels, CPU tensors take the plain versions; anything the kernels
    cannot take (a head dim outside HEAD_DIMS that is not a multiple of 64
    above 256) raises, on every device. `model_head_dim`: the head dim
    before zero-padding, at which a ``profiling.FlopCounter`` counts the
    call (default: q's)."""
    _check(q, k, v)
    if padded_head_dim(q.shape[-1]) != q.shape[-1]:
        raise ValueError(f"head dim {q.shape[-1]}: the flash kernels take {HEAD_DIMS} and "
                         f"multiples of {WIDE_STEP} above {HEAD_DIMS[-1]}")
    out, lse = FlashAttentionFn.apply(q, k, v, scale, model_head_dim)
    return (out, lse) if return_lse else out
