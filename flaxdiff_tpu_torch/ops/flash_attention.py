"""Flash-attention forward: the CUDA kernel (``csrc/flash_fwd.cu``) and its
plain PyTorch version.

Counterpart of ``flaxdiff_tpu/ops/flash_attention.py`` ``_fwd_impl`` (the
forward Pallas kernel ``_fwd_kernel``). The backward kernels come with the
training slice; ``lse`` is already returned for them.

Layout: [B, L, H, D] at the interface, the JAX package's BTNH convention.
The kernel takes explicit (batch, seq, head) strides, so a [B, L, H*D]
projection viewed as [B, L, H, D] reaches it without a copy.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, H, D] in q's dtype, lse [B, H, Lq] f32): the kernel's
    arithmetic on whole rows. Scores and softmax are f32; the unnormalized
    probabilities are rounded to v's dtype before the product with v and
    normalized after it, as the kernel (and the TPU kernel) does."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.float().permute(0, 2, 1, 3)            # [B, H, Lq, D]
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.permute(0, 2, 1, 3)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), vf.float()) * (1.0 / l)
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype).permute(0, 2, 1, 3), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, L, H, D] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, return_lse: bool = False):
    """softmax(scale * q k^T) v over [B, L, H, D] tensors; with
    ``return_lse`` also the per-row logsumexp [B, H, Lq] (f32).

    CUDA tensors launch the kernel, CPU tensors take the plain version;
    anything the kernel cannot take raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, scale)
        return (out, lse) if return_lse else out
    _build.require_cuda(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    code = _build.dtype_code(q)
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head dim must be contiguous")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides and data pointer must be 16-byte aligned")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _build.library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        b, h, lq, lk, d, scale, code, _build.stream_handle(q.device))
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
