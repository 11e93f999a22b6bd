"""GEGLU, forward and backward: the CUDA kernels (``csrc/geglu.cu``), their
plain PyTorch versions, and the autograd Function that joins them.

Counterpart of the GEGLU part of ``flaxdiff_tpu/ops/fused_adaln.py`` (Pallas
kernels ``_geglu_kernel`` and ``_geglu_bwd_kernel``). The AdaLN kernels of
that file come with the DiT slice.
"""
from __future__ import annotations

import torch

from . import _build

_SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), written as fused_adaln.py:486-490."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / dx, written as fused_adaln.py:493-497."""
    t = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    return (0.5 * (1.0 + t)
            + 0.5 * x * (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * x * x))


def geglu_plain(proj: torch.Tensor) -> torch.Tensor:
    """val * gelu_tanh(gate), gate = first half, in f32, proj's dtype out."""
    gate, val = proj.float().chunk(2, dim=-1)
    return (val * gelu_tanh(gate)).to(proj.dtype)


def geglu_bwd_plain(proj: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """[dgate, dval] = [dO val gelu'(gate), dO gelu(gate)] in f32, one
    [..., 2F] cotangent in proj's dtype (fused_adaln.py:506-516)."""
    gate, val = proj.float().chunk(2, dim=-1)
    d = dout.float()
    return torch.cat([d * val * gelu_tanh_grad(gate), d * gelu_tanh(gate)],
                     dim=-1).to(proj.dtype)


def _check(proj: torch.Tensor) -> int:
    f2 = proj.shape[-1]
    if f2 % 2:
        raise ValueError(f"GEGLU needs an even last dim, got {f2}")
    return f2 // 2


def geglu_fwd(proj: torch.Tensor) -> torch.Tensor:
    """The forward kernel (B8). proj: [..., 2F], contiguous -> [..., F]."""
    f = _check(proj)
    if proj.device.type == "cpu":
        return geglu_plain(proj)
    _build.require_cuda(proj)
    if not proj.is_contiguous():
        raise ValueError("fused_geglu needs a contiguous projection")
    out = torch.empty(proj.shape[:-1] + (f,), dtype=proj.dtype, device=proj.device)
    err = _build.library().geglu_fwd(
        proj.data_ptr(), out.data_ptr(), proj.numel() // (2 * f), f,
        _build.dtype_code(proj), _build.stream_handle(proj.device))
    _build.check(err, "geglu_fwd")
    geglu_fwd.launches += 1
    return out


geglu_fwd.launches = 0


def geglu_bwd(proj: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The backward kernel (B9). proj: [..., 2F], dout: [..., F], both
    contiguous -> dproj [..., 2F] with the gate's half first."""
    f = _check(proj)
    if dout.shape != proj.shape[:-1] + (f,) or dout.dtype != proj.dtype:
        raise ValueError(f"dout: want {proj.dtype} {tuple(proj.shape[:-1]) + (f,)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    if proj.device.type == "cpu":
        return geglu_bwd_plain(proj, dout)
    _build.require_cuda(proj, dout)
    if not (proj.is_contiguous() and dout.is_contiguous()):
        raise ValueError("geglu_bwd needs a contiguous projection and cotangent")
    dproj = torch.empty_like(proj)
    err = _build.library().geglu_bwd(
        proj.data_ptr(), dout.data_ptr(), dproj.data_ptr(), proj.numel() // (2 * f), f,
        _build.dtype_code(proj), _build.stream_handle(proj.device))
    _build.check(err, "geglu_bwd")
    geglu_bwd.launches += 1
    return dproj


geglu_bwd.launches = 0


class GEGLUFn(torch.autograd.Function):
    """geglu_fwd forward, geglu_bwd backward from the saved projection, as
    ``_geglu``'s custom VJP does (fused_adaln.py:549-584)."""

    @staticmethod
    def forward(ctx, proj):
        ctx.save_for_backward(proj)
        return geglu_fwd(proj)

    @staticmethod
    def backward(ctx, dout):
        (proj,) = ctx.saved_tensors
        return geglu_bwd(proj, dout.contiguous())


def fused_geglu(proj: torch.Tensor) -> torch.Tensor:
    """val * gelu_tanh(gate) where gate, val = proj.chunk(2, -1).
    proj: [..., 2F], contiguous -> [..., F]. Differentiable through
    ``GEGLUFn``."""
    _check(proj)
    return GEGLUFn.apply(proj)
