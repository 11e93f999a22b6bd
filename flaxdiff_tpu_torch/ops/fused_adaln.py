"""GEGLU forward: the CUDA kernel (``csrc/geglu.cu``) and its plain PyTorch
version.

Counterpart of the GEGLU part of ``flaxdiff_tpu/ops/fused_adaln.py`` (Pallas
kernel ``_geglu_kernel``). The AdaLN kernels of that file come with the DiT
slice.
"""
from __future__ import annotations

import torch

from . import _build

_SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), written as fused_adaln.py:486-490."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))


def geglu_plain(proj: torch.Tensor) -> torch.Tensor:
    """val * gelu_tanh(gate), gate = first half, in f32, proj's dtype out."""
    gate, val = proj.float().chunk(2, dim=-1)
    return (val * gelu_tanh(gate)).to(proj.dtype)


def fused_geglu(proj: torch.Tensor) -> torch.Tensor:
    """proj: [..., 2F], contiguous -> [..., F]."""
    f2 = proj.shape[-1]
    if f2 % 2:
        raise ValueError(f"GEGLU needs an even last dim, got {f2}")
    if proj.device.type == "cpu":
        return geglu_plain(proj)
    _build.require_cuda(proj)
    if not proj.is_contiguous():
        raise ValueError("fused_geglu needs a contiguous projection")
    f = f2 // 2
    out = torch.empty(proj.shape[:-1] + (f,), dtype=proj.dtype, device=proj.device)
    err = _build.library().geglu_fwd(
        proj.data_ptr(), out.data_ptr(), proj.numel() // f2, f,
        _build.dtype_code(proj), _build.stream_handle(proj.device))
    _build.check(err, "geglu_fwd")
    fused_geglu.launches += 1
    return out


fused_geglu.launches = 0
