"""Shared model layers (counterpart of ``flaxdiff_tpu/models/common.py``).

Activations are NHWC, as in the JAX package. A contiguous NHWC tensor is a
channels-last NCHW tensor, so convolutions run on ``x.permute(0, 3, 1, 2)``
with no copy, and the GroupNorm kernel reads the same storage as [B, HW, C].

Parameters are stored in f32 and cast to the compute ``dtype`` at use, which
is what ``dtype=bf16`` means for a flax module. ``dtype=None`` computes in
the promotion of the input's and the parameters' dtypes (f32).
"""
from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import fused_groupnorm_silu


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def _variance_scaling_(w: torch.Tensor, fan_in: int, fan_out: int, scale: float = 1.0,
                       mode: str = "fan_avg"):
    """Truncated-normal variance scaling: ``fan_avg`` is the JAX package's
    ``kernel_init``, ``fan_in`` flax's default (lecun normal), which its DiT
    layers keep; scale 0 gives exact zeros (its zero-initialised layers)."""
    if scale <= 0.0:
        return nn.init.zeros_(w)
    fan = {"fan_avg": (fan_in + fan_out) / 2.0, "fan_in": float(fan_in)}[mode]
    std = math.sqrt(scale / fan) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME": stride 2 on an even size pads
    (0, 1), not (1, 1) (flaxdiff_tpu/models/common.py:229)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Module):
    """``nn.Dense``: y = x W^T + b over the last axis, computed in `dtype`."""

    def __init__(self, in_features: int, features: int, dtype=None, device=None,
                 init_scale: float = 1.0, init_mode: str = "fan_avg"):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        _variance_scaling_(self.weight, in_features, features, init_scale, init_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvLayer(nn.Module):
    """``nn.Conv`` with "SAME" padding over NHWC input (the ``conv`` type of
    the JAX package's ConvLayer; the other conv types come later)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), strides: Union[int, Sequence[int]] = 1,
                 dtype=None, device=None, init_scale: float = 1.0, init_mode: str = "fan_avg"):
        super().__init__()
        self.dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        _variance_scaling_(self.weight, in_features * kh * kw, features * kh * kw, init_scale,
                           init_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x)
        x = x.to(dt)
        (ph0, ph1), (pw0, pw1) = (
            _same_padding(x.shape[1], self.kernel_size[0], self.strides[0]),
            _same_padding(x.shape[2], self.kernel_size[1], self.strides[1]))
        if ph0 == ph1 and pw0 == pw1:
            padding = (ph0, pw0)
        else:
            # pad in NHWC so the conv input stays channels-last
            x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
            padding = (0, 0)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt),
                     stride=self.strides, padding=padding)
        return y.permute(0, 2, 3, 1)


_FOURIER_TABLE = Path(__file__).resolve().parent / "fourier_freqs.npz"


@functools.cache
def fourier_freqs(features: int) -> Optional[np.ndarray]:
    """The JAX model's frequencies for this embedding width,
    ``jax.random.normal(PRNGKey(42), (features // 2,)) * 16``, bit for bit,
    from the table ``scripts/make_fourier_freqs.py`` writes; None for a
    width the table does not hold. Shared: callers copy it."""
    with np.load(_FOURIER_TABLE) as table:
        key = str(features)
        return table[key] if key in table.files else None


class FourierEmbedding(nn.Module):
    """Random-Fourier timestep embedding with a FIXED projection.

    The JAX package draws ``freqs`` from ``PRNGKey(42)`` in ``setup`` and does
    not store it as a parameter (flaxdiff_tpu/models/common.py:61-63). Here it
    is a buffer, filled at construction from the committed table of those
    draws; for a width the table lacks it stays NaN until
    ``convert.unet_state_dict_from_flax`` fills it, so a model that was never
    given its frequencies cannot pass for a working one. It is never redrawn
    with torch.
    """

    def __init__(self, features: int, device=None):
        super().__init__()
        freqs = fourier_freqs(features)
        self.register_buffer("freqs", torch.full((features // 2,), float("nan"), device=device)
                             if freqs is None else torch.tensor(freqs, device=device))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t.float()[:, None] * self.freqs[None, :] * 2 * math.pi
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeProjection(nn.Module):
    """Two Dense layers with a tanh-approximated GELU between them
    (``jax.nn.gelu`` defaults to the tanh form): ``in_features`` wide in,
    ``features`` wide out, as flax sizes the first layer from its input."""

    def __init__(self, in_features: int, features: int, dtype=None, device=None):
        super().__init__()
        self.dense_0 = Dense(in_features, features, dtype, device)
        self.dense_1 = Dense(features, features, dtype, device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.dense_1(F.gelu(self.dense_0(emb), approximate="tanh"))


class Upsample(nn.Module):
    """Nearest x2 resize + 3x3 conv."""

    def __init__(self, in_features: int, features: int, dtype=None, device=None):
        super().__init__()
        self.conv = ConvLayer(in_features, features, (3, 3), 1, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class Downsample(nn.Module):
    """Stride-2 3x3 conv with XLA "SAME" padding."""

    def __init__(self, in_features: int, features: int, dtype=None, device=None):
        super().__init__()
        self.conv = ConvLayer(in_features, features, (3, 3), 2, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class FusedGroupNormSiLU(nn.Module):
    """GroupNorm (eps 1e-6, f32 statistics) + SiLU through the fused kernels;
    returns the input dtype, as flaxdiff_tpu/ops/fused_norm.py:251 does."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6, device=None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_groupnorm_silu(x.contiguous(), self.weight, self.bias,
                                    groups=self.groups, eps=self.eps)


class ResidualBlock(nn.Module):
    """GroupNorm -> swish -> conv -> +temb -> GroupNorm -> swish -> conv
    -> + skip (1x1 conv when the width changes). conv2 starts at zero."""

    def __init__(self, in_features: int, features: int, emb_features: Optional[int],
                 norm_groups: int = 8, dtype=None, device=None):
        super().__init__()
        if norm_groups <= 0:
            raise ValueError("the port's ResidualBlock needs GroupNorm (norm_groups > 0)")
        self.norm1 = FusedGroupNormSiLU(in_features, norm_groups, device=device)
        self.conv1 = ConvLayer(in_features, features, (3, 3), 1, dtype, device)
        self.temb_proj = (Dense(emb_features, features, dtype, device)
                          if emb_features is not None else None)
        self.norm2 = FusedGroupNormSiLU(features, norm_groups, device=device)
        self.conv2 = ConvLayer(features, features, (3, 3), 1, dtype, device, init_scale=0.0)
        self.skip_proj = (ConvLayer(in_features, features, (1, 1), 1, dtype, device)
                          if in_features != features else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        residual = self.skip_proj(x) if self.skip_proj is not None else x
        return h + residual
