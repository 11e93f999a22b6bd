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
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


CONV_TYPES = ("conv", "w_conv", "separable", "conv_transpose")


def lecun_dense(in_features: int, features: int, dtype=None, device=None) -> Dense:
    """A Dense with flax's default initializer, lecun normal, where the JAX
    modules leave ``nn.Dense`` at its default."""
    return Dense(in_features, features, dtype, device, init_mode="fan_in")


class ConvLayer(nn.Module):
    """The JAX package's ConvLayer over NHWC input, XLA "SAME" padding:

    - ``conv``: ``nn.Conv`` (``groups``, ``dilation`` and ``use_bias`` give
      the depthwise convolutions of ``SeparableConv`` and the SSM's spatial
      fusion);
    - ``separable``: ``SeparableConv``, a depthwise convolution (groups = C)
      then a 1x1 pointwise one, neither with a bias;
    - ``conv_transpose``: ``nn.ConvTranspose``, stride 2 whatever
      ``strides`` says, as in JAX. flax correlates the zero-dilated input
      with the kernel as it is (``transpose_kernel=False``) and pads it
      "SAME" its own way (``lax._conv_transpose_padding``); torch's
      ``conv_transpose2d`` is the gradient of a convolution and flips the
      kernel. So the weight is stored flipped, [in, out, kh, kw] (what
      ``convert`` makes of the flax kernel), and the full output is cropped
      or zero-extended to flax's padding before the bias;
    - ``w_conv``: raises. The JAX package cannot build its weight-standardised
      convolution (``nn.map_variables`` is handed a module instance at
      flaxdiff_tpu/models/common.py:119), so the port has nothing to match.
    """

    def __init__(self, in_features: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), strides: Union[int, Sequence[int]] = 1,
                 dtype=None, device=None, init_scale: float = 1.0, init_mode: str = "fan_avg",
                 conv_type: str = "conv", groups: int = 1, dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        if conv_type == "w_conv":
            raise ValueError("conv_type 'w_conv' cannot be built by the JAX package "
                             "(flaxdiff_tpu/models/common.py:119 hands nn.map_variables a "
                             "module instance), so the port has no reference to match")
        if conv_type not in CONV_TYPES:
            raise ValueError(f"Unknown conv_type {conv_type!r}")
        self.dtype = dtype
        self.conv_type = conv_type
        self.kernel_size = tuple(kernel_size)
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.groups, self.dilation = groups, dilation
        kh, kw = self.kernel_size
        if conv_type == "separable":
            conv = lambda i, o, k, s, g: ConvLayer(i, o, k, s, dtype, device, init_scale,
                                                   init_mode, groups=g, use_bias=False)
            self.depthwise = conv(in_features, in_features, self.kernel_size, self.strides,
                                  in_features)
            self.pointwise = conv(in_features, features, (1, 1), 1, 1)
            return
        if conv_type == "conv_transpose":
            self.strides = (2, 2)
            shape = (in_features, features, kh, kw)
        else:
            shape = (features, in_features // groups, kh, kw)
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device)) if use_bias else None
        _variance_scaling_(self.weight, in_features // groups * kh * kw, features * kh * kw,
                           init_scale, init_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_type == "separable":
            return self.pointwise(self.depthwise(x))
        dt = compute_dtype(self.dtype, x)
        x = x.to(dt)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.conv_type == "conv_transpose":
            return self._transpose(x, bias)
        span = lambda k: (k - 1) * self.dilation + 1
        (ph0, ph1), (pw0, pw1) = (
            _same_padding(x.shape[1], span(self.kernel_size[0]), self.strides[0]),
            _same_padding(x.shape[2], span(self.kernel_size[1]), self.strides[1]))
        if ph0 == ph1 and pw0 == pw1:
            padding = (ph0, pw0)
        else:
            # pad in NHWC so the conv input stays channels-last
            x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1))
            padding = (0, 0)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), bias, stride=self.strides,
                     padding=padding, dilation=self.dilation, groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def _transpose(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        full = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                                  stride=self.strides)
        # the full output is the correlation over the input padded by k - 1 on
        # each side; flax pads by (pad_a, pad_b) instead
        crop = []
        for k, s in reversed(tuple(zip(self.kernel_size, self.strides))):
            pad_a, pad_b = _transpose_same_padding(k, s)
            crop += [pad_a - (k - 1), pad_b - (k - 1)]
        y = F.pad(full, crop).permute(0, 2, 3, 1)
        return y if bias is None else y + bias


def _transpose_same_padding(k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of the dilated input of a "SAME"
    ``lax.conv_transpose``."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


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
    ``convert.state_dict_from_flax`` fills it, so a model that was never
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


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(dtype=f32)`` over NHWC input: eps 1e-6, f32 math
    and output. A plain composition, as in JAX, where XLA runs it."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6, device=None):
        super().__init__()
        if groups <= 0:
            raise ValueError(f"Number of groups ({groups}) must be positive")
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups, self.weight, self.bias,
                         self.eps)
        return y.permute(0, 2, 3, 1)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=f32)``: x rsqrt(mean(x^2) + 1e-6) scale over
    the channels, in f32."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        return xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps) * self.weight


def remat_call(module: nn.Module, remat: bool, *args):
    """``module(*args)``, its activations recomputed in the backward pass
    with ``remat`` (``nn.remat``'s counterpart)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


class ResidualBlock(nn.Module):
    """norm -> activation -> conv -> +temb -> norm -> activation -> conv
    -> + skip (1x1 conv when the width changes). conv2 starts at zero.

    With GroupNorm (``norm_groups > 0``) and swish/silu, each norm and
    activation is one pass of the fused GroupNorm + SiLU kernels, as in JAX
    (flaxdiff_tpu/models/common.py:284-291); any other activation follows an
    f32 GroupNorm, and ``norm_groups <= 0`` takes an f32 RMSNorm, both plain
    compositions as in JAX. The time embedding enters through the same
    activation."""

    def __init__(self, in_features: int, features: int, emb_features: Optional[int],
                 norm_groups: int = 8, dtype=None, device=None, activation: Callable = F.silu,
                 conv_type: str = "conv"):
        super().__init__()
        self.activation = activation
        self.fused = norm_groups > 0 and activation is F.silu
        if self.fused:
            norm = lambda c: FusedGroupNormSiLU(c, norm_groups, device=device)
        elif norm_groups > 0:
            norm = lambda c: GroupNorm(c, norm_groups, device=device)
        else:
            norm = lambda c: RMSNorm(c, device=device)
        conv = lambda i, o, **kw: ConvLayer(i, o, (3, 3), 1, dtype, device, conv_type=conv_type,
                                            **kw)
        self.norm1 = norm(in_features)
        self.conv1 = conv(in_features, features)
        self.temb_proj = (Dense(emb_features, features, dtype, device)
                          if emb_features is not None else None)
        self.norm2 = norm(features)
        self.conv2 = conv(features, features, init_scale=0.0)
        self.skip_proj = (ConvLayer(in_features, features, (1, 1), 1, dtype, device)
                          if in_features != features else None)

    def _norm_act(self, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return norm(x) if self.fused else self.activation(norm(x))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self._norm_act(self.norm1, x))
        if temb is not None:
            h = h + self.temb_proj(self.activation(temb))[:, None, None, :]
        h = self.conv2(self._norm_act(self.norm2, h))
        residual = self.skip_proj(x) if self.skip_proj is not None else x
        return h + residual
