"""S5 state-space layers and the hybrid SSM/attention DiT (counterpart of
``flaxdiff_tpu/models/ssm.py``).

``S5Layer`` is a diagonal complex SSM with HiPPO-diag parameters, discretised
by zero-order hold in complex64: x_k = A_bar x_{k-1} + B_bar u_k, y = Re(C
x) + D u. JAX evaluates the recurrence with ``jax.lax.associative_scan``, an
XLA op and no Pallas kernel, so it stays plain PyTorch here: a Hillis-Steele
scan with the same combine, ceil(log2 S) doubling passes, never S
sequential steps. Its association order differs from JAX's, so it agrees
to rounding (the tests hold it to 1e-4 of the largest state).

``HybridSSMAttentionDiT`` interleaves ``SSMDiTBlock``s (the attention path
replaced by a bidirectional S5 scan along the scan order, optionally fused
over the 2D patch grid by dilated depthwise convolutions) with ``DiTBlock``s.
The SSM blocks run JAX's plain epilogues (parameter-free LayerNorm,
``modulate``, ``x + g h``), as the reference does; the attention blocks take
the AdaLN kernels. Torch needs ``in_channels`` and ``context_dim`` up front;
``precision`` and ``force_fp32_for_softmax`` are accepted and have no
effect.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import gelu, resolve_activation, resolve_dtype, resolve_precision
from .common import ConvLayer, Dense, lecun_dense
from .dit import DiTBlock
from .sfc import scan_indices, scan_permutation, sfc_unpatchify, unpatchify
from .vit_common import (AdaLNParams, LayerNorm, ScanPatchEmbed, TimeTextEmbedding, modulate,
                         plain_layer_norm, scan_rope)


def _lecun_normal(shape: Tuple[int, int], device) -> torch.Tensor:
    """flax ``lecun_normal`` on a 2D shape: truncated normal, std
    1/sqrt(shape[0])."""
    w = torch.empty(shape, device=device)
    std = 1.0 / math.sqrt(shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def linear_scan(a: torch.Tensor, bu: torch.Tensor) -> torch.Tensor:
    """States x_k = a x_{k-1} + bu_k (x_{-1} = 0) along dim 1 of bu [B, S, N]
    for a per-state constant a [N]: Hillis-Steele doubling with the
    associative combine (a1, x1), (a2, x2) -> (a1 a2, a2 x1 + x2). After the
    pass at offset d, x_k sums bu over (k - 2d, k]; a^d squares each pass."""
    x, a_pow, d = bu, a, 1
    while d < x.shape[1]:
        x = torch.cat([x[:, :d], x[:, d:] + a_pow * x[:, :-d]], dim=1)
        a_pow = a_pow * a_pow
        d *= 2
    return x


class S5Layer(nn.Module):
    def __init__(self, features: int, state_dim: int = 64, dt_min: float = 0.001,
                 dt_max: float = 0.1, dtype=None, device=None):
        super().__init__()
        n = state_dim
        self.dtype = dtype
        ar = torch.arange(n, dtype=torch.float32, device=device)
        self.log_A_real = nn.Parameter(torch.log(ar + 0.5))
        self.A_imag = nn.Parameter(math.pi * ar)
        self.B_re = nn.Parameter(_lecun_normal((n, features), device))
        self.B_im = nn.Parameter(_lecun_normal((n, features), device))
        self.C_re = nn.Parameter(_lecun_normal((features, n), device))
        self.C_im = nn.Parameter(_lecun_normal((features, n), device))
        self.D = nn.Parameter(torch.randn(features, device=device))
        self.log_dt = nn.Parameter(torch.empty(n, device=device).uniform_(math.log(dt_min),
                                                                          math.log(dt_max)))

    def discretize(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A_bar [N], B_bar [N, F]) in complex64, zero-order hold."""
        a = torch.complex(-torch.exp(self.log_A_real), self.A_imag)
        a_bar = torch.exp(a * torch.exp(self.log_dt))
        b_bar = ((a_bar - 1.0) / (a + 1e-8))[:, None] * torch.complex(self.B_re, self.B_im)
        return a_bar, b_bar

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        a_bar, b_bar = self.discretize()
        u32 = u.float()
        # u is real: B_bar u as two real products, [B, S, N]
        bu = torch.complex(u32 @ b_bar.real.T, u32 @ b_bar.imag.T)
        states = linear_scan(a_bar, bu)
        # Re(C x) = C_re x_re - C_im x_im
        y = states.real @ self.C_re.T - states.imag @ self.C_im.T
        return (y + self.D * u32).to(self.dtype or u.dtype)


class BidirectionalS5Layer(nn.Module):
    """Forward and reversed S5 scans, concatenated and projected back."""

    def __init__(self, features: int, state_dim: int = 64, dtype=None, device=None):
        super().__init__()
        self.s5_forward = S5Layer(features, state_dim, dtype=dtype, device=device)
        self.s5_backward = S5Layer(features, state_dim, dtype=dtype, device=device)
        self.out_proj = lecun_dense(2 * features, features, dtype, device)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        y_bwd = self.s5_backward(u.flip(1)).flip(1)
        return self.out_proj(torch.cat([self.s5_forward(u), y_bwd], dim=-1))


class SpatialFusionConv(nn.Module):
    """y + the sum of zero-initialised depthwise 3x3 convolutions at
    dilations 1, 2 and 3 over the patch grid, no bias, "SAME"."""

    def __init__(self, features: int, dilations: Tuple[int, ...] = (1, 2, 3),
                 kernel_size: int = 3, dtype=None, device=None):
        super().__init__()
        self.dilations = dilations
        for dil in dilations:
            self.add_module(f"dwconv_dil{dil}", ConvLayer(
                features, features, (kernel_size, kernel_size), 1, dtype, device,
                init_scale=0.0, groups=features, dilation=dil, use_bias=False))

    def forward(self, y2d: torch.Tensor) -> torch.Tensor:
        out = y2d
        for dil in self.dilations:
            out = out + getattr(self, f"dwconv_dil{dil}")(y2d)
        return out


class SSMDiTBlock(nn.Module):
    """A DiT block whose attention is a (bidirectional) S5 scan along the
    scan order, optionally fused over the (hp, wp) patch grid, which the
    caller passes (``grid_hw``; a square grid is inferred without it)."""

    def __init__(self, features: int, state_dim: int = 64, mlp_ratio: int = 4, dtype=None,
                 norm_epsilon: float = 1e-5, bidirectional: bool = True,
                 use_2d_fusion: bool = False, scan_order: str = "raster",
                 activation: Callable = gelu, device=None):
        super().__init__()
        scan_indices(scan_order, 1, 1)
        self.norm_epsilon, self.activation = norm_epsilon, activation
        self.scan_order = scan_order
        self.ada = AdaLNParams(features, dtype, device)
        self.ssm = (BidirectionalS5Layer(features, state_dim, dtype, device) if bidirectional
                    else S5Layer(features, state_dim, dtype=dtype, device=device))
        self.spatial_fusion = (SpatialFusionConv(features, dtype=dtype, device=device)
                               if use_2d_fusion else None)
        self.mlp_in = lecun_dense(features, features * mlp_ratio, dtype, device)
        self.mlp_out = lecun_dense(features * mlp_ratio, features, dtype, device)

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor, freqs_cis=None,
                grid_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """freqs_cis is accepted and ignored (the DiTBlock interface)."""
        s_mlp, b_mlp, g_mlp, s_attn, b_attn, g_attn = self.ada(conditioning).chunk(6, dim=-1)
        h = self.ssm(modulate(plain_layer_norm(x, self.norm_epsilon), s_attn, b_attn))
        if self.spatial_fusion is not None:
            h = self._fuse_2d(h, grid_hw)
        x = x + g_attn * h
        h = modulate(plain_layer_norm(x, self.norm_epsilon), s_mlp, b_mlp)
        h = self.mlp_out(self.activation(self.mlp_in(h)))
        return x + g_mlp * h

    def _fuse_2d(self, y: torch.Tensor, grid_hw: Optional[Tuple[int, int]]) -> torch.Tensor:
        """Scan order -> the row-major grid, the fusion, and back."""
        b, s, f = y.shape
        if grid_hw is not None:
            hp, wp = grid_hw
            if hp * wp != s:
                raise ValueError(f"grid_hw {grid_hw} != token count {s}")
        else:
            hp = wp = math.isqrt(s)
            if hp * wp != s:
                raise ValueError(f"2D fusion needs grid_hw for non-square grids (S={s})")
        perm = scan_permutation(self.scan_order, hp, wp, y.device)
        if perm is not None:
            y = y.index_select(1, perm[1])
        y = self.spatial_fusion(y.reshape(b, hp, wp, f)).reshape(b, s, f)
        if perm is not None:
            y = y.index_select(1, perm[0])
        return y


def build_block_pattern(num_layers: int, ratio: str = "3:1",
                        pattern: Optional[Sequence[str]] = None) -> List[str]:
    """['ssm', 'ssm', 'ssm', 'attn', ...] from an explicit pattern (repeated
    to the depth) or a ratio: '3:1', '1:1', 'all-ssm', 'all-attn'."""
    if pattern is not None:
        out = list(pattern)
        if any(b not in ("ssm", "attn") for b in out):
            raise ValueError(f"invalid block pattern {out}")
        return (out * (num_layers // len(out) + 1))[:num_layers]
    if ratio == "all-ssm":
        return ["ssm"] * num_layers
    if ratio == "all-attn":
        return ["attn"] * num_layers
    n_ssm, n_attn = (int(p) for p in ratio.split(":"))
    unit = ["ssm"] * n_ssm + ["attn"] * n_attn
    return (unit * (num_layers // len(unit) + 1))[:num_layers]


class HybridSSMAttentionDiT(nn.Module):
    """Interleaved SSM and attention DiT blocks over scan-ordered patch
    tokens with the 2D sin-cos table (the SSM blocks' only positional
    signal); RoPE is the identity in the Hilbert and zigzag orders."""

    def __init__(self, output_channels: int = 3, patch_size: int = 16, emb_features: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 ssm_state_dim: int = 64, backend: str = "auto", dtype=None,
                 precision: Optional[str] = None, force_fp32_for_softmax: bool = True,
                 norm_epsilon: float = 1e-5, learn_sigma: bool = False,
                 use_hilbert: bool = False, use_zigzag: bool = False,
                 block_pattern: Optional[Sequence[str]] = None,
                 ssm_attention_ratio: str = "3:1", bidirectional_ssm: bool = True,
                 use_2d_fusion: bool = False, activation: Union[str, Callable] = "gelu",
                 in_channels: int = 3, context_dim: Optional[int] = None,
                 device: DeviceLike = None):
        super().__init__()
        if use_hilbert and use_zigzag:
            raise ValueError("use_hilbert and use_zigzag are mutually exclusive")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        activation = resolve_activation(activation)
        self.scan_order = "hilbert" if use_hilbert else "zigzag" if use_zigzag else "raster"
        self.output_channels, self.patch_size = output_channels, patch_size
        self.emb_features, self.num_heads, self.learn_sigma = emb_features, num_heads, learn_sigma
        d = emb_features
        self.embed = ScanPatchEmbed(in_channels, patch_size, d, self.scan_order, dtype=dtype,
                                    device=device)
        self.cond = TimeTextEmbedding(d, mlp_ratio, context_dim, dtype, device)
        self.pattern = build_block_pattern(num_layers, ssm_attention_ratio, block_pattern)
        for i, kind in enumerate(self.pattern):
            if kind == "ssm":
                self.add_module(f"ssm_block_{i}", SSMDiTBlock(
                    d, ssm_state_dim, mlp_ratio, dtype, norm_epsilon, bidirectional_ssm,
                    use_2d_fusion, self.scan_order, activation, device))
            else:
                self.add_module(f"attn_block_{i}", DiTBlock(d, num_heads, mlp_ratio, backend,
                                                            dtype, norm_epsilon, device,
                                                            activation))
        self.final_norm = LayerNorm(d, norm_epsilon, device)
        out_dim = patch_size ** 2 * output_channels * (2 if learn_sigma else 1)
        self.final_proj = Dense(d, out_dim, torch.float32, device, init_scale=0.0)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        _, h, w, _ = x.shape
        p = self.patch_size
        hp, wp = h // p, w // p
        tokens, inv_idx = self.embed(x)
        cond = self.cond(temb, textcontext)
        freqs = scan_rope(self.emb_features // self.num_heads, hp * wp, self.scan_order,
                          x.device)
        for i, kind in enumerate(self.pattern):
            if kind == "ssm":
                tokens = getattr(self, f"ssm_block_{i}")(tokens, cond, grid_hw=(hp, wp))
            else:
                tokens = getattr(self, f"attn_block_{i}")(tokens, cond, freqs)
        tokens = self.final_proj(self.final_norm(tokens))
        if self.learn_sigma:
            tokens = tokens.chunk(2, dim=-1)[0]
        c = self.output_channels
        if inv_idx is not None:
            return sfc_unpatchify(tokens, inv_idx, p, h, w, c)
        return unpatchify(tokens, p, h, w, c)
