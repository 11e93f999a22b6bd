"""Diffusion Transformer with RoPE and AdaLN-Zero
(counterpart of ``flaxdiff_tpu/models/dit.py``).

``SimpleDiT``: patch tokens in raster, Hilbert or zigzag order, the 2D
sin-cos table, a pooled time + text conditioning vector, ``num_layers``
``DiTBlock``s and an f32 LayerNorm + projection back to patches. Each block
modulates two parameter-free LayerNorms and gates two residuals with
AdaLN-Zero, through the LayerNorm + modulate and gated-residual kernels (the
JAX package's ``fused_epilogues`` path, its default). ``fused_epilogues=False``
is the caller's choice of JAX's unfused composition (a parameter-free f32
LayerNorm, ``modulate`` and ``x + g h`` in plain ops), never a fallback.
``remat`` recomputes each block in the backward pass. Torch needs the input
widths up front: ``in_channels`` and ``context_dim`` (None: no text context).
``precision`` and ``force_fp32_for_softmax`` are accepted and have no effect.

``cache_mode`` is the training-free caches' forward contract
(``ops/diffcache.py``, ``ops/spatialcache.py``): "record" and "record_ref"
run the plain block sequence and also return the deep trunk's residual delta
(and the shallow activations, the spatial cache's score reference); "reuse"
adds a recorded delta to fresh shallow activations instead of running the
deep blocks; "spatial" runs the deep blocks on the top-k changed tokens and
writes their delta and reference entries back.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.fused_adaln import fused_gate_residual, fused_ln_modulate
from ..ops.spatialcache import gather_freqs, gather_tokens, scatter_tokens, select_tokens
from ..typing import gelu, resolve_activation, resolve_dtype, resolve_precision
from .common import Dense, remat_call
from .sfc import sfc_unpatchify, unpatchify
from .vit_common import (AdaLNParams, LayerNorm, RoPEAttention, ScanPatchEmbed,
                         TimeTextEmbedding, modulate, plain_layer_norm, scan_rope)

CACHE_MODES = (None, "record", "record_ref", "reuse", "spatial")


def check_cache_mode(cache_mode: Optional[str]) -> None:
    if cache_mode not in CACHE_MODES:
        raise ValueError(f"unknown cache_mode {cache_mode!r}")


def split_index(num_layers: int, depth_fraction: float) -> int:
    """The flat trunk's cache split: blocks [0, split) always run, [split,
    num_layers) form the cached deep trunk. Python's round (half to even),
    as the JAX models."""
    if num_layers < 2:
        raise ValueError("diffusion cache needs num_layers >= 2 (no deep trunk to cache "
                         "below that)")
    return max(1, min(num_layers - 1, round(num_layers * depth_fraction)))


def cached_trunk(run_block: Callable, num_layers: int, tokens: torch.Tensor,
                 freqs: Optional[Tuple[torch.Tensor, torch.Tensor]], cache_mode: str,
                 cache_split: int, cache_taps, cache_ref, cache_keep: float, cache_metric: str):
    """The flat trunk under a cache mode (SimpleDiT, SimpleMMDiT):
    `run_block(i, tokens, freqs)` runs block i. Returns (tokens for the tail,
    taps, ref); taps and ref are None where the mode makes none."""
    split = int(cache_split)
    if not 0 < split < num_layers:
        raise ValueError(f"cache_split {split} out of range for {num_layers} blocks")
    for i in range(split):
        tokens = run_block(i, tokens, freqs)
    if cache_mode in ("record", "record_ref"):
        deep = tokens
        for i in range(split, num_layers):
            deep = run_block(i, deep, freqs)
        return deep, deep - tokens, tokens
    if cache_mode == "reuse":
        if cache_taps is None:
            raise ValueError("cache_mode='reuse' requires cache_taps")
        return tokens + cache_taps, None, None
    if cache_taps is None or cache_ref is None:
        raise ValueError("cache_mode='spatial' requires cache_taps and cache_ref")
    idx = select_tokens(tokens, cache_ref, cache_keep, cache_metric)
    sel = gather_tokens(tokens, idx)
    freqs_sel = gather_freqs(freqs, idx)
    deep = sel
    for i in range(split, num_layers):
        deep = run_block(i, deep, freqs_sel)
    taps = scatter_tokens(cache_taps, idx, deep - sel)
    return tokens + taps, taps, scatter_tokens(cache_ref, idx, sel)


def cache_outputs(out: torch.Tensor, cache_mode: Optional[str], taps, ref):
    """What a ``cache_mode`` forward returns: out; (out, taps) for "record";
    (out, taps, ref) for "record_ref" and "spatial"."""
    if cache_mode == "record":
        return out, taps
    if cache_mode in ("record_ref", "spatial"):
        return out, taps, ref
    return out


def gate_residual(x: torch.Tensor, gate: torch.Tensor, h: torch.Tensor, fused: bool
                  ) -> torch.Tensor:
    """x + gate h: the gated-residual kernel, or JAX's unfused composition."""
    return fused_gate_residual(x, gate, h) if fused else x + gate * h


def ln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float,
                fused: bool) -> torch.Tensor:
    """modulate(LayerNorm(x), scale, shift): the LayerNorm + modulate kernel,
    or JAX's unfused composition."""
    if fused:
        return fused_ln_modulate(x, scale, shift, eps)
    return modulate(plain_layer_norm(x, eps), scale, shift)


class DiTBlock(nn.Module):
    """Gated RoPE self-attention and a gated MLP, both modulated by
    AdaLN-Zero. The projection splits as s_mlp, b_mlp, g_mlp, s_attn,
    b_attn, g_attn. ``activation`` is the MLP's (tanh-gelu by default)."""

    def __init__(self, features: int, num_heads: int, mlp_ratio: int = 4, backend: str = "auto",
                 dtype=None, norm_epsilon: float = 1e-5, device=None,
                 activation: Callable = gelu, fused_epilogues: bool = True):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"features {features} not divisible by {num_heads} heads")
        self.norm_epsilon = norm_epsilon
        self.activation, self.fused = activation, fused_epilogues
        self.ada = AdaLNParams(features, dtype, device)
        self.attn = RoPEAttention(features, num_heads, features // num_heads, backend, dtype,
                                  device=device)
        self.mlp_in = Dense(features, features * mlp_ratio, dtype, device, init_mode="fan_in")
        self.mlp_out = Dense(features * mlp_ratio, features, dtype, device, init_mode="fan_in")

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor,
                freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        s_mlp, b_mlp, g_mlp, s_attn, b_attn, g_attn = self.ada(conditioning).chunk(6, dim=-1)
        h = ln_modulate(x, s_attn, b_attn, self.norm_epsilon, self.fused)
        x = gate_residual(x, g_attn, self.attn(h, freqs_cis=freqs_cis), self.fused)
        h = ln_modulate(x, s_mlp, b_mlp, self.norm_epsilon, self.fused)
        h = self.mlp_out(self.activation(self.mlp_in(h)))
        return gate_residual(x, g_mlp, h, self.fused)


class SimpleDiT(nn.Module):
    def __init__(self, output_channels: int = 3, patch_size: int = 16, emb_features: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: int = 4,
                 backend: str = "auto", dtype=None, norm_epsilon: float = 1e-5,
                 learn_sigma: bool = False, remat: bool = False, use_hilbert: bool = False,
                 use_zigzag: bool = False, in_channels: int = 3,
                 context_dim: Optional[int] = None, device: DeviceLike = None,
                 activation: Union[str, Callable] = "gelu", fused_epilogues: bool = True,
                 precision: Optional[str] = None, force_fp32_for_softmax: bool = True):
        super().__init__()
        if use_hilbert and use_zigzag:
            raise ValueError("use_hilbert and use_zigzag are mutually exclusive")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        activation = resolve_activation(activation)
        self.remat = remat
        self.scan_order = "hilbert" if use_hilbert else "zigzag" if use_zigzag else "raster"
        self.output_channels, self.patch_size = output_channels, patch_size
        self.emb_features, self.num_heads = emb_features, num_heads
        self.num_layers, self.learn_sigma = num_layers, learn_sigma
        self.embed = ScanPatchEmbed(in_channels, patch_size, emb_features, self.scan_order,
                                    dtype=dtype, device=device)
        self.cond = TimeTextEmbedding(emb_features, mlp_ratio, context_dim, dtype, device)
        for i in range(num_layers):
            self.add_module(f"block_{i}", DiTBlock(emb_features, num_heads, mlp_ratio, backend,
                                                   dtype, norm_epsilon, device, activation,
                                                   fused_epilogues))
        self.final_norm = LayerNorm(emb_features, norm_epsilon, device)
        out_dim = patch_size ** 2 * output_channels * (2 if learn_sigma else 1)
        self.final_proj = Dense(emb_features, out_dim, torch.float32, device, init_scale=0.0)

    def head(self, x: torch.Tensor, temb: torch.Tensor, textcontext: Optional[torch.Tensor] = None):
        """Everything before the trunk: (tokens, conditioning, RoPE tables,
        inverse scan permutation or None)."""
        p = self.patch_size
        tokens, inv_idx = self.embed(x)
        cond = self.cond(temb, textcontext)
        freqs = scan_rope(self.emb_features // self.num_heads, (x.shape[1] // p) * (x.shape[2] // p),
                          self.scan_order, x.device)
        return tokens, cond, freqs, inv_idx

    def tail(self, tokens: torch.Tensor, inv_idx: Optional[torch.Tensor], height: int,
             width: int) -> torch.Tensor:
        """Everything after the trunk: f32 norm and projection, the
        log-variance half dropped with ``learn_sigma``, unpatchify."""
        tokens = self.final_proj(self.final_norm(tokens))
        if self.learn_sigma:
            tokens = tokens.chunk(2, dim=-1)[0]
        p, c = self.patch_size, self.output_channels
        if inv_idx is not None:
            return sfc_unpatchify(tokens, inv_idx, p, height, width, c)
        return unpatchify(tokens, p, height, width, c)

    def cache_split_index(self, depth_fraction: float) -> int:
        """The trunk split for the training-free caches (ops/diffcache.py):
        blocks [0, split) always run, [split, num_layers) are cached."""
        return split_index(self.num_layers, depth_fraction)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None, cache_mode: Optional[str] = None,
                cache_split: int = 0, cache_taps: Optional[torch.Tensor] = None,
                cache_ref: Optional[torch.Tensor] = None, cache_keep: float = 1.0,
                cache_metric: str = "l2"):
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32; under a `cache_mode`, the
        outputs of ``cache_outputs``."""
        check_cache_mode(cache_mode)
        tokens, cond, freqs, inv_idx = self.head(x, temb, textcontext)
        run_block = lambda i, h, fr: remat_call(getattr(self, f"block_{i}"), self.remat, h,
                                                 cond, fr)
        taps = ref = None
        if cache_mode is None:
            for i in range(self.num_layers):
                tokens = run_block(i, tokens, freqs)
        else:
            tokens, taps, ref = cached_trunk(run_block, self.num_layers, tokens, freqs,
                                             cache_mode, cache_split, cache_taps, cache_ref,
                                             cache_keep, cache_metric)
        return cache_outputs(self.tail(tokens, inv_idx, x.shape[1], x.shape[2]), cache_mode,
                             taps, ref)

    def load_flax_params(self, params: Mapping, fourier_freqs: Optional[np.ndarray] = None
                         ) -> "SimpleDiT":
        """Load a flax parameter tree of the JAX ``SimpleDiT`` (see
        ``convert.state_dict_from_flax``); without ``fourier_freqs`` the
        port's table of the JAX draws stays."""
        from ..convert import state_dict_from_flax
        state = state_dict_from_flax(self, params, fourier_freqs)
        if fourier_freqs is None:
            state["cond.t_fourier.freqs"] = self.cond.t_fourier.freqs
        self.load_state_dict(state, strict=True)
        return self
