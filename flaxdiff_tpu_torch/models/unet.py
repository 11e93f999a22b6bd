"""Text-conditional UNet (counterpart of ``flaxdiff_tpu/models/unet.py``).

Same block structure and names as the JAX model, so a flax parameter tree
converts name for name (``convert.py``): per-level res blocks with a
transformer block after the last one of each attention level, a middle
res-attention-res whose attention is cross-only, skip concatenation
``[x, skip]`` on the way up, and an f32 GroupNorm + swish + conv output stage.

Unlike flax, torch needs the input widths up front: ``in_channels`` for the
image and ``context_dim`` for the text context (None: no cross-attention).
Attention configs take the JAX package's keys; ``force_fp32_for_softmax``
and the TPU layout keys (``bhld``, ``flash_attention``) are accepted and
ignored, the softmax being f32 on every path. ``precision`` is accepted and
has no effect (f32 matmuls and convolutions follow the TF32 switches).

``remat`` recomputes each residual and transformer block's activations in
the backward pass (``torch.utils.checkpoint``, non-reentrant), as
``nn.remat`` wraps them in JAX; the parameter names do not change.

Two settings the JAX ``Unet`` cannot build raise here too: ``conv_type
"conv_transpose"`` (its ConvLayer strides every convolution by 2, so conv_in
already doubles the resolution and the first residual add fails) and
``norm_groups <= 0`` (``final_norm`` is always a GroupNorm).
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import resolve_activation, resolve_dtype, resolve_precision
from .attention import TransformerBlock
from .common import (ConvLayer, Downsample, FourierEmbedding, GroupNorm, ResidualBlock,
                     TimeProjection, Upsample, remat_call)


class Unet(nn.Module):
    def __init__(self, output_channels: int = 3, emb_features: int = 256,
                 feature_depths: Sequence[int] = (64, 128, 256, 512),
                 attention_configs: Optional[Sequence[Optional[dict]]] = None,
                 num_res_blocks: int = 2, num_middle_res_blocks: int = 1,
                 norm_groups: int = 8, in_channels: int = 3,
                 context_dim: Optional[int] = None, dtype=None,
                 device: DeviceLike = None, conv_type: str = "conv",
                 activation: Union[str, Callable] = "swish", precision: Optional[str] = None,
                 remat: bool = False):
        super().__init__()
        if conv_type == "conv_transpose":
            raise ValueError("conv_type 'conv_transpose' cannot build a Unet: ConvLayer strides "
                             "it by 2, so conv_in doubles the resolution and the first "
                             "residual add fails, as in the JAX package")
        if norm_groups <= 0:
            raise ValueError(f"norm_groups {norm_groups}: the Unet's final_norm is a GroupNorm "
                             "and needs groups > 0, as in the JAX package")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        resolve_precision(precision)
        self.activation = resolve_activation(activation)
        self.remat = remat
        self.feature_depths = tuple(feature_depths)
        self.attention_configs = attention_configs
        self.num_res_blocks = num_res_blocks
        self.num_middle_res_blocks = num_middle_res_blocks
        levels = len(self.feature_depths)
        # which levels carry a transformer block (the middle follows the last)
        self.attn_levels = tuple(self._attn_cfg(lv) is not None for lv in range(levels))

        def resblock(name, cin, cout):
            self.add_module(name, ResidualBlock(cin, cout, emb_features, norm_groups,
                                                dtype, device, self.activation, conv_type))

        def attn_block(name, cfg, feats, self_and_cross=None):
            cfg = dict(cfg)
            if self_and_cross is None:
                self_and_cross = cfg.get("use_self_and_cross", True)
            self.add_module(name, TransformerBlock(
                feats, context_dim, heads=cfg.get("heads", 4),
                dim_head=cfg.get("dim_head", 64), depth=cfg.get("depth", 1),
                backend=cfg.get("backend", "auto"), dtype=dtype,
                use_projection=cfg.get("use_projection", False),
                use_self_and_cross=self_and_cross, device=device,
                only_pure_attention=cfg.get("only_pure_attention", False)))

        self.time_embed = FourierEmbedding(emb_features, device)
        self.time_proj = TimeProjection(emb_features, emb_features, dtype, device)
        d0 = self.feature_depths[0]
        self.conv_in = ConvLayer(in_channels, d0, (3, 3), 1, dtype, device, conv_type=conv_type)

        # down path: track channel widths to size each layer
        ch, skip_ch = d0, []
        for level, feats in enumerate(self.feature_depths):
            cfg = self._attn_cfg(level)
            for block in range(num_res_blocks):
                resblock(f"down_{level}_res_{block}", ch, feats)
                ch = feats
                if cfg is not None and block == num_res_blocks - 1:
                    attn_block(f"down_{level}_attn", cfg, feats)
                skip_ch.append(ch)
            if level < levels - 1:
                self.add_module(f"down_{level}_downsample",
                                Downsample(ch, feats, dtype=dtype, device=device))

        mid = self.feature_depths[-1]
        mid_cfg = self._attn_cfg(levels - 1)
        for block in range(num_middle_res_blocks):
            resblock(f"mid_res1_{block}", ch, mid)
            if mid_cfg is not None:
                attn_block(f"mid_attn_{block}", mid_cfg, mid, self_and_cross=False)
            resblock(f"mid_res2_{block}", mid, mid)
            ch = mid

        for rev, feats in enumerate(reversed(self.feature_depths)):
            level = levels - 1 - rev
            cfg = self._attn_cfg(level)
            for block in range(num_res_blocks):
                resblock(f"up_{level}_res_{block}", ch + skip_ch.pop(), feats)
                ch = feats
                if cfg is not None and block == num_res_blocks - 1:
                    attn_block(f"up_{level}_attn", cfg, feats)
            if level > 0:
                nxt = self.feature_depths[level - 1]
                self.add_module(f"up_{level}_upsample",
                                Upsample(ch, nxt, dtype=dtype, device=device))
                ch = nxt

        self.conv_mid_out = ConvLayer(ch, d0, (3, 3), 1, dtype, device, conv_type=conv_type)
        resblock("final_res", d0 + d0, d0)
        self.final_norm = GroupNorm(d0, norm_groups, device=device)
        self.conv_out = ConvLayer(d0, output_channels, (3, 3), 1, torch.float32, device,
                                  init_scale=0.0)

    def _attn_cfg(self, level: int) -> Optional[dict]:
        if self.attention_configs is None:
            return None
        cfg = self.attention_configs[level]
        return dict(cfg) if cfg else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                textcontext: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, C_in], temb [B], textcontext [B, L, context_dim]
        -> [B, H, W, output_channels] in f32."""
        # the residual and transformer blocks, checkpointed with remat
        blk = lambda name: functools.partial(remat_call, getattr(self, name), self.remat)
        levels = len(self.feature_depths)
        temb = self.time_proj(self.time_embed(temb))
        x = self.conv_in(x)
        first_skip = x
        skips = []
        for level in range(levels):
            attn = self.attn_levels[level]
            for block in range(self.num_res_blocks):
                x = blk(f"down_{level}_res_{block}")(x, temb)
                if attn and block == self.num_res_blocks - 1:
                    x = blk(f"down_{level}_attn")(x, textcontext)
                skips.append(x)
            if level < levels - 1:
                x = getattr(self, f"down_{level}_downsample")(x)

        mid_attn = self.attn_levels[-1]
        for block in range(self.num_middle_res_blocks):
            x = blk(f"mid_res1_{block}")(x, temb)
            if mid_attn:
                x = blk(f"mid_attn_{block}")(x, textcontext)
            x = blk(f"mid_res2_{block}")(x, temb)

        for level in reversed(range(levels)):
            attn = self.attn_levels[level]
            for block in range(self.num_res_blocks):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = blk(f"up_{level}_res_{block}")(x, temb)
                if attn and block == self.num_res_blocks - 1:
                    x = blk(f"up_{level}_attn")(x, textcontext)
            if level > 0:
                x = getattr(self, f"up_{level}_upsample")(x)

        x = self.conv_mid_out(x)
        x = torch.cat([x, first_skip], dim=-1)
        x = blk("final_res")(x, temb)
        # a plain f32 GroupNorm + the activation, as in the JAX model (not a
        # kernel there)
        return self.conv_out(self.activation(self.final_norm(x)))

    def load_flax_params(self, params: Mapping, fourier_freqs: np.ndarray) -> "Unet":
        """Load a flax parameter tree of the JAX ``Unet`` and its Fourier
        frequencies (see ``convert.state_dict_from_flax``)."""
        from ..convert import state_dict_from_flax
        self.load_state_dict(state_dict_from_flax(self, params, fourier_freqs), strict=True)
        return self
