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
ignored, the softmax being f32 on every path.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import resolve_dtype
from .attention import TransformerBlock
from .common import (ConvLayer, Downsample, FourierEmbedding, ResidualBlock, TimeProjection,
                     Upsample)


class Unet(nn.Module):
    def __init__(self, output_channels: int = 3, emb_features: int = 256,
                 feature_depths: Sequence[int] = (64, 128, 256, 512),
                 attention_configs: Optional[Sequence[Optional[dict]]] = None,
                 num_res_blocks: int = 2, num_middle_res_blocks: int = 1,
                 norm_groups: int = 8, in_channels: int = 3,
                 context_dim: Optional[int] = None, dtype=None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.feature_depths = tuple(feature_depths)
        self.attention_configs = attention_configs
        self.num_res_blocks = num_res_blocks
        self.num_middle_res_blocks = num_middle_res_blocks
        levels = len(self.feature_depths)
        # which levels carry a transformer block (the middle follows the last)
        self.attn_levels = tuple(self._attn_cfg(lv) is not None for lv in range(levels))

        def resblock(name, cin, cout):
            self.add_module(name, ResidualBlock(cin, cout, emb_features, norm_groups,
                                                dtype, device))

        def attn_block(name, cfg, feats, self_and_cross=None):
            cfg = dict(cfg)
            if cfg.get("only_pure_attention", False):
                raise ValueError("only_pure_attention is not ported yet")
            if self_and_cross is None:
                self_and_cross = cfg.get("use_self_and_cross", True)
            self.add_module(name, TransformerBlock(
                feats, context_dim, heads=cfg.get("heads", 4),
                dim_head=cfg.get("dim_head", 64), depth=cfg.get("depth", 1),
                backend=cfg.get("backend", "auto"), dtype=dtype,
                use_projection=cfg.get("use_projection", False),
                use_self_and_cross=self_and_cross, device=device))

        self.time_embed = FourierEmbedding(emb_features, device)
        self.time_proj = TimeProjection(emb_features, dtype, device)
        d0 = self.feature_depths[0]
        self.conv_in = ConvLayer(in_channels, d0, (3, 3), 1, dtype, device)

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

        self.conv_mid_out = ConvLayer(ch, d0, (3, 3), 1, dtype, device)
        resblock("final_res", d0 + d0, d0)
        self.final_norm = nn.GroupNorm(norm_groups, d0, eps=1e-6, device=device)
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
        blk = lambda name: getattr(self, name)
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
                x = blk(f"down_{level}_downsample")(x)

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
                x = blk(f"up_{level}_upsample")(x)

        x = self.conv_mid_out(x)
        x = torch.cat([x, first_skip], dim=-1)
        x = self.final_res(x, temb)
        # a plain f32 GroupNorm + swish, as in the JAX model (not a kernel there)
        x = self.final_norm(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.conv_out(F.silu(x))

    def load_flax_params(self, params: Mapping, fourier_freqs: np.ndarray) -> "Unet":
        """Load a flax parameter tree of the JAX ``Unet`` and its Fourier
        frequencies (see ``convert.unet_state_dict_from_flax``)."""
        from ..convert import unet_state_dict_from_flax
        self.load_state_dict(unet_state_dict_from_flax(params, fourier_freqs), strict=True)
        return self
