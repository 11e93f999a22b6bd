"""The Stable Diffusion VAE, AutoencoderKL (counterpart of
``flaxdiff_tpu/models/sd_vae.py``), NHWC.

Resnet stacks of plain GroupNorm (eps 1e-6, f32) + SiLU + 3x3 convolution,
a 1x1 ``conv_shortcut`` where the width changes; downsampling pads one row
and column at the bottom and right, then a VALID stride-2 convolution;
upsampling is nearest 2x then a 3x3 convolution; the middle block has one
single-head attention over the H*W tokens, its scores and softmax in f32
and the probabilities cast to v's dtype; 1x1 quant and post-quant
convolutions around the latent. None of it is a Pallas kernel in the JAX
package, so it stays plain PyTorch here (convolutions, ``torch.matmul``).

Module names follow the flax tree, so ``convert.state_dict_from_flax``
loads a JAX ``SDVAE``'s params; ``SDVAE.from_torch_state_dict`` takes
diffusers' ``AutoencoderKL`` names directly (modern ``to_q``/``to_out.0``
and legacy ``query``/``proj_attn`` attention keys, 1x1-conv attention
weights included) and infers the architecture from the shapes;
``SDVAE.from_npz`` loads the flax-path npz ``scripts/convert_sd_vae_weights.py``
writes.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import resolve_dtype
from ..convert import flax_tree
from .autoencoder import ModuleCodec, seeded_init
from .common import ConvLayer, Dense, GroupNorm, Upsample


class SDResnetBlock(nn.Module):
    """diffusers ResnetBlock2D without a time embedding."""

    def __init__(self, in_features: int, features: int, norm_groups: int = 32,
                 eps: float = 1e-6, dtype=None, device=None):
        super().__init__()
        self.norm1 = GroupNorm(in_features, norm_groups, eps, device)
        self.conv1 = ConvLayer(in_features, features, (3, 3), 1, dtype, device)
        self.norm2 = GroupNorm(features, norm_groups, eps, device)
        self.conv2 = ConvLayer(features, features, (3, 3), 1, dtype, device)
        self.conv_shortcut = (ConvLayer(in_features, features, (1, 1), 1, dtype, device)
                              if in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class SDAttnBlock(nn.Module):
    """Single-head self-attention over the H*W tokens, plus the input."""

    def __init__(self, channels: int, norm_groups: int = 32, eps: float = 1e-6, dtype=None,
                 device=None):
        super().__init__()
        self.group_norm = GroupNorm(channels, norm_groups, eps, device)
        dense = lambda: Dense(channels, channels, dtype, device, init_mode="fan_in")
        self.to_q, self.to_k, self.to_v, self.to_out = dense(), dense(), dense(), dense()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.group_norm(x).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        scores = torch.matmul(q, k.transpose(1, 2)).float()
        attn = torch.softmax(scores * (1.0 / math.sqrt(c)), dim=-1)
        out = self.to_out(torch.matmul(attn.to(v.dtype), v))
        return x + out.reshape(b, hh, ww, c)


class SDDownsample(nn.Module):
    """Pad (0, 1, 0, 1), then a VALID stride-2 3x3 convolution."""

    def __init__(self, channels: int, dtype=None, device=None):
        super().__init__()
        self.conv = ConvLayer(channels, channels, (3, 3), 2, dtype, device, padding="VALID")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class SDBlock(nn.Module):
    """A down block (resnets, then ``downsamplers_0``) or an up block
    (resnets, then ``upsamplers_0``)."""

    def __init__(self, in_features: int, features: int, num_layers: int, resample: Optional[str],
                 norm_groups: int, dtype=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for j in range(num_layers):
            self.add_module(f"resnets_{j}", SDResnetBlock(in_features if j == 0 else features,
                                                          features, norm_groups, 1e-6, dtype,
                                                          device))
        self.resample = resample
        if resample == "down":
            self.downsamplers_0 = SDDownsample(features, dtype, device)
        elif resample == "up":
            self.upsamplers_0 = Upsample(features, features, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(self.num_layers):
            x = getattr(self, f"resnets_{j}")(x)
        if self.resample == "down":
            x = self.downsamplers_0(x)
        elif self.resample == "up":
            x = self.upsamplers_0(x)
        return x


class SDMidBlock(nn.Module):
    def __init__(self, channels: int, norm_groups: int = 32, dtype=None, device=None):
        super().__init__()
        self.resnets_0 = SDResnetBlock(channels, channels, norm_groups, 1e-6, dtype, device)
        self.attentions_0 = SDAttnBlock(channels, norm_groups, 1e-6, dtype, device)
        self.resnets_1 = SDResnetBlock(channels, channels, norm_groups, 1e-6, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets_1(self.attentions_0(self.resnets_0(x)))


class SDEncoder(nn.Module):
    """Image -> concatenated (mean, logvar), before the quant conv."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, norm_groups: int = 32, dtype=None, device=None):
        super().__init__()
        chans = tuple(block_out_channels)
        self.levels = len(chans)
        self.conv_in = ConvLayer(in_channels, chans[0], (3, 3), 1, dtype, device)
        ch = chans[0]
        for i, c in enumerate(chans):
            self.add_module(f"down_blocks_{i}", SDBlock(
                ch, c, layers_per_block, "down" if i < len(chans) - 1 else None, norm_groups,
                dtype, device))
            ch = c
        self.mid_block = SDMidBlock(ch, norm_groups, dtype, device)
        self.conv_norm_out = GroupNorm(ch, norm_groups, 1e-6, device)
        self.conv_out = ConvLayer(ch, 2 * latent_channels, (3, 3), 1, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(self.levels):
            h = getattr(self, f"down_blocks_{i}")(h)
        h = self.conv_norm_out(self.mid_block(h))
        return self.conv_out(F.silu(h))


class SDDecoder(nn.Module):
    """Latent (after the post-quant conv) -> image."""

    def __init__(self, out_channels: int = 3, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, norm_groups: int = 32, dtype=None, device=None):
        super().__init__()
        chans = tuple(block_out_channels)[::-1]
        self.levels = len(chans)
        self.conv_in = ConvLayer(latent_channels, chans[0], (3, 3), 1, dtype, device)
        self.mid_block = SDMidBlock(chans[0], norm_groups, dtype, device)
        ch = chans[0]
        for i, c in enumerate(chans):
            self.add_module(f"up_blocks_{i}", SDBlock(
                ch, c, layers_per_block + 1, "up" if i < len(chans) - 1 else None, norm_groups,
                dtype, device))
            ch = c
        self.conv_norm_out = GroupNorm(ch, norm_groups, 1e-6, device)
        self.conv_out = ConvLayer(ch, out_channels, (3, 3), 1, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for i in range(self.levels):
            h = getattr(self, f"up_blocks_{i}")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _SDNet(nn.Module):
    def __init__(self, encoder: SDEncoder, decoder: SDDecoder, latent_channels: int,
                 device=None):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        two = 2 * latent_channels
        conv = lambda c: ConvLayer(c, c, (1, 1), 1, torch.float32, device, init_mode="fan_in")
        self.quant_conv, self.post_quant_conv = conv(two), conv(latent_channels)

    def moments(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# --- diffusers state dicts ----------------------------------------------------------

_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out"}


def convert_sd_vae_torch_state_dict(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{diffusers AutoencoderKL name: array} -> {'/'-joined flax path: array}
    of the JAX ``SDVAE``'s tree: list indices join their module's name
    (``down_blocks.0.resnets.1`` -> ``down_blocks_0/resnets_1``), legacy
    attention names map to the modern ones, conv OIHW -> HWIO, linear
    OI -> IO (a 1x1-conv attention projection -> its matrix). An unknown name
    raises."""
    out = {}
    for name, value in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        value = np.asarray(value.float().cpu() if isinstance(value, torch.Tensor) else value)
        parts = name.split(".")
        leaf, mod = parts[-1], []
        for p in parts[:-1]:
            if p.isdigit():
                if mod and mod[-1] == "to_out":
                    continue  # Sequential[Linear, Dropout]
                if not mod:
                    raise ValueError(f"unmapped torch name: {name!r}")
                mod[-1] = f"{mod[-1]}_{p}"
            else:
                mod.append(_LEGACY_ATTN.get(p, p))
        path = "/".join(mod)
        if leaf == "weight" and value.ndim == 4:
            if mod[-1] in ("to_q", "to_k", "to_v", "to_out") and value.shape[2:] == (1, 1):
                out[f"{path}/kernel"] = value[:, :, 0, 0].T
            else:
                out[f"{path}/kernel"] = value.transpose(2, 3, 1, 0)
        elif leaf == "weight" and value.ndim == 2:
            out[f"{path}/kernel"] = value.T
        elif leaf == "weight" and value.ndim == 1:
            out[f"{path}/scale"] = value
        elif leaf == "bias":
            out[f"{path}/bias"] = value.reshape(-1)
        else:
            raise ValueError(f"unmapped torch name: {name!r}")
    return out


class SDVAE(ModuleCodec):
    """The SD VAE: ``SDVAE.create(seed)`` for weights from a seed,
    ``from_torch_state_dict`` / ``from_npz`` for pretrained ones,
    ``load_flax_params`` for a JAX ``SDVAE``'s tree."""

    def __init__(self, *, latent_channels: int = 4, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, norm_groups: int = 32,
                 scaling_factor: float = 0.18215, dtype=None, in_channels: Optional[int] = None,
                 device: DeviceLike = None):
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self._out_channels = out_channels
        self._block_out_channels = tuple(block_out_channels)
        self._layers_per_block, self._norm_groups = layers_per_block, norm_groups
        in_channels = out_channels if in_channels is None else in_channels
        net = _SDNet(SDEncoder(in_channels, latent_channels, self._block_out_channels,
                               layers_per_block, norm_groups, dtype),
                     SDDecoder(out_channels, latent_channels, self._block_out_channels,
                               layers_per_block, norm_groups, dtype),
                     latent_channels)
        self._init_net(net, scaling_factor, 2 ** (len(self._block_out_channels) - 1),
                       latent_channels, device)

    @classmethod
    def create(cls, seed: int = 0, *, input_channels: int = 3,
               **kwargs) -> "SDVAE":
        """Fresh weights from a torch seed (built on the CPU, then moved)."""
        kwargs.setdefault("out_channels", input_channels)
        kwargs.setdefault("in_channels", input_channels)
        with seeded_init(seed):
            codec = cls(**{**kwargs, "device": "cpu"})
        return codec.to(resolve_device(kwargs.get("device")))

    @classmethod
    def from_torch_state_dict(cls, state: Mapping[str, Any], *, norm_groups: int = 32,
                              **kwargs) -> "SDVAE":
        """Weights from diffusers' ``AutoencoderKL`` state dict, or from the
        flax paths ``convert_sd_vae_torch_state_dict`` makes of one (every
        key holding a '/'); the architecture from the shapes."""
        if not state:
            raise ValueError("empty SD-VAE state dict (truncated or corrupt checkpoint/npz?)")
        flat = dict(state) if all("/" in k for k in state) \
            else convert_sd_vae_torch_state_dict(state)
        try:
            latent = flat["post_quant_conv/kernel"].shape[-1]
            in_ch = flat["encoder/conv_in/kernel"].shape[2]
            out_ch = flat["decoder/conv_out/kernel"].shape[-1]
        except KeyError as e:
            raise ValueError(f"SD-VAE state dict is missing required key {e} — not an "
                             "AutoencoderKL checkpoint?") from e
        chans, layers = [], 0
        while f"encoder/down_blocks_{len(chans)}/resnets_0/conv1/kernel" in flat:
            chans.append(flat[f"encoder/down_blocks_{len(chans)}/resnets_0/conv1/kernel"]
                         .shape[-1])
        while f"encoder/down_blocks_0/resnets_{layers}/conv1/kernel" in flat:
            layers += 1
        kwargs.setdefault("latent_channels", latent)
        kwargs.setdefault("block_out_channels", tuple(chans))
        kwargs.setdefault("layers_per_block", layers)
        kwargs.setdefault("out_channels", out_ch)
        kwargs.setdefault("norm_groups", norm_groups)
        kwargs.setdefault("in_channels", in_ch)
        device = resolve_device(kwargs.pop("device", None))
        with seeded_init(0):
            codec = cls(**kwargs, device="cpu")
        return codec.load_flax_params(flax_tree(flat)).to(device)

    @classmethod
    def from_npz(cls, path: str, **kwargs) -> "SDVAE":
        """Weights from the npz ``scripts/convert_sd_vae_weights.py`` writes."""
        with np.load(path) as npz:
            return cls.from_torch_state_dict({k: npz[k] for k in npz.files}, **kwargs)

    def diffusers_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights under diffusers' ``AutoencoderKL`` names (the modern
        attention keys): what ``from_torch_state_dict`` takes."""
        return {re.sub(r"_(\d+)(?=\.)", r".\1", name).replace(".to_out.", ".to_out.0."): value
                for name, value in self.net.state_dict().items()}

    @property
    def name(self) -> str:
        return "sd_vae"

    def serialize(self) -> Dict[str, Any]:
        return {
            "latent_channels": self._latent_channels,
            "out_channels": self._out_channels,
            "block_out_channels": list(self._block_out_channels),
            "layers_per_block": self._layers_per_block,
            "norm_groups": self._norm_groups,
            "scaling_factor": self.scaling_factor,
        }
