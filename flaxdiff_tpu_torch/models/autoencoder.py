"""Autoencoders for latent diffusion (counterpart of
``flaxdiff_tpu/models/autoencoder.py``).

A codec maps images [B, H, W, C] (or clips [B, T, H, W, C], folded into
frames and back) to latents and back: ``encode(x, noise=None)`` returns the
scaled latent, the posterior's mean without `noise`, a sample with it
(mean + exp(logvar / 2) noise, logvar clipped to [-30, 20]); ``decode(z)``
undoes the scale and decodes. The JAX codecs draw that noise from a key; here
it is a tensor the caller passes, of the posterior mean's shape (clips
folded: [B*T, h, w, c]), so one draw can feed both packages.

``scaling_factor`` is read at every call, as the JAX package passes it to its
jitted functions as an argument: set it after measuring the latents' std and
the next call uses it. The codecs run on the card unless given
``device="cpu"``, and their parameters never take gradients: latent
diffusion trains the prior with the codec frozen.

``KLAutoEncoder`` is the JAX package's first-party KL VAE: its encoder and
decoder are stacks of the port's ``ResidualBlock`` (no time embedding), so
each GroupNorm + SiLU runs the fused kernels, as in JAX.
``StableDiffusionVAE`` wraps diffusers' pretrained VAE in the JAX package;
the port has neither diffusers nor the weights, and refuses it
(``SDVAE`` in ``sd_vae.py`` is the same architecture, first-party).
"""
from __future__ import annotations

import contextlib
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..typing import resolve_dtype
from .common import ConvLayer, Downsample, GroupNorm, ResidualBlock, Upsample


class AutoEncoder(ABC):
    """What every latent-diffusion codec offers; ``encode`` and ``decode``
    fold a clip's frames into the batch and back."""

    @abstractmethod
    def __encode__(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        ...

    @abstractmethod
    def __decode__(self, z: torch.Tensor) -> torch.Tensor:
        ...

    @staticmethod
    def _flat_apply(fn: Callable, x: torch.Tensor, **kwargs) -> torch.Tensor:
        if x.ndim == 5:
            b, t = x.shape[:2]
            out = fn(x.reshape(-1, *x.shape[2:]), **kwargs)
            return out.reshape(b, t, *out.shape[1:])
        return fn(x, **kwargs)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._flat_apply(self.__encode__, x, noise=noise)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._flat_apply(self.__decode__, z)

    def __call__(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(x, noise))

    def to(self, device: DeviceLike) -> "AutoEncoder":
        """Move the codec's parameters to `device` (no-op without any)."""
        return self

    @property
    @abstractmethod
    def downscale_factor(self) -> int:
        ...

    @property
    @abstractmethod
    def latent_channels(self) -> int:
        ...

    @property
    @abstractmethod
    def name(self) -> str:
        ...

    @abstractmethod
    def serialize(self) -> Dict[str, Any]:
        ...


class IdentityAutoEncoder(AutoEncoder):
    """Pixel-space no-op codec (downscale 1)."""

    def __init__(self, channels: int = 3):
        self._channels = channels

    def __encode__(self, x, noise=None):
        return x

    def __decode__(self, z):
        return z

    @property
    def downscale_factor(self) -> int:
        return 1

    @property
    def latent_channels(self) -> int:
        return self._channels

    @property
    def name(self) -> str:
        return "identity"

    def serialize(self) -> Dict[str, Any]:
        return {"channels": self._channels}


# --- the first-party KL VAE ---------------------------------------------------------

class KLEncoder(nn.Module):
    """Image -> concatenated (mean, logvar) of the latent Gaussian."""

    def __init__(self, in_channels: int = 3, latent_channels: int = 4,
                 block_channels: Sequence[int] = (64, 128, 256), layers_per_block: int = 2,
                 norm_groups: int = 8, dtype=None, device=None):
        super().__init__()
        chans = tuple(block_channels)
        self.chans, self.layers = chans, layers_per_block
        self.conv_in = ConvLayer(in_channels, chans[0], (3, 3), 1, dtype, device)
        ch = chans[0]
        for i, c in enumerate(chans):
            for j in range(layers_per_block):
                self.add_module(f"down_{i}_{j}", ResidualBlock(ch, c, None, norm_groups, dtype,
                                                               device))
                ch = c
            if i < len(chans) - 1:
                self.add_module(f"downsample_{i}", Downsample(ch, c, dtype, device))
        self.mid = ResidualBlock(ch, chans[-1], None, norm_groups, dtype, device)
        self.norm_out = GroupNorm(chans[-1], norm_groups, device=device)
        self.conv_out = ConvLayer(chans[-1], 2 * latent_channels, (3, 3), 1, torch.float32,
                                  device)
        self.quant_conv = ConvLayer(2 * latent_channels, 2 * latent_channels, (1, 1), 1,
                                    torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(len(self.chans)):
            for j in range(self.layers):
                h = getattr(self, f"down_{i}_{j}")(h)
            if i < len(self.chans) - 1:
                h = getattr(self, f"downsample_{i}")(h)
        h = self.conv_out(torch.nn.functional.silu(self.norm_out(self.mid(h))))
        return self.quant_conv(h)


class KLDecoder(nn.Module):
    """Latent -> image; `block_channels` in the encoder's order."""

    def __init__(self, out_channels: int = 3, latent_channels: int = 4,
                 block_channels: Sequence[int] = (64, 128, 256), layers_per_block: int = 2,
                 norm_groups: int = 8, dtype=None, device=None):
        super().__init__()
        chans = tuple(block_channels)[::-1]
        self.chans, self.layers = chans, layers_per_block
        self.post_quant_conv = ConvLayer(latent_channels, chans[0], (1, 1), 1, dtype, device)
        self.conv_in = ConvLayer(chans[0], chans[0], (3, 3), 1, dtype, device)
        self.mid = ResidualBlock(chans[0], chans[0], None, norm_groups, dtype, device)
        ch = chans[0]
        for i, c in enumerate(chans):
            for j in range(layers_per_block):
                self.add_module(f"up_{i}_{j}", ResidualBlock(ch, c, None, norm_groups, dtype,
                                                             device))
                ch = c
            if i < len(chans) - 1:
                self.add_module(f"upsample_{i}", Upsample(ch, chans[i + 1], dtype, device))
                ch = chans[i + 1]
        self.norm_out = GroupNorm(ch, norm_groups, device=device)
        self.conv_out = ConvLayer(ch, out_channels, (3, 3), 1, torch.float32, device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(self.post_quant_conv(z)))
        for i in range(len(self.chans)):
            for j in range(self.layers):
                h = getattr(self, f"up_{i}_{j}")(h)
            if i < len(self.chans) - 1:
                h = getattr(self, f"upsample_{i}")(h)
        return self.conv_out(torch.nn.functional.silu(self.norm_out(h)))


def gaussian_sample(moments: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of concatenated (mean, logvar) without `noise`; with it,
    mean + exp(logvar / 2) noise, logvar clipped to [-30, 20]. `noise` holds
    the mean's elements (any shape of that size)."""
    mean, logvar = moments.chunk(2, dim=-1)
    if noise is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * noise.reshape(mean.shape).to(mean.dtype)


def kl_divergence(moments: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, 1)) per batch element."""
    mean, logvar = moments.chunk(2, dim=-1)
    logvar = logvar.clamp(-30.0, 20.0)
    return 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar).sum(
        dim=tuple(range(1, mean.ndim)))


@contextlib.contextmanager
def seeded_init(seed: int):
    """The modules' own initializers from a torch seed, the global RNG left
    as it was: a codec built from a seed has the same weights on every
    device (it is built on the CPU and moved)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


class ModuleCodec(AutoEncoder):
    """A codec over a torch module ``net`` whose ``moments(x)`` gives the
    concatenated (mean, logvar) and ``decode(z)`` the image from an unscaled
    latent: the counterpart of the JAX ``JittedVAE``."""

    net: nn.Module

    def _init_net(self, net: nn.Module, scaling_factor: float, downscale: int,
                  latent_channels: int, device: torch.device) -> None:
        self.net = net.to(device).eval().requires_grad_(False)
        self.scaling_factor = scaling_factor
        self._downscale, self._latent_channels = downscale, latent_channels
        self.device = device

    def to(self, device: DeviceLike) -> "ModuleCodec":
        self.device = torch.device(device)
        self.net.to(self.device)
        return self

    def load_flax_params(self, params: Mapping) -> "ModuleCodec":
        """Load the JAX codec's parameter tree (``convert.state_dict_from_flax``);
        every parameter must be given."""
        from ..convert import state_dict_from_flax
        self.net.load_state_dict(state_dict_from_flax(self.net, params), strict=True)
        return self

    def __encode__(self, x, noise=None):
        return gaussian_sample(self.net.moments(x), noise) * float(self.scaling_factor)

    def __decode__(self, z):
        return self.net.decode(z / float(self.scaling_factor))

    @property
    def downscale_factor(self) -> int:
        return self._downscale

    @property
    def latent_channels(self) -> int:
        return self._latent_channels


class _KLNet(nn.Module):
    def __init__(self, encoder: KLEncoder, decoder: KLDecoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def moments(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)


class KLAutoEncoder(ModuleCodec):
    """The first-party KL VAE: ``KLAutoEncoder.create(seed, ...)`` for weights
    from a seed, ``load_flax_params`` for the JAX codec's. The input has
    ``in_channels`` (default: ``out_channels``), which flax infers."""

    def __init__(self, *, latent_channels: int = 4, out_channels: int = 3,
                 block_channels: Sequence[int] = (64, 128, 256), layers_per_block: int = 2,
                 norm_groups: int = 8, scaling_factor: float = 1.0, dtype=None,
                 in_channels: Optional[int] = None, device: DeviceLike = None):
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self._out_channels = out_channels
        self._block_channels = tuple(block_channels)
        self._layers_per_block, self._norm_groups = layers_per_block, norm_groups
        in_channels = out_channels if in_channels is None else in_channels
        net = _KLNet(KLEncoder(in_channels, latent_channels, self._block_channels,
                               layers_per_block, norm_groups, dtype),
                     KLDecoder(out_channels, latent_channels, self._block_channels,
                               layers_per_block, norm_groups, dtype))
        self._init_net(net, scaling_factor, 2 ** (len(self._block_channels) - 1),
                       latent_channels, device)

    @classmethod
    def create(cls, seed: int = 0, *, input_channels: int = 3,
               **kwargs) -> "KLAutoEncoder":
        """Fresh weights from a torch seed (built on the CPU, then moved)."""
        kwargs.setdefault("out_channels", input_channels)
        kwargs.setdefault("in_channels", input_channels)
        with seeded_init(seed):
            codec = cls(**{**kwargs, "device": "cpu"})
        return codec.to(resolve_device(kwargs.get("device")))

    @property
    def name(self) -> str:
        return "kl_vae"

    def serialize(self) -> Dict[str, Any]:
        return {
            "latent_channels": self._latent_channels,
            "out_channels": self._out_channels,
            "block_channels": list(self._block_channels),
            "layers_per_block": self._layers_per_block,
            "norm_groups": self._norm_groups,
            "scaling_factor": self.scaling_factor,
        }


class StableDiffusionVAE:
    """The JAX package's wrapper over diffusers' pretrained SD VAE. It needs
    diffusers and the published weights, neither of which the port has:
    ``SDVAE.from_torch_state_dict`` / ``SDVAE.from_npz`` load those weights
    into the same architecture once they are at hand."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "stable_diffusion wraps diffusers' FlaxAutoencoderKL and downloads "
            "CompVis/stable-diffusion-v1-4's VAE weights (ROADMAP.md A9's rest); load "
            "converted weights with SDVAE.from_npz (--autoencoder sd_vae "
            "--autoencoder_opts '{\"npz\": ...}') instead")


def _sd_vae(**kwargs):
    from .sd_vae import SDVAE
    if "npz" in kwargs:
        return SDVAE.from_npz(kwargs.pop("npz"), **kwargs)
    return SDVAE.create(kwargs.pop("seed", 0), **kwargs)


def _kl_vae(**kwargs):
    return KLAutoEncoder.create(kwargs.pop("seed", 0), **kwargs)


AUTOENCODER_REGISTRY: Dict[str, Callable[..., Any]] = {
    "identity": IdentityAutoEncoder,
    "kl_vae": _kl_vae,
    "sd_vae": _sd_vae,
    "stable_diffusion": StableDiffusionVAE,
}


def build_autoencoder(name: str, **opts) -> AutoEncoder:
    """The codec `name` of ``AUTOENCODER_REGISTRY`` from its options (the
    CLI's ``--autoencoder_opts``): ``seed`` for random weights, ``npz`` for
    ``sd_vae``'s converted weights, ``device`` (CUDA unless "cpu")."""
    if name not in AUTOENCODER_REGISTRY:
        raise ValueError(f"unknown autoencoder {name!r}; known: {sorted(AUTOENCODER_REGISTRY)}")
    if name == "identity":
        opts.pop("device", None)
    return AUTOENCODER_REGISTRY[name](**opts)
