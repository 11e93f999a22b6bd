"""Input configuration (counterpart of ``flaxdiff_tpu/inputs/config.py``):
one config per conditioning input with its cached null embedding, and the
whole input's config, serialized to the same JSON as the JAX package's so a
``pipeline_config.json`` written by either package reads in the other."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import cfg_uncond_splice
from .encoders import CONDITIONAL_ENCODERS_REGISTRY


@dataclasses.dataclass
class ConditionalInputConfig:
    """One conditioning input: its encoder, batch key and the encoding of
    its unconditional input ("" by default), cached at construction."""

    encoder: Any
    conditioning_data_key: Optional[str] = None
    pretokenized: bool = False
    unconditional_input: Any = None
    model_key_override: Optional[str] = None
    _uncond_cache: Any = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        source = self.unconditional_input if self.unconditional_input is not None else ""
        self._uncond_cache = self.encoder([source])

    @property
    def batch_key(self) -> str:
        return self.conditioning_data_key or self.encoder.key

    @property
    def model_key(self) -> str:
        return self.model_key_override or self.encoder.key

    def __call__(self, batch_data) -> torch.Tensor:
        data = batch_data[self.batch_key]
        if self.pretokenized:
            return self.encoder.encode_from_tokens(data)
        return self.encoder(data)

    def get_unconditional(self) -> torch.Tensor:
        return self._uncond_cache

    def serialize(self) -> Dict[str, Any]:
        enc_cfg = self.encoder.serialize()
        return {
            "encoder": enc_cfg,
            "encoder_key": enc_cfg.get("type", self.encoder.key),
            "conditioning_data_key": self.conditioning_data_key,
            "pretokenized": self.pretokenized,
            "unconditional_input": self.unconditional_input,
            "model_key_override": self.model_key_override,
        }

    @staticmethod
    def deserialize(config: Dict[str, Any], table=None) -> "ConditionalInputConfig":
        """`table`: the hash encoder's embedding table (see encoders.py)."""
        enc_cls = CONDITIONAL_ENCODERS_REGISTRY.get(config["encoder_key"])
        if enc_cls is None:
            raise ValueError(f"Unknown encoder type {config['encoder_key']!r}")
        return ConditionalInputConfig(
            encoder=enc_cls.deserialize(config["encoder"], table=table),
            conditioning_data_key=config.get("conditioning_data_key"),
            pretokenized=config.get("pretokenized", False),
            unconditional_input=config.get("unconditional_input"),
            model_key_override=config.get("model_key_override"),
        )


@dataclasses.dataclass
class DiffusionInputConfig:
    """The sample's batch key and shape, and the conditioning inputs."""

    sample_data_key: str
    sample_data_shape: Tuple[int, ...]
    conditions: List[ConditionalInputConfig]

    def get_input_shapes(self, autoencoder=None, sample_model_key: str = "x",
                         time_embeddings_model_key: str = "temb") -> Dict[str, Tuple[int, ...]]:
        """Each model input's shape without the batch (config.py:84-108): the
        sample's [(T,) H, W, C], its spatial size ceil-divided by a codec's
        downscale factor and its channels the codec's latent channels for
        latent diffusion (`autoencoder`: any object with
        ``downscale_factor`` and ``latent_channels``), the time embedding's
        (), and each condition's null embedding's."""
        if len(self.sample_data_shape) == 3:
            H, W, C = self.sample_data_shape
            lead: Tuple[int, ...] = ()
        elif len(self.sample_data_shape) == 4:
            T, H, W, C = self.sample_data_shape
            lead = (T,)
        else:
            raise ValueError(f"unsupported sample shape {self.sample_data_shape}")
        if autoencoder is not None:
            d = autoencoder.downscale_factor
            # SAME-padded stride-2 convs give ceil(H / 2) per stage
            H, W, C = -(-H // d), -(-W // d), autoencoder.latent_channels
        shapes = {sample_model_key: (*lead, H, W, C), time_embeddings_model_key: ()}
        for cond in self.conditions:
            shapes[cond.model_key] = tuple(cond.get_unconditional()[0].shape)
        return shapes

    def get_unconditionals(self, batch_size: Optional[int] = None) -> List[torch.Tensor]:
        """The cached null embeddings, broadcast to `batch_size` if given
        (the sampler's CFG batch takes them as they are)."""
        out = []
        for c in self.conditions:
            u = c.get_unconditional()
            if batch_size is not None:
                u = u.expand((batch_size,) + tuple(u.shape[1:]))
            out.append(u)
        return out

    def process_conditioning(self, batch_data,
                             uncond_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Every condition encoded from `batch_data`; where `uncond_mask` is
        True, the cached null embedding in its place (CFG dropout,
        config.py:121-132)."""
        results = []
        for cond in self.conditions:
            emb = cond(batch_data)
            if uncond_mask is not None:
                null = torch.as_tensor(cond.get_unconditional()).to(emb.device)
                emb = cfg_uncond_splice(emb, null, torch.as_tensor(uncond_mask, device=emb.device))
            results.append(emb)
        return results

    def serialize(self) -> Dict[str, Any]:
        return {
            "sample_data_key": self.sample_data_key,
            "sample_data_shape": list(self.sample_data_shape),
            "conditions": [c.serialize() for c in self.conditions],
        }

    @staticmethod
    def deserialize(config: Dict[str, Any], table=None) -> "DiffusionInputConfig":
        return DiffusionInputConfig(
            sample_data_key=config["sample_data_key"],
            sample_data_shape=tuple(config["sample_data_shape"]),
            conditions=[ConditionalInputConfig.deserialize(c, table=table)
                        for c in config["conditions"]],
        )
