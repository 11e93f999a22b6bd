"""Conditioning inputs: the hash text encoder and the input configuration
(counterpart of ``flaxdiff_tpu/inputs``)."""
from .config import ConditionalInputConfig, DiffusionInputConfig
from .encoders import (CONDITIONAL_ENCODERS_REGISTRY, CLIPTextEncoder, HashTextEncoder,
                       HashTokenizer, MelAudioEncoder)

__all__ = ["CONDITIONAL_ENCODERS_REGISTRY", "CLIPTextEncoder", "ConditionalInputConfig",
           "DiffusionInputConfig", "HashTextEncoder", "HashTokenizer", "MelAudioEncoder"]
