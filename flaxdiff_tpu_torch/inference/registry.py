"""Model registry and architecture-name parsing (counterpart of
``flaxdiff_tpu/inference/registry.py``)."""
from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple

from ..models import (HierarchicalMMDiT, HybridSSMAttentionDiT, SimpleDiT, SimpleMMDiT,
                      SimpleUDiT, UNet3D, Unet, UViT)

MODEL_REGISTRY: Dict[str, Any] = {
    "unet": Unet,
    "uvit": UViT,
    "simple_dit": SimpleDiT,
    "simple_udit": SimpleUDiT,
    "simple_mmdit": SimpleMMDiT,
    "hierarchical_mmdit": HierarchicalMMDiT,
    "hybrid_ssm": HybridSSMAttentionDiT,
    "unet_3d": UNet3D,
}

# each JAX model's dataclass fields (its constructor keys, flax's ``parent``
# and ``name`` aside). The port's models take every one, except the Unet's
# ``kernel_init``, a flax initializer that no saved config can hold.
_DIT_KEYS = ("output_channels", "patch_size", "emb_features", "num_layers", "num_heads",
             "mlp_ratio", "backend", "dtype", "precision", "force_fp32_for_softmax",
             "norm_epsilon")
JAX_FIELDS: Dict[str, Tuple[str, ...]] = {
    "unet": ("output_channels", "emb_features", "feature_depths", "attention_configs",
             "num_res_blocks", "num_middle_res_blocks", "conv_type", "norm_groups",
             "activation", "dtype", "precision", "kernel_init", "remat"),
    "uvit": ("output_channels", "patch_size", "emb_features", "num_layers", "num_heads",
             "use_projection", "use_self_and_cross", "backend", "force_fp32_for_softmax",
             "activation", "dtype", "precision", "add_residualblock_output", "norm_epsilon",
             "use_hilbert", "max_image_size"),
    "simple_dit": _DIT_KEYS + ("learn_sigma", "remat", "use_hilbert", "use_zigzag",
                               "activation", "fused_epilogues"),
    "simple_udit": _DIT_KEYS + ("use_hilbert", "use_zigzag", "fused_epilogues"),
    "simple_mmdit": _DIT_KEYS + ("learn_sigma", "use_hilbert", "activation",
                                 "fused_epilogues"),
    "hierarchical_mmdit": ("output_channels", "base_patch_size") + _DIT_KEYS[2:] + (
        "learn_sigma", "use_hilbert", "activation", "fused_epilogues"),
    "hybrid_ssm": _DIT_KEYS[:6] + ("ssm_state_dim",) + _DIT_KEYS[6:] + (
        "learn_sigma", "use_hilbert", "use_zigzag", "block_pattern", "ssm_attention_ratio",
        "bidirectional_ssm", "use_2d_fusion", "activation"),
    "unet_3d": ("output_channels", "emb_features", "feature_depths", "attention_levels",
                "num_res_blocks", "heads", "norm_groups", "backend", "dtype", "precision",
                "activation", "remat"),
}
# keys flax infers from the inputs, which torch needs at construction
PORT_KEYS = ("in_channels", "context_dim")
_UNUSABLE = {"unet": {"kernel_init"}}

# suffix -> constructor flag (reference inference/utils.py:168-180)
_SUFFIX_FLAGS = {"hilbert": {"use_hilbert": True}, "zigzag": {"use_zigzag": True},
                 "2d": {"use_2d_fusion": True}}


def parse_architecture_name(name: str) -> Tuple[str, Dict[str, Any]]:
    """'simple_dit+hilbert' -> ('simple_dit', {'use_hilbert': True})."""
    base, *suffixes = name.split("+")
    flags: Dict[str, Any] = {}
    for s in suffixes:
        if s not in _SUFFIX_FLAGS:
            raise ValueError(f"unknown architecture suffix {s!r} in {name!r}")
        flags.update(_SUFFIX_FLAGS[s])
    return base, flags


def build_model(name: str, device=None, **kwargs):
    """The model named `name` (with its suffixes) from its constructor
    kwargs, on `device` (CUDA unless "cpu" is asked for). The dtype,
    precision and activation strings resolve in the model (``typing.py``'s
    maps); a key the JAX model does not take (and that is not one of
    ``PORT_KEYS``) is dropped with a warning, as the JAX registry does, and
    so is a suffix's flag the model lacks. An unknown name raises."""
    base, flags = parse_architecture_name(name)
    if base not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {base!r}; known: {sorted(MODEL_REGISTRY)}")
    merged = {**flags, **kwargs}
    valid = (set(JAX_FIELDS[base]) | set(PORT_KEYS)) - _UNUSABLE.get(base, set())
    dropped = sorted(set(merged) - valid)
    if dropped:
        warnings.warn(f"{name}: ignoring kwargs {dropped}")
    merged = {k: v for k, v in merged.items() if k in valid}
    return MODEL_REGISTRY[base](**merged, device=device)
