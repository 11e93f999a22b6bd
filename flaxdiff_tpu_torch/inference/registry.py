"""Model registry and architecture-name parsing (counterpart of
``flaxdiff_tpu/inference/registry.py``)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..models import SimpleDiT, Unet

MODEL_REGISTRY: Dict[str, Any] = {"unet": Unet, "simple_dit": SimpleDiT}

# the JAX registry's other names, each with the ROADMAP.md item that ports it
NOT_PORTED = {"uvit": "A7", "simple_udit": "A7", "simple_mmdit": "A7",
              "hierarchical_mmdit": "A7", "hybrid_ssm": "A7", "unet_3d": "A9"}

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
    kwargs, on `device` (CUDA unless "cpu" is asked for). Dtype strings
    resolve in the model. A registry name the port lacks, or a kwarg its
    constructor does not take, raises: nothing is dropped silently."""
    base, flags = parse_architecture_name(name)
    if base in NOT_PORTED:
        raise NotImplementedError(f"{base} is not ported yet: ROADMAP.md {NOT_PORTED[base]}")
    if base not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {base!r}; known: {sorted(MODEL_REGISTRY)}")
    merged = {**flags, **kwargs}
    if merged.pop("use_2d_fusion", False):
        raise NotImplementedError("the +2d fusion belongs to the MMDiT family: ROADMAP.md A7")
    return MODEL_REGISTRY[base](**merged, device=device)
