"""The dtype, precision and activation names of the JAX package's policy,
mapped to their torch counterparts, and the mixed-precision ``Policy``
(counterpart of ``flaxdiff_tpu/typing.py`` ``DTYPE_MAP``, ``PRECISION_MAP``,
``ACTIVATION_MAP`` and ``Policy``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F

DTYPE_MAP: dict[str, Optional[torch.dtype]] = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "none": None,
    "": None,
}

# XLA's matmul precisions. They are accepted and have no effect: the port's
# f32 matmuls and convolutions follow the process's TF32 switches
# (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32).
PRECISION_MAP: dict[str, Optional[str]] = {
    "default": "default",
    "high": "high",
    "highest": "highest",
    "none": None,
    "": None,
}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu``: slope 0.01."""
    return F.leaky_relu(x, 0.01)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.hard_swish``: x relu6(x + 3) / 6."""
    return x * F.relu6(x + 3.0) / 6.0


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


# swish and silu are one function, as in JAX, so either name takes the
# fused GroupNorm + SiLU kernels
ACTIVATION_MAP: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "swish": F.silu,
    "silu": F.silu,
    "gelu": gelu,
    "relu": F.relu,
    "leaky_relu": leaky_relu,
    "tanh": torch.tanh,
    "mish": mish,
    "hard_swish": hard_swish,
}


def resolve_dtype(d: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    if d is None or isinstance(d, torch.dtype):
        return d
    key = d.lower()
    if key not in DTYPE_MAP:
        raise ValueError(f"Unknown dtype {d!r}; known: {sorted(DTYPE_MAP)}")
    return DTYPE_MAP[key]


def resolve_precision(p: Optional[str]) -> Optional[str]:
    if p is None:
        return None
    key = str(p).lower()
    if key not in PRECISION_MAP:
        raise ValueError(f"Unknown precision {p!r}; known: {sorted(PRECISION_MAP)}")
    return PRECISION_MAP[key]


def resolve_activation(a: Union[str, Callable]) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(a):
        return a
    key = a.lower()
    if key not in ACTIVATION_MAP:
        raise ValueError(f"Unknown activation {a!r}; known: {sorted(ACTIVATION_MAP)}")
    return ACTIVATION_MAP[key]


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Which dtype parameters are kept in, the model computes in and its
    output is returned in. The train step casts the network's input to
    `compute_dtype`; the models cast their f32 parameters to their own
    dtype at each use, so a model built with ``dtype=compute_dtype``
    computes what the JAX step's ``cast_to_compute(params)`` computes.
    A float16 compute dtype makes ``DiffusionTrainer`` keep a dynamic loss
    scale (``trainer/loss_scale.py``), as the JAX trainer does."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def _cast(self, tree: Any, dtype: torch.dtype) -> Any:
        return _tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                         and x.is_floating_point() else x, tree)

    def cast_to_compute(self, tree: Any) -> Any:
        """Every floating tensor of `tree` (a tensor, dict, list or tuple)
        in the compute dtype; anything else as it is."""
        return self._cast(tree, self.compute_dtype)

    def cast_to_param(self, tree: Any) -> Any:
        return self._cast(tree, self.param_dtype)
