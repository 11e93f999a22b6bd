"""The dtype names of the JAX package's policy, mapped to torch dtypes
(counterpart of ``flaxdiff_tpu/typing.py`` ``DTYPE_MAP``)."""
from __future__ import annotations

from typing import Optional, Union

import torch

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


def resolve_dtype(d: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    if d is None or isinstance(d, torch.dtype):
        return d
    key = d.lower()
    if key not in DTYPE_MAP:
        raise ValueError(f"Unknown dtype {d!r}; known: {sorted(DTYPE_MAP)}")
    return DTYPE_MAP[key]
