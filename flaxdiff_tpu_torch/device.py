"""The device rule: entry points run on the card unless asked otherwise."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA. Asking for CUDA where there is none raises: there
    is no silent CPU path, the caller passes ``device="cpu"`` for that."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                           "on the CPU")
    return device


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded generator on the resolved device, for every random draw."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen
