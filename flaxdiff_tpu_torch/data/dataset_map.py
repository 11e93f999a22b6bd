"""Dataset registry (counterpart of ``flaxdiff_tpu/data/dataset_map.py``).

Only the offline ``synthetic`` source is ported; the HF, TFDS and
ArrayRecord sources need files the repository does not hold (ROADMAP.md
A11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from .sources.images import ImageAugmenter, MemoryImageSource


@dataclasses.dataclass
class MediaDataset:
    """A record source and the augmenter applied to each record."""

    source: MemoryImageSource
    augmenter: ImageAugmenter


DATASET_REGISTRY: Dict[str, Callable[..., MediaDataset]] = {}


def register_dataset(name: str):
    def deco(fn: Callable[..., MediaDataset]):
        DATASET_REGISTRY[name] = fn
        return fn
    return deco


def get_dataset(name: str, **kwargs) -> MediaDataset:
    if name not in DATASET_REGISTRY:
        raise ValueError(f"unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)} "
                         "(the other sources of the JAX package: ROADMAP.md A11)")
    return DATASET_REGISTRY[name](**kwargs)


@register_dataset("synthetic")
def _synthetic(n: int = 256, image_size: int = 64, seed: int = 0, **kwargs) -> MediaDataset:
    """Deterministic two-mode toy distribution, captioned "bright" or
    "dark": the JAX package's generator, draw for draw
    (flaxdiff_tpu/data/dataset_map.py:36-48)."""
    rng = np.random.default_rng(seed)
    signs = rng.choice([0.0, 1.0], size=(n, 1, 1, 1))
    imgs = (signs * 160 + 40 + rng.normal(size=(n, image_size, image_size, 3))
            * 10).clip(0, 255).astype(np.uint8)
    labels = ["bright" if s else "dark" for s in signs[:, 0, 0, 0]]
    return MediaDataset(source=MemoryImageSource(images=imgs, labels=labels),
                        augmenter=ImageAugmenter(image_size=image_size))
