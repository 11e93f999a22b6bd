"""In-memory images and their augmenter (counterpart of the parts of
``flaxdiff_tpu/data/sources/images.py`` the synthetic dataset uses)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class MemoryImageSource:
    """Records {"image": [H, W, C] uint8, "text": caption} over in-memory
    images and labels (flaxdiff_tpu/data/sources/images.py:67-87, 56-63)."""

    images: np.ndarray                       # [N, H, W, C] uint8
    labels: Optional[Sequence[str]] = None

    def __post_init__(self):
        if self.labels is not None and len(self.labels) != len(self.images):
            raise ValueError("labels length must match images")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = {"image": np.asarray(self.images[int(i)])}
        if self.labels is not None:
            rec["text"] = str(self.labels[int(i)])
        return rec


def _resize(image: np.ndarray, size: int) -> np.ndarray:
    """A square `size` image: unchanged at that size, else area averaging
    to shrink and bicubic to grow, the directions the JAX package's cv2
    resize takes (its bits are not reproduced)."""
    if image.shape[:2] == (size, size):
        return image
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None].float()
    mode = "area" if min(image.shape[:2]) > size else "bicubic"
    y = F.interpolate(x, size=(size, size), mode=mode)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


@dataclasses.dataclass
class ImageAugmenter:
    """resize -> horizontal flip with probability 1/2 -> the caption passed
    through (flaxdiff_tpu/data/sources/images.py:188-225, without caption
    templates or in-loader tokenizing)."""

    image_size: int = 64
    horizontal_flip: bool = True

    def create_transform(self) -> Callable[[Dict[str, Any], np.random.Generator], Dict[str, Any]]:
        def transform(record: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
            image = np.asarray(record["image"])
            if image.ndim == 2:
                image = np.repeat(image[..., None], 3, axis=-1)
            image = _resize(image, self.image_size)
            if self.horizontal_flip and rng.random() < 0.5:
                image = image[:, ::-1]
            out = {"image": np.ascontiguousarray(image)}
            if record.get("text") is not None:
                out["text"] = record["text"]
            return out

        return transform
