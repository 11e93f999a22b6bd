"""Dataset registry (counterpart of ``flaxdiff_tpu/data/dataset_map.py``).

Ported: the offline ``synthetic`` source and the local packed-record corpora,
``packed_shards`` and ``combined_aesthetic`` (images as PNG: the port's codec
reads no JPEG). The JAX registry's other names are listed in
``UNPORTED_DATASETS`` with the ROADMAP.md item that would port them.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .sources.base import MediaDataset
from .sources.images import ImageAugmenter, MemoryImageSource

DATASET_REGISTRY: Dict[str, Callable[..., MediaDataset]] = {}

# the JAX registry's names the port lacks -> why
UNPORTED_DATASETS = {
    "oxford_flowers102_tfds": "TFDS downloads its data, which no run here can fetch "
                              "(ROADMAP.md, not queued)",
    "oxford_flowers102": "HF datasets downloads its data, which no run here can fetch "
                         "(ROADMAP.md, not queued)",
    "video_folder": "the video sources read clips with OpenCV (ROADMAP.md A9's rest)",
    "av_folder": "the audio-video sources read clips with OpenCV and ffmpeg "
                 "(ROADMAP.md A9's rest)",
    "voxceleb2_local": "the audio-video sources read clips with OpenCV and ffmpeg "
                       "(ROADMAP.md A9's rest)",
}


def register_dataset(name: str):
    def deco(fn: Callable[..., MediaDataset]):
        DATASET_REGISTRY[name] = fn
        return fn
    return deco


def get_dataset(name: str, **kwargs) -> MediaDataset:
    if name not in DATASET_REGISTRY:
        why = UNPORTED_DATASETS.get(name)
        raise ValueError(f"dataset {name!r} is not ported: {why}" if why else
                         f"unknown dataset {name!r}; known: {sorted(DATASET_REGISTRY)}")
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


@register_dataset("packed_shards")
def _packed_shards(pattern: str = None, root: str = None, image_size: int = 64,
                   filesystem=None, max_open: int = 16, **kwargs) -> MediaDataset:
    """A sharded packed-record corpus (flaxdiff_tpu/data/dataset_map.py:
    100-118): `pattern` globs the shard files (`root` is the CLI's
    --dataset_path); `filesystem` swaps in an object store (open, glob)."""
    from .sharded_source import ShardedPackedRecordSource
    return MediaDataset(
        source=ShardedPackedRecordSource(pattern=pattern or root, filesystem=filesystem,
                                         max_open=max_open),
        augmenter=ImageAugmenter(image_size=image_size))


# the JAX registry's worked production mix: each part a directory of shards
# under one root, all fused into one global index
# (flaxdiff_tpu/data/dataset_map.py:126-176)
COMBINED_AESTHETIC_PARTS = (
    "laion_aesthetics_12m",   # img2dataset of LAION-aesthetic >= 6
    "cc12m",                  # Conceptual Captions 12M
    "mscoco",                 # MS-COCO train2017
    "coyo_aesthetic_1m",      # COYO-700M aesthetic >= 6 subset
)


@register_dataset("combined_aesthetic")
def _combined_aesthetic(root: str = "/mnt/gcs_mount/flaxdiff-datasets", image_size: int = 256,
                        parts=None, filesystem=None, max_open: int = 64,
                        **kwargs) -> MediaDataset:
    """The text-image pretraining mix over ``<root>/<part>/*.pack`` shards.
    Every named part must hold at least one shard: a missing corpus would
    silently shrink the mix (pass parts=[...] to train on a subset)."""
    from .sharded_source import LocalFileSystem, ShardedPackedRecordSource
    parts = COMBINED_AESTHETIC_PARTS if parts is None else tuple(parts)
    if not parts:
        raise ValueError("combined_aesthetic: parts=[] would silently train on nothing; pass "
                         "None for the full mix")
    fs = filesystem or LocalFileSystem()
    shards, missing = [], []
    for part in parts:
        got = sorted(fs.glob(f"{root}/{part}/*.pack"))
        shards += got
        if not got:
            missing.append(part)
    if missing:
        raise FileNotFoundError(f"combined_aesthetic: no *.pack shards under {root}/ for parts "
                                f"{missing}; pack each corpus first or pass parts=[...] to "
                                "train on a deliberate subset")
    return MediaDataset(
        source=ShardedPackedRecordSource(shards=shards, filesystem=filesystem,
                                         max_open=max_open),
        augmenter=ImageAugmenter(image_size=image_size))
