"""A seeded, shuffled, epoch-wise batch iterator over a ``MediaDataset``
(the port's stand-in for ``flaxdiff_tpu/data/dataloaders.py``'s grain
loader; grain's order is not reproduced)."""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np

from .sources.base import MediaDataset


def iterate_batches(dataset: MediaDataset, batch_size: int, seed: int = 0,
                    start_batch: int = 0) -> Iterator[Dict[str, Any]]:
    """Endless {"sample": [B, H, W, C] uint8, "text": [B captions]} batches.

    Epoch e visits the records in ``default_rng([seed, e]).permutation``
    order, drops the remainder, and record i's augmentation draws from
    ``default_rng([seed, e, i])``. The stream is a function of (seed, batch
    index) alone, so `start_batch` resumes it exactly where an interrupted
    run left off: a resumed training run sees the batches the uninterrupted
    one would have."""
    source = dataset.get_source()
    n = len(source)
    per_epoch = n // batch_size
    if per_epoch == 0:
        raise ValueError(f"{n} records are fewer than one batch of {batch_size}")
    transform = dataset.augmenter.create_transform()
    epoch, offset = divmod(start_batch, per_epoch)
    while True:
        order = np.random.default_rng([seed, epoch]).permutation(n)
        for b in range(offset, per_epoch):
            recs = [transform(source[i], np.random.default_rng([seed, epoch, int(i)]))
                    for i in order[b * batch_size:(b + 1) * batch_size]]
            batch: Dict[str, Any] = {"sample": np.stack([r["image"] for r in recs])}
            if "text" in recs[0]:
                batch["text"] = [r["text"] for r in recs]
            yield batch
        epoch, offset = epoch + 1, 0
