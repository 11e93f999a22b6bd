"""Source and augmenter interfaces (counterpart of
``flaxdiff_tpu/data/sources/base.py:14-61``).

A ``DataSource`` gives raw records by index through ``get_source()`` (an
object with ``__len__`` and ``__getitem__``); a ``DataAugmenter`` builds the
per-record transform and an optional filter; ``MediaDataset`` pairs them.
"""
from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Any, Callable, Optional


class DataSource(ABC):
    """Random-access record source."""

    @abstractmethod
    def get_source(self, path_override: Optional[str] = None):
        """An indexable (len + getitem) over raw records."""


class DataAugmenter(ABC):
    """Factory of the per-record transform and filter."""

    @abstractmethod
    def create_transform(self, **kwargs) -> Callable[..., Any]:
        """map(record, rng) -> {"image": ..., "text": ...}."""

    def create_filter(self, **kwargs) -> Optional[Callable[[Any], bool]]:
        """filter(record) -> keep?; None keeps every record."""
        return None


@dataclasses.dataclass
class MediaDataset:
    """A record source and the augmenter applied to each record."""

    source: DataSource
    augmenter: DataAugmenter
    media_type: str = "image"

    def get_source(self, path_override: Optional[str] = None):
        return self.source.get_source(path_override)

    def get_augmenter(self, **kwargs) -> Callable[..., Any]:
        return self.augmenter.create_transform(**kwargs)
