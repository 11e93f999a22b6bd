from .base import DataAugmenter, DataSource, MediaDataset
from .images import ImageAugmenter, MemoryImageSource

__all__ = ["DataAugmenter", "DataSource", "ImageAugmenter", "MediaDataset", "MemoryImageSource"]
