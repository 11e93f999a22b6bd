from .images import ImageAugmenter, MemoryImageSource

__all__ = ["ImageAugmenter", "MemoryImageSource"]
