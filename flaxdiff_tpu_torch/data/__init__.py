"""Data: the synthetic source, its batch iterator and the prefetchers
(counterpart of ``flaxdiff_tpu/data``)."""
from .dataloaders import iterate_batches
from .dataset_map import DATASET_REGISTRY, MediaDataset, get_dataset, register_dataset
from .prefetch import prefetch_map, prefetch_to_device

__all__ = ["DATASET_REGISTRY", "MediaDataset", "get_dataset", "iterate_batches",
           "prefetch_map", "prefetch_to_device", "register_dataset"]
