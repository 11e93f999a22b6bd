"""Data: the synthetic source and the packed-record shards, the image codec,
the batch iterator and the prefetchers (counterpart of ``flaxdiff_tpu/data``)."""
from .codec import decode_png, encode_png
from .dataloaders import iterate_batches
from .dataset_map import (DATASET_REGISTRY, UNPORTED_DATASETS, MediaDataset, get_dataset,
                          register_dataset)
from .packed_records import (PackedRecordReader, PackedRecordSource, PackedRecordWriter,
                             decode_standard_record, pack_record, unpack_record,
                             write_image_dataset)
from .prefetch import prefetch_map, prefetch_to_device
from .sharded_source import LocalFileSystem, PythonPackedReader, ShardedPackedRecordSource

__all__ = ["DATASET_REGISTRY", "UNPORTED_DATASETS", "LocalFileSystem", "MediaDataset",
           "PackedRecordReader", "PackedRecordSource", "PackedRecordWriter",
           "PythonPackedReader", "ShardedPackedRecordSource", "decode_png",
           "decode_standard_record", "encode_png", "get_dataset", "iterate_batches",
           "pack_record", "prefetch_map", "prefetch_to_device", "register_dataset",
           "unpack_record", "write_image_dataset"]
