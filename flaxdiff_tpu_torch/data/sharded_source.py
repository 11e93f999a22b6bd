"""Many packed-record shards as one indexable source (counterpart of
``flaxdiff_tpu/data/sharded_source.py:42-254``).

Local paths (and fuse mounts) read through the native mmap reader
(``data/packed_records.py``); any ``FileSystem``-shaped object (``open``,
``glob``) switches every shard to ``PythonPackedReader``'s seek and read,
for stores that cannot mmap. One global index spans the shards in order:
``locate(i)`` maps a record to its shard and local index, from the shards'
16-byte headers alone. Shards open lazily, and at most ``max_open`` readers
stay open (least recently used dropped). The source pickles without its
readers, for loader worker processes.

Not ported: the quarantine journal and the ``data.decode`` fault site
(ROADMAP.md A14's data plane); a record that does not decode raises.
"""
from __future__ import annotations

import bisect
import dataclasses
import glob as _glob
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, List, Optional, Sequence

from .sources.base import DataSource

_HEADER = struct.Struct("<4sIQ")          # magic, version, record count
_INDEX_V2 = struct.Struct("<QQII")        # offset, length, crc32, pad
_INDEX_V1 = struct.Struct("<QQ")


class LocalFileSystem:
    """Plain local (or fuse-mounted) paths."""

    def open(self, path: str, mode: str = "rb"):
        return open(path, mode)

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(pattern))


def _parse_header(head: bytes, path: str):
    if len(head) < _HEADER.size:
        raise IOError(f"{path!r} is not a packed record file")
    magic, version, n = _HEADER.unpack(head)
    if magic != b"FDTR":
        raise IOError(f"{path!r} is not a packed record file")
    if version not in (1, 2):
        raise IOError(f"{path!r}: unsupported version {version}")
    return version, n


class PythonPackedReader:
    """Packed records over a FileSystem's file object: the header and index
    read once, each record one seek and read."""

    def __init__(self, fs, path: str):
        self._path = path
        self._fh = fs.open(path, "rb")
        self._lock = threading.Lock()    # loader threads share readers
        self.version, n = _parse_header(self._fh.read(_HEADER.size), path)
        entry = _INDEX_V2 if self.version == 2 else _INDEX_V1
        raw = self._fh.read(entry.size * n)
        self._index = [entry.unpack_from(raw, i * entry.size) for i in range(n)]
        self._base = _HEADER.size + entry.size * n

    def __len__(self) -> int:
        return len(self._index)

    def record_bytes(self, idx: int) -> bytes:
        off, length = self._index[idx][:2]
        with self._lock:
            self._fh.seek(self._base + off)
            data = self._fh.read(length)
        if len(data) != length:
            raise IOError(f"short read at record {idx} of {self._path!r}")
        return data

    def verify(self, idx: int) -> bool:
        if self.version < 2:
            return True
        return (zlib.crc32(self.record_bytes(idx)) & 0xFFFFFFFF) == self._index[idx][2]

    def close(self):
        self._fh.close()


class _ShardedRecords:
    def __init__(self, outer: "ShardedPackedRecordSource"):
        self.outer = outer

    def __len__(self) -> int:
        return self.outer._total

    def __getitem__(self, i: int):
        from .packed_records import decode_standard_record, unpack_record
        path, local = self.outer.locate(int(i))
        entries = unpack_record(self.outer._reader(path).record_bytes(local))
        return decode_standard_record(entries) if self.outer.decode else entries


@dataclasses.dataclass
class ShardedPackedRecordSource(DataSource):
    """One global random-access index over many packed-record shards:
    explicit `shards`, or a glob `pattern` resolved through the filesystem
    (`filesystem=None`: local paths and the native reader). `max_open`
    bounds the open readers; `decode=False` yields the raw entry dicts."""

    shards: Optional[Sequence[str]] = None
    pattern: Optional[str] = None
    filesystem: Optional[Any] = None
    max_open: int = 16
    decode: bool = True

    def __post_init__(self):
        fs = self.filesystem or LocalFileSystem()
        paths = list(self.shards) if self.shards else fs.glob(self.pattern)
        if not paths:
            raise FileNotFoundError(f"no packed-record shards match {self.pattern!r}")
        self._paths = paths
        self._starts: List[int] = []
        total = 0
        for p in paths:
            with fs.open(p, "rb") as f:
                _, n = _parse_header(f.read(_HEADER.size), p)
            self._starts.append(total)
            total += n
        self._total = total
        self._readers: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_readers"] = OrderedDict()
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _open_reader(self, path: str):
        if self.filesystem is None:
            from .packed_records import PackedRecordReader
            return PackedRecordReader(path)
        return PythonPackedReader(self.filesystem, path)

    def _reader(self, path: str):
        with self._lock:
            r = self._readers.get(path)
            if r is not None:
                self._readers.move_to_end(path)
                return r
        r = self._open_reader(path)
        with self._lock:
            if path in self._readers:       # another thread opened it first
                r.close()
                return self._readers[path]
            self._readers[path] = r
            while len(self._readers) > self.max_open:
                # dropped, not closed: a reading thread may still hold it;
                # its __del__ closes it after the last user lets go
                self._readers.popitem(last=False)
        return r

    def locate(self, i: int):
        """Global record index -> (shard path, local index)."""
        if not 0 <= i < self._total:
            raise IndexError(f"record {i} out of range (n={self._total})")
        s = bisect.bisect_right(self._starts, i) - 1
        return self._paths[s], i - self._starts[s]

    def get_source(self, path_override: Optional[str] = None):
        if path_override:
            return dataclasses.replace(self, shards=None, pattern=path_override).get_source()
        return _ShardedRecords(self)
