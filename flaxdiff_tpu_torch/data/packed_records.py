"""Packed-record files: a Python writer and the native (C++, mmap) reader
(counterpart of ``flaxdiff_tpu/data/packed_records.py``; the same format,
so either package reads what the other writes).

A record is a dict of named byte strings, packed as
``[u32 n]`` then n x ``[u16 keylen][key utf-8][u64 vallen][val bytes]``.
A file is the magic ``FDTR``, a u32 version, a u64 record count, the index
(v1: offset and length, u64 each; v2, what the writer emits: offset, length,
crc32 and a zero u32) and the payload.

Images go in as PNG through the port's own codec (``data/codec.py``): the
JAX writer's ``cv2`` is not on the card's machine. Not ported: the quarantine
journal and the ``data.decode`` fault site (ROADMAP.md A14's data plane).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from .codec import decode_png, encode_png
from .sources.base import DataSource

MAGIC = b"FDTR"
VERSION = 2


def pack_record(entries: Dict[str, bytes]) -> bytes:
    """Serialize a dict of byte strings."""
    out = [struct.pack("<I", len(entries))]
    for key, val in entries.items():
        kb = key.encode("utf-8")
        out += [struct.pack("<H", len(kb)), kb, struct.pack("<Q", len(val)), bytes(val)]
    return b"".join(out)


def unpack_record(data: bytes) -> Dict[str, bytes]:
    """Inverse of ``pack_record``."""
    n, = struct.unpack_from("<I", data, 0)
    pos = 4
    out: Dict[str, bytes] = {}
    for _ in range(n):
        klen, = struct.unpack_from("<H", data, pos)
        pos += 2
        key = data[pos:pos + klen].decode("utf-8")
        pos += klen
        vlen, = struct.unpack_from("<Q", data, pos)
        pos += 8
        out[key] = data[pos:pos + vlen]
        pos += vlen
    return out


class PackedRecordWriter:
    """Streams records to a temporary payload file as they arrive (only the
    24-byte index entry of each stays in memory), then writes header, index
    and payload at ``close``."""

    def __init__(self, path: str):
        self.path = path
        self._payload_path = f"{path}.payload.{os.getpid()}.tmp"
        self._payload = open(self._payload_path, "wb")
        self._index: List[tuple] = []
        self._pos = 0
        self._closed = False

    def write(self, record):
        """Append a record: a dict of byte strings or packed bytes."""
        if self._closed:
            raise ValueError("writer closed")
        blob = record if isinstance(record, (bytes, bytearray)) else pack_record(record)
        self._index.append((self._pos, len(blob), zlib.crc32(blob) & 0xFFFFFFFF))
        self._payload.write(blob)
        self._pos += len(blob)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._payload.close()
        try:
            with open(self.path, "wb") as f:
                f.write(MAGIC + struct.pack("<IQ", VERSION, len(self._index)))
                for off, length, crc in self._index:
                    f.write(struct.pack("<QQII", off, length, crc, 0))
                with open(self._payload_path, "rb") as payload:
                    shutil.copyfileobj(payload, f, length=16 * 1024 * 1024)
        finally:
            os.unlink(self._payload_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PackedRecordReader:
    """The native mmap reader (``native/packed_reader.cpp``)."""

    def __init__(self, path: str):
        from .. import native
        self._lib = native.library()
        self._handle = self._lib.pr_open(path.encode("utf-8"))
        if not self._handle:
            raise IOError(f"could not open packed record file {path!r}")
        self.path = path

    def __len__(self) -> int:
        return int(self._lib.pr_num_records(self._handle))

    def _check(self, idx: int) -> int:
        idx = int(idx)
        if not 0 <= idx < len(self):
            raise IndexError(f"record {idx} out of range (n={len(self)})")
        return idx

    def record_bytes(self, idx: int) -> bytes:
        idx = self._check(idx)
        length = int(self._lib.pr_record_length(self._handle, idx))
        if length == 0:
            return b""
        return ctypes.string_at(self._lib.pr_record_ptr(self._handle, idx), length)

    def __getitem__(self, idx: int) -> Dict[str, bytes]:
        return unpack_record(self.record_bytes(idx))

    @property
    def version(self) -> int:
        return int(self._lib.pr_version(self._handle))

    def read_batch(self, idxs) -> List[bytes]:
        """Many records in two native calls (their total size, then one copy)."""
        idxs = [self._check(i) for i in idxs]
        n = len(idxs)
        if n == 0:
            return []
        arr = (ctypes.c_uint64 * n)(*idxs)
        total = int(self._lib.pr_batch_length(self._handle, arr, n))
        if total == 2 ** 64 - 1:
            raise IOError("batch length query failed")
        buf = ctypes.create_string_buffer(max(total, 1))
        lengths = (ctypes.c_uint64 * n)()
        wrote = int(self._lib.pr_read_batch(self._handle, arr, n, buf, total, lengths))
        if wrote != total:
            raise IOError(f"batch read failed ({wrote} != {total} bytes)")
        mv, out, pos = memoryview(buf), [], 0
        for i in range(n):
            out.append(bytes(mv[pos:pos + lengths[i]]))
            pos += lengths[i]
        return out

    def verify(self, idx: int) -> bool:
        """CRC check of one record (a v1 file has no checksums: True)."""
        return bool(self._lib.pr_verify_record(self._handle, self._check(idx)))

    def verify_all(self) -> int:
        """The number of corrupt records in the file."""
        return int(self._lib.pr_verify_all(self._handle))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pr_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def decode_standard_record(entries: Dict[str, bytes]) -> Dict[str, Any]:
    """A record's image and caption in loader form ({"image": [H, W, 3] RGB
    uint8, "text": str}), under either key naming: ``image``/``caption`` or
    webdataset's ``jpg``/``txt``."""
    rec: Dict[str, Any] = {}
    img = entries.get("image", entries.get("jpg"))
    if img is not None:
        rec["image"] = decode_png(img)
    caption = entries.get("caption", entries.get("txt"))
    if caption is not None:
        rec["text"] = caption.decode("utf-8")
    return rec


class _DecodedRecords:
    def __init__(self, reader: PackedRecordReader):
        self.reader = reader

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return decode_standard_record(self.reader[int(i)])


@dataclasses.dataclass
class PackedRecordSource(DataSource):
    """A DataSource over one packed record file, decoding the standard
    image and caption entries."""

    path: str

    def get_source(self, path_override: Optional[str] = None):
        return _DecodedRecords(PackedRecordReader(path_override or self.path))


def write_image_dataset(path: str, images: Iterable[np.ndarray],
                        captions: Optional[Iterable[str]] = None):
    """Pack [H, W, 3] uint8 RGB images (and captions) into one record file,
    each image as PNG."""
    captions = list(captions) if captions is not None else None
    with PackedRecordWriter(path) as w:
        for i, img in enumerate(images):
            rec = {"image": encode_png(np.asarray(img))}
            if captions is not None:
                rec["caption"] = captions[i].encode("utf-8")
            w.write(rec)
