"""The port's image codec: PNG without OpenCV or PIL.

The JAX package encodes a record's image with ``cv2.imencode`` and decodes it
with ``cv2.imdecode`` (``flaxdiff_tpu/data/packed_records.py:277-292``,
``online_loader.py:172-179``); the card's machine has neither OpenCV nor PIL.

- ``encode_png``: 8-bit RGB, filter 0 (None) on every row, deflated with the
  standard library's ``zlib``.
- ``decode_png``: 8-bit gray, gray + alpha, RGB and RGBA, not interlaced:
  zlib's inflate, then the five scanline filters undone by the port's native
  library (``native/png.cpp``: Average and Paeth are sequential along a
  row). Returns [H, W, 3] RGB uint8, as ``cv2.imdecode(..., IMREAD_COLOR)``
  then ``COLOR_BGR2RGB`` does (gray repeated, alpha dropped).

JPEG bytes raise a ``ValueError`` that names ROADMAP.md A11's rest: the card's
machine has no JPEG decoder, and the port has none of its own yet.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> channels (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] (or [H, W]) uint8 -> PNG bytes, 8-bit RGB (or gray)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_png takes [H, W, 3] or [H, W] uint8, got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    color = 2 if image.ndim == 3 else 0
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] RGB uint8 (see the module docstring)."""
    from .. import native

    data = bytes(data)
    if data.startswith(JPEG_SIGNATURE):
        raise ValueError("JPEG image: the port decodes PNG only; the card's machine has no JPEG "
                         "decoder (ROADMAP.md A11's rest). Pack the corpus as PNG")
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("image decode failed: neither PNG nor JPEG bytes")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG truncated")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, interlace {interlace}: "
                         "the codec reads 8-bit gray, gray + alpha, RGB and RGBA, not interlaced")
    ch = _CHANNELS[color]
    stride = w * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, {h} rows of {stride + 1} expected")
    out = np.empty((h, w, ch), np.uint8)
    bad = native.library().png_unfilter(raw, out.ctypes.data_as(ctypes.c_void_p), h, stride, ch)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    if ch < 3:
        return np.repeat(out[..., :1], 3, axis=-1)
    return out[..., :3] if ch == 4 else out
