"""The port's native (C++) library, bound with ctypes: the packed-record
reader (``packed_reader.cpp``, the port's own copy of the JAX package's) and
the PNG unfilter of the image codec (``png.cpp``).

``library()`` compiles both sources with ``g++`` into one shared library at
first use (never at import), in ``build/native/`` beside the package, named
by a hash of the sources so an edited source rebuilds. The compiler writes to
a process-unique temporary path that is renamed into place, so processes
racing the first build never load a half-written library. A failed build
raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "packed_reader.cpp", HERE / "png.cpp")
BUILD_DIR = HERE.parents[1] / "build" / "native"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_P, _U64, _U32, _I32, _I64 = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int32,
                              ctypes.c_int64)
_U64P = ctypes.POINTER(ctypes.c_uint64)
# name -> (restype, argtypes)
_SIGNATURES = {
    "pr_open": (_P, [ctypes.c_char_p]),
    "pr_num_records": (_U64, [_P]),
    "pr_record_length": (_U64, [_P, _U64]),
    "pr_record_ptr": (_P, [_P, _U64]),
    "pr_read_record": (_U64, [_P, _U64, _P, _U64]),
    "pr_version": (_U32, [_P]),
    "pr_batch_length": (_U64, [_P, _U64P, _U64]),
    "pr_read_batch": (_U64, [_P, _U64P, _U64, _P, _U64, _U64P]),
    "pr_prefetch": (None, [_P, _U64P, _U64]),
    "pr_verify_record": (_I32, [_P, _U64]),
    "pr_verify_all": (_U64, [_P]),
    "pr_close": (None, [_P]),
    "png_unfilter": (_I64, [_P, _P, _I64, _I64, _I32]),
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if the one for these sources is missing; return
    its path."""
    lib = BUILD_DIR / f"libflaxdiff_native_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("native build failed: g++ not found") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
