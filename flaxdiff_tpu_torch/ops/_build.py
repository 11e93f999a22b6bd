"""Build and load the port's CUDA kernels (every ``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface (and the CUDA driver library, ``-lcuda``, for the TMA
tensor maps), loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds, not minutes). The library lands in ``build/kernels/`` beside the
package, named by a hash of the sources, so an edited source rebuilds and an
unchanged one loads the existing library.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the driver API, for the TMA tensor maps (cuTensorMapEncodeTiled)
LINK_FLAGS = ["-lcuda"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "flash_fwd": [_P] * 5 + [_I64] * 12 + [_I] * 5 + [_F, _I, _P],
    "flash_bwd_dq": [_P] * 7 + [_I64] * 15 + [_I] * 5 + [_F, _I, _P],
    "flash_bwd_dkv": [_P] * 8 + [_I64] * 15 + [_I] * 5 + [_F, _I, _P],
    "flash_fwd_wide": [_P] * 5 + [_I64] * 12 + [_I] * 5 + [_F, _I, _I64, _P],
    "flash_bwd_dq_wide": [_P] * 7 + [_I64] * 15 + [_I] * 5 + [_F, _I, _P],
    "flash_bwd_dkv_wide": [_P] * 8 + [_I64] * 15 + [_I] * 5 + [_F, _I, _P],
    "gn_stats": [_P, _P] + [_I] * 6 + [_P],
    "gn_norm": [_P] * 6 + [_I] * 6 + [_P],
    "gn_bwd_stats": [_P] * 8 + [_I] * 7 + [_P],
    "gn_bwd_dx": [_P] * 8 + [_I] * 6 + [_P],
    "geglu_fwd": [_P, _P, _I64, _I, _I, _P],
    "geglu_bwd": [_P, _P, _P, _I64, _I, _I, _P],
    "ln_mod_fwd": [_P] * 9 + [_I64, _I, _I, _I64, _I, _F, _I, _P],
    "ln_mod_bwd": [_P] * 9 + [_I, _I, _I, _I64, _I, _I, _I, _P],
    "gate_res_fwd": [_P] * 4 + [_I64, _I, _I, _I64, _I, _P],
    "gate_res_bwd": [_P] * 5 + [_I, _I, _I, _I64, _I, _I, _P],
    "bi_gemm": [_P] * 4 + [_I64, _I, _I, _I, _I, _P],
    "bi_conv": [_P] * 4 + [_I] * 15 + [_P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                           "on a machine with the CUDA toolkit")
    return nvcc


def build() -> Path:
    """Compile the kernels if the library for these sources is missing;
    return its path. The compiler's output goes to ``build.log`` beside it."""
    lib = BUILD_DIR / f"libflaxdiff_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        staged = Path(tmp) / lib.name
        subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(staged),
                        *map(str, objs), *LINK_FLAGS], check=True)
        os.replace(staged, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel does not take dtype {t.dtype}") from None


def require_cuda(*tensors: torch.Tensor) -> None:
    """Every tensor a kernel reads or writes lies on CUDA device 0: the
    library links its own CUDA runtime, whose current device is 0."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel needs CUDA tensors, got {dev}")
    if dev.index not in (None, 0):
        raise ValueError(f"the kernels launch on CUDA device 0 only, got {dev}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
