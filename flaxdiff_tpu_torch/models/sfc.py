"""Scan orders for patch tokens (Hilbert, zigzag) and the 2D sin-cos table
(counterpart of ``flaxdiff_tpu/models/sfc.py``).

The index math is the JAX package's numpy, copied: that module imports jax
at its top, and the port imports nothing of it. Every permutation is
computed once per grid shape on the host and uploaded once per device; on
the device a reorder is one ``index_select`` with a constant index.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch


@lru_cache(maxsize=64)
def _hilbert_xy(order: int) -> Tuple[np.ndarray, np.ndarray]:
    """Curve index d -> (x, y) on a 2^order square, vectorized over all
    indices (the classic d2xy decode)."""
    n = 1 << order
    d = np.arange(n * n, dtype=np.int64)
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    t = d.copy()
    s = 1
    while s < n:
        rx = 1 & (t >> 1)
        ry = 1 & (t ^ rx)
        # rotate the quadrant where ry == 0 (mirror when rx == 1)
        rot = ry == 0
        flip = rot & (rx == 1)
        xf = np.where(flip, s - 1 - x, x)
        yf = np.where(flip, s - 1 - y, y)
        x = np.where(rot, yf, xf)
        y = np.where(rot, xf, yf)
        x = x + s * rx
        y = y + s * ry
        t >>= 2
        s <<= 1
    return x, y


@lru_cache(maxsize=64)
def hilbert_indices(h: int, w: int) -> np.ndarray:
    """result[k] is the row-major index of the k-th token along the Hilbert
    curve of an h x w grid: the curve of the smallest enclosing 2^m square,
    keeping the points inside the grid."""
    if h <= 0 or w <= 0:
        raise ValueError(f"grid must be positive, got {h}x{w}")
    order = max(1, math.ceil(math.log2(max(h, w))))
    x, y = _hilbert_xy(order)
    keep = (x < w) & (y < h)
    return (y[keep] * w + x[keep]).astype(np.int32)


@lru_cache(maxsize=64)
def zigzag_indices(h: int, w: int) -> np.ndarray:
    """Serpentine scan: even rows left to right, odd rows right to left."""
    rows = np.arange(h)[:, None] * w + np.arange(w)[None, :]
    rows[1::2] = rows[1::2, ::-1]
    return rows.reshape(-1).astype(np.int32)


def inverse_permutation(idx: np.ndarray, total_size: Optional[int] = None) -> np.ndarray:
    """inv such that inv[idx[k]] = k."""
    idx = np.asarray(idx)
    n = total_size if total_size is not None else idx.shape[0]
    inv = np.zeros(n, dtype=np.int32)
    inv[idx] = np.arange(idx.shape[0], dtype=np.int32)
    return inv


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p p C] in row-major patch order."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, patch_size: int, h: int, w: int,
               channels: int) -> torch.Tensor:
    """Inverse of ``patchify`` for a known (h, w)."""
    b = tokens.shape[0]
    p = patch_size
    x = tokens.reshape(b, h // p, w // p, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, channels)


SCAN_ORDERS = ("raster", "hilbert", "zigzag")


def scan_indices(scan_order: str, hp: int, wp: int) -> Optional[np.ndarray]:
    """The scan order's permutation of an hp x wp grid (``hilbert_indices``
    or ``zigzag_indices``), None for raster."""
    if scan_order == "hilbert":
        return hilbert_indices(hp, wp)
    if scan_order == "zigzag":
        return zigzag_indices(hp, wp)
    if scan_order == "raster":
        return None
    raise ValueError(f"unknown scan_order {scan_order!r}; known: {SCAN_ORDERS}")


@lru_cache(maxsize=64)
def scan_permutation(scan_order: str, hp: int, wp: int, device: torch.device
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(forward, inverse) int64 indices of the scan order on `device`, None
    for raster. Uploaded once per key: an upload from pageable memory waits
    for the host, and a CUDA graph cannot capture it. Made outside inference
    mode, so that a forward with grad may save them for backward after a
    sampler made them. Shared: callers do not write them."""
    idx = scan_indices(scan_order, hp, wp)
    if idx is None:
        return None
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                     for a in (idx, inverse_permutation(idx)))


def sfc_patchify(x: torch.Tensor, patch_size: int, scan_order: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw patches [B, N, p p C] reordered into the scan order (hilbert or
    zigzag), and the inverse permutation that ``sfc_unpatchify`` needs."""
    _, h, w, _ = x.shape
    fwd, inv = scan_permutation(scan_order, h // patch_size, w // patch_size, x.device)
    return patchify(x, patch_size).index_select(1, fwd), inv


def sfc_unpatchify(tokens: torch.Tensor, inv_idx: torch.Tensor, patch_size: int, h: int,
                   w: int, channels: int) -> torch.Tensor:
    """Row-major order restored by a gather with the inverse permutation,
    then unpatchify."""
    return unpatchify(tokens.index_select(1, inv_idx), patch_size, h, w, channels)


def _sincos_1d(dim: int, positions: np.ndarray) -> np.ndarray:
    """[len(positions), dim] transformer sin-cos table, in float64."""
    if dim % 2:
        raise ValueError(f"1d sincos dim must be even, got {dim}")
    omega = 1.0 / (10000.0 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)))
    out = np.einsum("p,f->pf", positions.astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@lru_cache(maxsize=64)
def build_2d_sincos_pos_embed(embed_dim: int, h: int, w: int) -> np.ndarray:
    """[h w, embed_dim] fixed MAE-style 2D table, row-major: half the
    channels encode the row, half the column; built in float64, f32 out."""
    if embed_dim % 4:
        raise ValueError(f"2d sincos dim must be divisible by 4, got {embed_dim}")
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    emb_h = _sincos_1d(embed_dim // 2, gy.reshape(-1))
    emb_w = _sincos_1d(embed_dim // 2, gx.reshape(-1))
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
