"""Fused GroupNorm + SiLU forward: two CUDA kernels (``csrc/groupnorm_silu.cu``)
around a Welford merge, and their plain PyTorch versions.

Counterpart of ``flaxdiff_tpu/ops/fused_norm.py`` (Pallas kernels
``_gn_stats_kernel`` and ``_gn_norm_kernel``). The statistics are per-block
partial sums and second moments shifted around each block's own mean, merged
with the Chan/Welford rule, so an input with a large mean keeps an accurate
variance. The plain versions compute the same blocks, so the CPU tests hold
the shared merge against the TPU kernels too.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

# elements of one stats block: B x (HW / rows) blocks must fill the card
_BLOCK_ELEMS = 8192
_MAX_CHANNELS = 4096


def rows_per_block(hw: int, c: int) -> int:
    return max(1, min(hw, _BLOCK_ELEMS // c))


def groupnorm_stats_plain(x: torch.Tensor, groups: int, rows: int) -> torch.Tensor:
    """[B, nblk, 2, G] f32: per block of `rows` rows, the group sums and the
    group second moments around the block's own group mean."""
    b, hw, c = x.shape
    nblk = -(-hw // rows)
    pad = nblk * rows - hw
    xf = x.float()
    valid = torch.ones(b, hw, 1, dtype=torch.float32, device=x.device)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, 0, 0, pad))
    xg = xf.view(b, nblk, rows, groups, c // groups)
    vg = valid.view(b, nblk, rows, 1, 1)
    gsum = xg.sum(dim=(2, 4))                                     # [B, nblk, G]
    count = vg.sum(dim=(2, 3, 4)).unsqueeze(-1) * (c // groups)   # [1 or B, nblk, 1]
    mean = gsum / count
    dev = (xg - mean[:, :, None, :, None]) * vg
    m2 = (dev * dev).sum(dim=(2, 4))
    return torch.stack([gsum, m2], dim=2)


def _check_x(x: torch.Tensor, groups: int) -> None:
    """Raise on what the kernels cannot take: they index a contiguous
    [B, HW, C] tensor linearly, one thread per channel of a row."""
    if x.ndim != 3:
        raise ValueError(f"want a [B, HW, C] tensor, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if c > _MAX_CHANNELS:
        raise ValueError(f"channels {c} above {_MAX_CHANNELS}")
    if not x.is_contiguous():
        raise ValueError("the GroupNorm kernels need a contiguous channels-last tensor")


def groupnorm_stats(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-block partial statistics of a contiguous [B, HW, C] tensor."""
    _check_x(x, groups)
    b, hw, c = x.shape
    rows = rows_per_block(hw, c)
    if x.device.type == "cpu":
        return groupnorm_stats_plain(x, groups, rows)
    _build.require_cuda(x)
    nblk = -(-hw // rows)
    partial = torch.empty((b, nblk, 2, groups), dtype=torch.float32, device=x.device)
    err = _build.library().gn_stats(
        x.data_ptr(), partial.data_ptr(), b, hw, c, groups, rows,
        _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "gn_stats")
    groupnorm_stats.launches += 1
    return partial


groupnorm_stats.launches = 0


def groupnorm_finalize(partial: torch.Tensor, hw: int, c: int, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Welford/Chan merge of the block partials -> (mean, rstd), [B, G] f32
    (flaxdiff_tpu/ops/fused_norm.py:295-311)."""
    groups = partial.shape[-1]
    nblk = partial.shape[1]
    rows = rows_per_block(hw, c)
    cg = c // groups
    n_rows = torch.clamp(
        hw - rows * torch.arange(nblk, device=partial.device, dtype=torch.float32),
        max=float(rows))
    n_b = n_rows[None, :, None] * cg
    n = float(hw * cg)
    gsum_b, m2_b = partial[:, :, 0], partial[:, :, 1]
    mean = gsum_b.sum(dim=1) / n
    mean_b = gsum_b / n_b
    m2 = (m2_b + n_b * (mean_b - mean[:, None, :]) ** 2).sum(dim=1)
    rstd = torch.rsqrt((m2 / n).clamp_min(0.0) + eps)
    return mean, rstd


def groupnorm_normalize_plain(x, mean, rstd, scale, bias, apply_silu: bool):
    b, hw, c = x.shape
    groups = mean.shape[-1]
    cg = c // groups
    mean_c = mean.repeat_interleave(cg, dim=-1)[:, None, :]
    rstd_c = rstd.repeat_interleave(cg, dim=-1)[:, None, :]
    y = (x.float() - mean_c) * rstd_c
    y = y * scale.float() + bias.float()
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def groupnorm_normalize(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        apply_silu: bool) -> torch.Tensor:
    """silu((x - mean) * rstd * scale + bias) over a contiguous [B, HW, C]
    tensor, f32 math, x's dtype out."""
    _check_x(x, mean.shape[-1])
    if x.device.type == "cpu":
        return groupnorm_normalize_plain(x, mean, rstd, scale, bias, apply_silu)
    _build.require_cuda(x, mean, rstd, scale, bias)
    b, hw, c = x.shape
    groups = mean.shape[-1]
    for name, t, shape in (("mean", mean, (b, groups)), ("rstd", rstd, (b, groups)),
                           ("scale", scale, (c,)), ("bias", bias, (c,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    out = torch.empty((b, hw, c), dtype=x.dtype, device=x.device)
    err = _build.library().gn_norm(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, hw, c, groups, int(apply_silu),
        _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "gn_norm")
    groupnorm_normalize.launches += 1
    return out


groupnorm_normalize.launches = 0


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int = 8, eps: float = 1e-6,
                         apply_silu: bool = True) -> torch.Tensor:
    """x: [B, H, W, C] or [B, L, C], contiguous; scale/bias: [C] f32.
    Returns x's shape and dtype."""
    if not x.is_contiguous():
        raise ValueError("fused_groupnorm_silu needs a contiguous channels-last tensor")
    c = x.shape[-1]
    x3 = x.view(x.shape[0], -1, c)
    partial = groupnorm_stats(x3, groups)
    mean, rstd = groupnorm_finalize(partial, x3.shape[1], c, eps)
    out = groupnorm_normalize(x3, mean, rstd, scale, bias, apply_silu)
    return out.view(x.shape)
