"""Fused GroupNorm + SiLU, forward and backward: four CUDA kernels
(``csrc/groupnorm_silu.cu``), their plain PyTorch versions, and the autograd
Function that joins them.

Counterpart of ``flaxdiff_tpu/ops/fused_norm.py``. Forward: the Pallas
kernels ``_gn_stats_kernel`` and ``_gn_norm_kernel``. The statistics are
per-block partial sums and second moments shifted around each block's own
mean, merged with the Chan/Welford rule, so an input with a large mean keeps
an accurate variance. Backward: ``_gn_bwd_stats_kernel`` and
``_gn_bwd_dx_kernel``, from the forward's saved [B, G] mean and rstd, with an
O(B*G + C) finalize in torch between them. The plain versions compute the
same blocks, so the CPU tests hold the shared merges against the TPU kernels
too.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_MAX_CHANNELS = 4096
# the statistics kernels' blocks: the backward's (B6) up to two for each of
# the H100's 132 SMs (each kernel holds two at once), each of at least 8192
# elements. At [16, 16384, 64] a thread then sums 32 rows, at
# [2, 65536, 64] 16, before the block reduces them. The forward's (B4) are
# counted per sample: up to 132 a sample (the serving batch of 2 fills the
# card two deep, as the backward's rule would; a training batch of 16 at
# [16384, 64] runs 2048 blocks, 2.7x slower than the 264 of a rule that
# follows the batch, PERF.md)
_STATS_BLOCKS = 2 * 132
_STATS_MIN_ELEMS = 8192


def stats_rows_per_block(hw: int, c: int) -> int:
    """Rows of one block of the forward statistics kernel (B4), from a
    sample's shape alone: a sample's sums take the same blocks whatever the
    batch, so a served request's bits do not follow its bucket (fault C6).
    The plain version on the CPU sums the same blocks."""
    nblk = max(1, min(_STATS_BLOCKS // 2, hw * c // _STATS_MIN_ELEMS))
    return max(1, -(-hw // nblk))


def rows_per_block(b: int, hw: int, c: int) -> int:
    """Rows of one block of the backward statistics kernel (B6), from the
    shape alone, so the plain version on the CPU sums the same blocks."""
    nblk = max(1, min(_STATS_BLOCKS // b, hw * c // _STATS_MIN_ELEMS))
    return max(1, -(-hw // nblk))


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
    """The statistics kernel (B4): per block of ``stats_rows_per_block`` rows
    of a contiguous [B, HW, C] tensor, [B, nblk, 2, G] f32 partials."""
    _check_x(x, groups)
    b, hw, c = x.shape
    rows = stats_rows_per_block(hw, c)
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
    (flaxdiff_tpu/ops/fused_norm.py:295-311). The blocks are summed along a
    contiguous last axis, each (sample, group) its own row: on the card the
    order of a row's sum then does not follow the batch."""
    b, nblk, _, groups = partial.shape
    rows = stats_rows_per_block(hw, c)
    cg = c // groups
    n_rows = torch.clamp(
        hw - rows * torch.arange(nblk, device=partial.device, dtype=torch.float32),
        max=float(rows))
    n_b = n_rows * cg                                         # [nblk]
    n = float(hw * cg)
    gsum_b, m2_b = partial.permute(0, 2, 3, 1).contiguous().unbind(1)   # [B, G, nblk] each
    mean = gsum_b.sum(dim=-1) / n
    mean_b = gsum_b / n_b
    m2 = (m2_b + n_b * (mean_b - mean[..., None]) ** 2).sum(dim=-1)
    rstd = torch.rsqrt((m2 / n).clamp_min(0.0) + eps)
    return mean, rstd


def _per_channel(t: torch.Tensor, c: int) -> torch.Tensor:
    """[B, G] -> [B, 1, C]: each group's value on its channels."""
    return t.repeat_interleave(c // t.shape[-1], dim=-1)[:, None, :]


def _check_stats_args(x, mean, rstd, scale, bias) -> None:
    b, _, c = x.shape
    groups = mean.shape[-1]
    for name, t, shape in (("mean", mean, (b, groups)), ("rstd", rstd, (b, groups)),
                           ("scale", scale, (c,)), ("bias", bias, (c,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def groupnorm_normalize_plain(x, mean, rstd, scale, bias, apply_silu: bool):
    c = x.shape[-1]
    y = (x.float() - _per_channel(mean, c)) * _per_channel(rstd, c)
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
    _check_stats_args(x, mean, rstd, scale, bias)
    b, hw, c = x.shape
    groups = mean.shape[-1]
    out = torch.empty((b, hw, c), dtype=x.dtype, device=x.device)
    err = _build.library().gn_norm(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, hw, c, groups, int(apply_silu),
        _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "gn_norm")
    groupnorm_normalize.launches += 1
    return out


groupnorm_normalize.launches = 0


def _bwd_dy(x, g, mean, rstd, scale, bias, apply_silu: bool):
    """(xhat, dy) in f32 from the saved statistics: the one recompute that
    both backward passes share, as ``_bwd_dy`` (fused_norm.py:97-109) is for
    the TPU kernels. dy includes the SiLU derivative."""
    c = x.shape[-1]
    xhat = (x.float() - _per_channel(mean, c)) * _per_channel(rstd, c)
    dy = g.float()
    if apply_silu:
        y = xhat * scale.float() + bias.float()
        sig = torch.sigmoid(y)
        dy = dy * sig * (1.0 + y * (1.0 - sig))
    return xhat, dy


def groupnorm_bwd_stats_plain(x, g, mean, rstd, scale, bias, apply_silu: bool, rows: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per block of `rows` rows, f32: ([B, nblk, 2, G] group sums of dxhat
    and dxhat * xhat, [B, nblk, 2, C] channel sums of dy and dy * xhat),
    with dxhat = dy * scale."""
    b, hw, c = x.shape
    groups = mean.shape[-1]
    nblk = -(-hw // rows)
    xhat, dy = _bwd_dy(x, g, mean, rstd, scale, bias, apply_silu)
    pad = nblk * rows - hw
    if pad:
        xhat = torch.nn.functional.pad(xhat, (0, 0, 0, pad))
        dy = torch.nn.functional.pad(dy, (0, 0, 0, pad))
    dyb, xb = dy.view(b, nblk, rows, c), xhat.view(b, nblk, rows, c)
    csums = torch.stack([dyb.sum(dim=2), (dyb * xb).sum(dim=2)], dim=2)
    gsums = (csums * scale.float()).view(b, nblk, 2, groups, c // groups).sum(dim=-1)
    return gsums, csums


def _check_grad(x: torch.Tensor, g: torch.Tensor) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"cotangent: want contiguous {x.dtype} {tuple(x.shape)}, got "
                         f"{g.dtype} {tuple(g.shape)}")


def groupnorm_bwd_stats(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        apply_silu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward statistics kernel (B6) over contiguous [B, HW, C] x and
    cotangent g, in blocks of ``rows_per_block`` rows: (gsums
    [B, nblk, 2, G], csums [B, nblk, 2, C]), f32."""
    _check_x(x, mean.shape[-1])
    _check_grad(x, g)
    b, hw, c = x.shape
    groups = mean.shape[-1]
    rows = rows_per_block(b, hw, c)
    if x.device.type == "cpu":
        return groupnorm_bwd_stats_plain(x, g, mean, rstd, scale, bias, apply_silu, rows)
    _build.require_cuda(x, g, mean, rstd, scale, bias)
    _check_stats_args(x, mean, rstd, scale, bias)
    nblk = -(-hw // rows)
    gsums = torch.empty((b, nblk, 2, groups), dtype=torch.float32, device=x.device)
    csums = torch.empty((b, nblk, 2, c), dtype=torch.float32, device=x.device)
    err = _build.library().gn_bwd_stats(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), gsums.data_ptr(), csums.data_ptr(), b, hw, c, groups, rows,
        int(apply_silu), _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "gn_bwd_stats")
    groupnorm_bwd_stats.launches += 1
    return gsums, csums


groupnorm_bwd_stats.launches = 0


def groupnorm_bwd_finalize(gsums: torch.Tensor, csums: torch.Tensor, hw: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s [B, 2, G]: the group means of dxhat and dxhat * xhat, dscale [C],
    dbias [C]), f32, from the block partials (fused_norm.py:210-218)."""
    c = csums.shape[-1]
    s = gsums.sum(dim=1) / float(hw * (c // gsums.shape[-1]))
    dbias, dscale = csums.sum(dim=(0, 1)).unbind(0)
    return s, dscale, dbias


def groupnorm_bwd_dx_plain(x, g, mean, rstd, scale, bias, s, apply_silu: bool) -> torch.Tensor:
    """dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) in x's dtype
    (fused_norm.py:152-165)."""
    c = x.shape[-1]
    xhat, dy = _bwd_dy(x, g, mean, rstd, scale, bias, apply_silu)
    dx = _per_channel(rstd, c) * (dy * scale.float() - _per_channel(s[:, 0], c)
                                  - xhat * _per_channel(s[:, 1], c))
    return dx.to(x.dtype)


def groupnorm_bwd_dx(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     s: torch.Tensor, apply_silu: bool) -> torch.Tensor:
    """The dx kernel (B7) over contiguous [B, HW, C] x and cotangent g, with
    the finalized group means s [B, 2, G]; dx in x's dtype."""
    _check_x(x, mean.shape[-1])
    _check_grad(x, g)
    if x.device.type == "cpu":
        return groupnorm_bwd_dx_plain(x, g, mean, rstd, scale, bias, s, apply_silu)
    _build.require_cuda(x, g, mean, rstd, scale, bias, s)
    _check_stats_args(x, mean, rstd, scale, bias)
    b, hw, c = x.shape
    groups = mean.shape[-1]
    if tuple(s.shape) != (b, 2, groups) or s.dtype != torch.float32 or not s.is_contiguous():
        raise ValueError(f"s: want contiguous f32 {(b, 2, groups)}, got {s.dtype} "
                         f"{tuple(s.shape)}")
    dx = torch.empty_like(x)
    err = _build.library().gn_bwd_dx(
        x.data_ptr(), g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), s.data_ptr(), dx.data_ptr(), b, hw, c, groups, int(apply_silu),
        _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "gn_bwd_dx")
    groupnorm_bwd_dx.launches += 1
    return dx


groupnorm_bwd_dx.launches = 0


class GroupNormSiLUFn(torch.autograd.Function):
    """Forward: the stats kernel, the Welford finalize, the normalize kernel;
    the [B, G] mean and rstd are saved. Backward: the two backward kernels
    around their finalize, as ``_gn_fwd``/``_gn_bwd`` (fused_norm.py:345-370)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, apply_silu):
        c = x.shape[-1]
        x3 = x.view(x.shape[0], -1, c)
        partial = groupnorm_stats(x3, groups)
        mean, rstd = groupnorm_finalize(partial, x3.shape[1], c, eps)
        out = groupnorm_normalize(x3, mean, rstd, scale, bias, apply_silu)
        ctx.save_for_backward(x3, scale, bias, mean, rstd)
        ctx.apply_silu = apply_silu
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x3, scale, bias, mean, rstd = ctx.saved_tensors
        g3 = g.contiguous().view(x3.shape)
        gsums, csums = groupnorm_bwd_stats(x3, g3, mean, rstd, scale, bias, ctx.apply_silu)
        s, dscale, dbias = groupnorm_bwd_finalize(gsums, csums, x3.shape[1])
        dx = groupnorm_bwd_dx(x3, g3, mean, rstd, scale, bias, s, ctx.apply_silu)
        return dx.view(g.shape), dscale, dbias, None, None, None


def fused_groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int = 8, eps: float = 1e-6,
                         apply_silu: bool = True) -> torch.Tensor:
    """x: [B, H, W, C] or [B, L, C], contiguous; scale/bias: [C] f32.
    Returns x's shape and dtype. Differentiable through ``GroupNormSiLUFn``."""
    if not x.is_contiguous():
        raise ValueError("fused_groupnorm_silu needs a contiguous channels-last tensor")
    return GroupNormSiLUFn.apply(x, scale, bias, groups, eps, apply_silu)
