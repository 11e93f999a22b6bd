"""PSNR and SSIM (counterpart of ``flaxdiff_tpu/metrics/image_quality.py``).

Both take batched NHWC tensors, or videos [B, T, H, W, C] flattened over
frames, in [-1, 1] by default (``data_range`` 2), and return the batch mean
as a 0-d f32 tensor on the inputs' device. SSIM is Wang et al. 2004: an
11x11 Gaussian window (sigma 1.5) applied as two depthwise 1-D convolutions
with VALID padding, K1 0.01, K2 0.03, per channel, mean-pooled. The
`EvaluationMetric` factories score generated samples against the paired
``batch["sample"]``: reconstruction-style evaluation, not unpaired sampling.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .common import EvaluationMetric

_DATA_RANGE = 2.0  # images live in [-1, 1]


def _flatten_video(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B*T, H, W, C]; NHWC passes through."""
    return x.reshape((-1,) + tuple(x.shape[2:])) if x.ndim == 5 else x


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = _DATA_RANGE
         ) -> torch.Tensor:
    """Mean peak signal-to-noise ratio (dB) over the batch."""
    pred, target = _flatten_video(pred).float(), _flatten_video(target).float()
    mse = torch.clamp_min(((pred - target) ** 2).mean(dim=(1, 2, 3)), 1e-12)
    peak = 20.0 * torch.log10(torch.tensor(data_range, dtype=torch.float32, device=pred.device))
    return (peak - 10.0 * torch.log10(mse)).mean()


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur, depthwise, VALID padding, over x [N, C, H, W]."""
    c, k = x.shape[1], kernel.numel()
    x = F.conv2d(x, kernel.view(1, 1, k, 1).expand(c, 1, k, 1).contiguous(), groups=c)
    return F.conv2d(x, kernel.view(1, 1, 1, k).expand(c, 1, 1, k).contiguous(), groups=c)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = _DATA_RANGE,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean structural similarity over the batch (Wang et al. 2004)."""
    pred, target = _flatten_video(pred).float(), _flatten_video(target).float()
    if pred.shape[1] < window_size or pred.shape[2] < window_size:
        raise ValueError(f"images {pred.shape[1]}x{pred.shape[2]} smaller than the "
                         f"{window_size}x{window_size} SSIM window")
    kernel = torch.from_numpy(_gaussian_kernel(window_size, sigma)).to(pred.device)
    pred, target = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    mu_p, mu_t = _blur(pred, kernel), _blur(target, kernel)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    var_p = _blur(pred * pred, kernel) - mu_pp
    var_t = _blur(target * target, kernel) - mu_tt
    cov = _blur(pred * target, kernel) - mu_pt
    s = ((2.0 * mu_pt + c1) * (2.0 * cov + c2)
         / ((mu_pp + mu_tt + c1) * (var_p + var_t + c2)))
    return s.mean()


def _paired_pair(samples, batch: Optional[dict]):
    """(pred, target) as f32 [0, 1] host arrays, paired on the shorter batch;
    data_range is then 1. Generated samples are [-1, 1] by contract (the
    sampler's output), so they take the fixed (x + 1) / 2, never the range
    heuristic, which would misread a bright batch as [0, 1]; the batch's
    "sample" is whatever the loader yields (uint8 here) and goes through
    ``utils.to_unit_float``."""
    from ..utils import to_unit_float
    if not batch or "sample" not in batch:
        raise ValueError("psnr/ssim need a paired batch with a 'sample' key "
                         "(reconstruction-style evaluation)")
    target = to_unit_float(batch["sample"])
    pred = np.clip((np.asarray(samples, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    pred = pred[: target.shape[0]]
    return pred, target[: pred.shape[0]]


def _paired_metric(fn, name: str, device: DeviceLike) -> EvaluationMetric:
    dev = resolve_device(device)

    def metric(samples, batch):
        pred, target = _paired_pair(samples, batch)
        return float(fn(torch.from_numpy(pred).to(dev), torch.from_numpy(target).to(dev),
                        data_range=1.0))

    return EvaluationMetric(function=metric, name=name, higher_is_better=True)


def get_psnr_metric(device: DeviceLike = None) -> EvaluationMetric:
    """PSNR of the samples against ``batch["sample"]``, on `device`."""
    return _paired_metric(psnr, "psnr", device)


def get_ssim_metric(device: DeviceLike = None) -> EvaluationMetric:
    """SSIM of the samples against ``batch["sample"]``, on `device`."""
    return _paired_metric(ssim, "ssim", device)
