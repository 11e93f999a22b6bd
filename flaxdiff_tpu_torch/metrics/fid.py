"""FID: the Frechet distance between feature statistics, accumulated online
(counterpart of ``flaxdiff_tpu/metrics/fid.py``). Any `features(images) ->
[N, D]` extractor plugs in: InceptionV3's pool3 (``metrics/inception.py``)
for FID, or another network's features. The statistics are float64 on the
host; the square root is scipy's ``sqrtm``."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike


@dataclasses.dataclass
class FeatureStats:
    """Streaming mean and covariance: the sum and the sum of outer products."""

    n: int = 0
    sum: Optional[np.ndarray] = None          # [D]
    outer: Optional[np.ndarray] = None        # [D, D] sum of x x^T

    def update(self, feats) -> None:
        if isinstance(feats, torch.Tensor):
            feats = feats.detach().cpu().numpy()
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2:
            raise ValueError(f"features must be [N, D], got {feats.shape}")
        if self.sum is None:
            d = feats.shape[1]
            self.sum = np.zeros(d)
            self.outer = np.zeros((d, d))
        self.n += feats.shape[0]
        self.sum += feats.sum(axis=0)
        self.outer += feats.T @ feats

    @property
    def mean(self) -> np.ndarray:
        return self.sum / self.n

    @property
    def cov(self) -> np.ndarray:
        mu = self.mean
        # unbiased, from the accumulated outer products
        return (self.outer - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)


def _sqrtm(a: np.ndarray) -> np.ndarray:
    import scipy.linalg
    out = scipy.linalg.sqrtm(a)
    # older scipy returns (sqrtm, errest) in some call forms
    return out[0] if isinstance(out, tuple) else out


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """|mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) (Heusel et al. 2017); a
    product that is not finite under sqrtm is retried with eps on both
    diagonals."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    covmean = _sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = _sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


class FIDComputer:
    """Real and generated feature statistics, and their FID.
    `extractor(images [N, H, W, C]) -> [N, D]` features."""

    def __init__(self, extractor: Callable, batch_size: int = 64):
        self.extractor = extractor
        self.batch_size = batch_size
        self.real = FeatureStats()
        self.fake = FeatureStats()

    def _accumulate(self, stats: FeatureStats, images) -> None:
        for i in range(0, len(images), self.batch_size):
            stats.update(self.extractor(images[i:i + self.batch_size]))

    def add_real(self, images) -> None:
        self._accumulate(self.real, images)

    def add_generated(self, images) -> None:
        self._accumulate(self.fake, images)

    def compute(self) -> float:
        if self.real.n < 2 or self.fake.n < 2:
            raise ValueError(f"need >=2 samples per side, have real={self.real.n} "
                             f"fake={self.fake.n}")
        return frechet_distance(self.real.mean, self.real.cov, self.fake.mean, self.fake.cov)

    def reset_generated(self) -> None:
        self.fake = FeatureStats()


def get_fid_metric(extractor: Optional[Callable] = None, params_file: Optional[str] = None,
                   batch_size: int = 32, real_key: str = "sample", device: DeviceLike = None):
    """EvaluationMetric: FID between the generated samples and the batch's
    real images (lower is better). `extractor` defaults to InceptionV3's
    pool3 features on `device`, with `params_file`'s weights (pytorch-FID's
    state dict, or the npz of ``scripts/convert_inception_weights.py``) for
    standard FID, seeded random ones otherwise (relative use only). The real
    side's statistics accumulate across calls, the generated side's reset at
    each call. At validation's sample counts (n << 2048) the covariance is
    rank-deficient and the value only indicative."""
    from ..utils import to_unit_float
    from .common import EvaluationMetric
    if extractor is None:
        from .inception import make_inception_extractor
        extractor = make_inception_extractor(params_file=params_file, device=device)
    computer = FIDComputer(extractor, batch_size=batch_size)

    def fn(samples, batch):
        if batch is None or real_key not in batch:
            raise ValueError(f"FID metric needs real images under batch[{real_key!r}]")
        computer.reset_generated()
        computer.add_real(to_unit_float(batch[real_key]))
        computer.add_generated(to_unit_float(samples))
        return computer.compute()

    return EvaluationMetric(function=fn, name="fid", higher_is_better=False)
