"""Evaluation metrics (counterpart of ``flaxdiff_tpu/metrics``): PSNR, SSIM,
FID with InceptionV3 features. The CLIP metrics need CLIP's published
weights, which are not in the repository."""
from .common import EvaluationMetric, MetricTracker
from .fid import FeatureStats, FIDComputer, frechet_distance, get_fid_metric
from .image_quality import get_psnr_metric, get_ssim_metric, psnr, ssim
from .inception import (InceptionV3Features, load_inception_params, make_inception_extractor,
                        resize_bilinear, resize_weights)

__all__ = ["EvaluationMetric", "MetricTracker", "FeatureStats", "FIDComputer",
           "frechet_distance", "get_fid_metric", "get_psnr_metric", "get_ssim_metric", "psnr",
           "ssim", "InceptionV3Features", "load_inception_params", "make_inception_extractor",
           "resize_bilinear", "resize_weights"]
