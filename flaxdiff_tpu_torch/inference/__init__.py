"""Inference: the model registry and the pipeline that rebuilds a model
from a saved config and generates (counterpart of
``flaxdiff_tpu/inference``)."""
from .pipeline import DiffusionInferencePipeline, save_pipeline_config
from .registry import MODEL_REGISTRY, build_model, parse_architecture_name

__all__ = ["DiffusionInferencePipeline", "MODEL_REGISTRY", "build_model",
           "parse_architecture_name", "save_pipeline_config"]
