"""flaxdiff_tpu_torch — the PyTorch/CUDA port of flaxdiff_tpu for NVIDIA Hopper.

Module paths and class names mirror ``flaxdiff_tpu`` so each counterpart is
easy to find. The port imports torch and numpy only: never jax, flax or the
JAX package. Entry points run on the card unless the caller passes
``device="cpu"``; the kernels are CUDA C++ under ``csrc/``, built at first
use (``ops/_build.py``).
"""

__version__ = "0.1.0"

from . import device, predictors, schedulers, typing, utils  # noqa: F401
