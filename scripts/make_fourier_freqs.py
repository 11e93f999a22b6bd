"""Write the FourierEmbedding frequency table of the PyTorch port.

The JAX UNet draws its timestep-embedding frequencies in ``setup`` as
``jax.random.normal(PRNGKey(42), (features // 2,)) * 16``
(flaxdiff_tpu/models/common.py:61-63); they are not a parameter. The port
must not import JAX, so it reads the same f32 values from
``flaxdiff_tpu_torch/models/fourier_freqs.npz``, one array per embedding
width. Run from the repository root to regenerate the file:

    JAX_PLATFORMS=cpu python scripts/make_fourier_freqs.py
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

# the emb_features of the repo's configs, tests and benchmarks
WIDTHS = (16, 32, 64, 128, 256, 512, 768, 1024)
OUT = os.path.join(os.path.dirname(__file__), os.pardir, "flaxdiff_tpu_torch", "models",
                   "fourier_freqs.npz")


def table(features: int, scale: float = 16.0) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.PRNGKey(42), (features // 2,)) * scale,
                      dtype=np.float32)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez(OUT, **{str(f): table(f) for f in WIDTHS})
    print(f"wrote {os.path.normpath(OUT)}: widths {WIDTHS}")
