"""The port's FAVOR+ attention (``flaxdiff_tpu_torch/ops/linear_attention.py``)
against the JAX package, on the CPU in f32, on the JAX package's cached
projection, which torch cannot redraw.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.ops.linear_attention import _cached_projection as jax_projection
from flaxdiff_tpu.ops.linear_attention import favor_attention as jax_favor
from flaxdiff_tpu.ops.linear_attention import softmax_kernel_features as jax_features
from test_torch_train import assert_close_to_max
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch.ops.linear_attention import (default_features, favor_attention,
                                                     orthogonal_random_features,
                                                     softmax_kernel_features)

FAVOR_TOL = 1e-5     # of max|ref|


def _qkv(seed, b=2, length=24, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, length, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_favor_attention_matches_jax_on_its_projection(causal):
    q, k, v = _qkv(1)
    d = q.shape[-1]
    n = default_features(d)
    assert n == max(64, int(2 * d * max(float(jnp.log(d)), 1.0)))
    proj = np.asarray(jax_projection(d, n, 0))
    ref = np.asarray(jax_favor(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out = favor_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                          projection=torch.tensor(proj)).numpy()
    assert_close_to_max(out, ref, FAVOR_TOL, f"causal={causal}")


@pytest.mark.parametrize("is_query", [True, False])
def test_softmax_kernel_features_match_jax(is_query):
    x, _, _ = _qkv(2)
    proj = np.random.default_rng(3).standard_normal((40, x.shape[-1])).astype(np.float32)
    ref = np.asarray(jax_features(jnp.asarray(x), jnp.asarray(proj), is_query))
    out = softmax_kernel_features(torch.from_numpy(x), torch.from_numpy(proj), is_query).numpy()
    assert_close_to_max(out, ref, FAVOR_TOL)


def test_orthogonal_features_are_orthogonal_per_block_and_seeded():
    gen = torch.Generator().manual_seed(5)
    proj = orthogonal_random_features(gen, 40, 16)
    assert proj.shape == (40, 16)
    block = proj[:16] / proj[:16].norm(dim=1, keepdim=True)
    torch.testing.assert_close(block @ block.T, torch.eye(16), atol=1e-5, rtol=0)
    again = orthogonal_random_features(torch.Generator().manual_seed(5), 40, 16)
    assert torch.equal(proj, again)
    # without a projection the cached seeded draw serves, one per seed
    q, k, v = (torch.tensor(a) for a in _qkv(6, d=16))
    assert torch.equal(favor_attention(q, k, v), favor_attention(q, k, v))
    assert not torch.equal(favor_attention(q, k, v), favor_attention(q, k, v, seed=1))
