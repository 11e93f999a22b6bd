"""The S5 layers and the hybrid SSM/attention DiT against the JAX package, on
the CPU in f32, with seeded numpy leaves (helpers in
``test_torch_unet_variants.py``).

The S5 leaves take HiPPO-like values (log_A_real around log(n + 1/2), A_imag
around pi n, log_dt in [log 1e-3, log 1e-1]): the generic seeded leaves
would give every state the same fast decay, and the scan's long memory,
where the association order matters most, would go untested. The port's
log-depth scan associates differently from ``jax.lax.associative_scan``,
so scan results are held to 1e-4 of their largest value.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models import ssm as jssm
from test_torch_unet_variants import _x, flax_leaves, forward_and_grads, load_port
from test_torch_uvit import INPUTS, TEXT, VIT

from flaxdiff_tpu_torch.models import (HybridSSMAttentionDiT, S5Layer, SpatialFusionConv,
                                       build_block_pattern)
from flaxdiff_tpu_torch.models.ssm import linear_scan

SCAN_TOL = 1e-4


def s5_leaves(params, seed=0):
    """`params` with HiPPO-like values for every S5 leaf."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        n = np.arange(a.shape[0], dtype=np.float32)
        if name == "log_A_real":
            return (np.log(n + 0.5) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "A_imag":
            return (math.pi * n + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "log_dt":
            return rng.uniform(math.log(1e-3), math.log(1e-1), a.shape).astype(np.float32)
        if name in ("B_re", "B_im", "C_re", "C_im"):
            return (rng.standard_normal(a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        if name == "D":
            return rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("length", [1, 13, 64])
def test_linear_scan_matches_the_associative_scan(length):
    """The log-depth scan against ``jax.lax.associative_scan`` with the JAX
    layer's combine, complex64, states decaying from 0.999 to 0.5 a step."""
    rng = np.random.default_rng(length)
    n = 16
    a = (np.linspace(0.999, 0.5, n) * np.exp(1j * rng.uniform(0, np.pi, n))).astype(np.complex64)
    bu = (rng.standard_normal((2, length, n))
          + 1j * rng.standard_normal((2, length, n))).astype(np.complex64)

    def combine(e1, e2):
        a1, x1 = e1
        a2, x2 = e2
        return a1 * a2, a2 * x1 + x2

    _, ref = jax.lax.associative_scan(combine, (jnp.broadcast_to(a, bu.shape), bu), axis=1)
    out = linear_scan(torch.from_numpy(a), torch.from_numpy(bu)).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=SCAN_TOL * np.abs(ref).max())


def test_s5_layer_forward_and_grads_match_jax():
    """ZOH discretisation, the scan, Re(C x) + D u: forward and the gradient
    of every S5 parameter."""
    u = _x((2, 16, 8), 120)
    jm = jssm.S5Layer(features=8, state_dim=12)
    params = flax_leaves(jm, 121, u, transform=s5_leaves)
    tm = load_port(S5Layer(8, 12, device="cpu"), params)
    forward_and_grads(jm, tm, params, [u], grads=True, jit=True, tol=SCAN_TOL)


@pytest.mark.parametrize("ratio,pattern", [("3:1", None), ("1:1", None), ("all-ssm", None),
                                           ("all-attn", None), ("3:1", ("attn", "ssm"))])
def test_block_pattern_matches_jax(ratio, pattern):
    for depth in (1, 4, 7):
        assert build_block_pattern(depth, ratio, pattern) == jssm.build_block_pattern(
            depth, ratio, pattern)


def test_spatial_fusion_matches_jax():
    """The dilated depthwise convolutions (dilations 1, 2, 3, "SAME", no
    bias), with seeded kernels in place of their zero init."""
    y = _x((2, 5, 7, 6), 130)
    jm = jssm.SpatialFusionConv(features=6)
    params = flax_leaves(jm, 131, y)
    tm = load_port(SpatialFusionConv(6, device="cpu"), params)
    forward_and_grads(jm, tm, params, [y], grads=True)


HYBRID = dict(VIT, num_layers=4, ssm_state_dim=8, ssm_attention_ratio="1:1")
HYBRID_CASES = {"raster": {}, "hilbert-2d": {"use_hilbert": True, "use_2d_fusion": True},
                "zigzag-2d": {"use_zigzag": True, "use_2d_fusion": True},
                "unidirectional": {"bidirectional_ssm": False}}


@pytest.mark.parametrize("case", list(HYBRID_CASES))
def test_hybrid_ssm_matches_jax(case):
    """SSM blocks (bidirectional S5 along the scan order; with 2D fusion the
    tokens go back to the grid and into the scan order again) interleaved
    with attention DiT blocks; gradients through the Hilbert order with 2D
    fusion."""
    cfg = dict(HYBRID, **HYBRID_CASES[case])
    jm = jssm.HybridSSMAttentionDiT(**cfg)
    args = INPUTS(140)
    params = flax_leaves(jm, 141, *args, transform=s5_leaves)
    tm = load_port(HybridSSMAttentionDiT(**cfg, in_channels=3, context_dim=TEXT, device="cpu"),
                   params)
    assert [k for k in tm.pattern] == ["ssm", "attn", "ssm", "attn"]
    forward_and_grads(jm, tm, params, args, grads=case == "hilbert-2d", jit=True,
                      tol=SCAN_TOL)
