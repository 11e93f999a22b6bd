"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the real Pallas kernels through the interpreter, as tests/test_ops.py
does. Inputs are made with numpy from a seed and handed to both sides.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from flaxdiff_tpu.ops.attention import _xla_attention
from flaxdiff_tpu.ops.flash_attention import _fwd_impl
from flaxdiff_tpu.ops.fused_adaln import fused_geglu as jax_geglu
from flaxdiff_tpu.ops.fused_norm import fused_groupnorm_silu as jax_gn

from flaxdiff_tpu_torch.ops import (dot_product_attention, flash_attention, fused_geglu,
                                    fused_groupnorm_silu, groupnorm_normalize, groupnorm_stats,
                                    launch_counts, reset_launch_counts)

# f32 on both sides: the two differ only in summation order and in the
# libraries' exp/tanh/rsqrt, a few ulps each, far below 1e-5 at these sizes
TOL = 1e-5


def _qkv(rng, bh, lq, lk, d):
    return (rng.standard_normal((bh, lq, d)).astype(np.float32),
            rng.standard_normal((bh, lk, d)).astype(np.float32),
            rng.standard_normal((bh, lk, d)).astype(np.float32))


@pytest.mark.parametrize("lq,lk,d", [
    (64, 77, 64),    # the 77-token text context, ragged against 16-row kv tiles
    (50, 40, 32),    # Lq and kv_len not tile multiples, head dim 32
    (33, 33, 64),    # ragged self-attention
])
def test_flash_plain_matches_pallas_kernel(lq, lk, d):
    rng = np.random.default_rng(lq * 1000 + lk)
    q, k, v = _qkv(rng, 3, lq, lk, d)
    # 16-row blocks make the interpreted kernel stream several kv blocks
    # through its online softmax and mask a padded tail
    out_j, lse_j = _fwd_impl(q, k, v, None, 16, 16, True, save_residuals=True)
    out_j = np.asarray(out_j)[:, :lq]
    lse_j = np.asarray(lse_j)[:, :lq, 0]
    as_bthd = lambda a: torch.from_numpy(a)[:, :, None, :]   # [BH, L, 1, D]
    out_t, lse_t = flash_attention(as_bthd(q), as_bthd(k), as_bthd(v), return_lse=True)
    np.testing.assert_allclose(out_t[:, :, 0].numpy(), out_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse_t[:, 0].numpy(), lse_j, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_attention_dispatch_matches_jax_eager_attention(backend):
    """Both backends compute the JAX package's explicit attention math."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 30, 2, 32)).astype(np.float32)
    k = rng.standard_normal((2, 77, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 77, 2, 32)).astype(np.float32)
    ref = np.asarray(_xla_attention(q, k, v))
    out = dot_product_attention(*map(torch.from_numpy, (q, k, v)), backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_flash_plain_takes_strided_projection_views():
    """[B, L, H*D] projections viewed as [B, L, H, D] give what the
    contiguous per-head layout gives."""
    rng = np.random.default_rng(3)
    b, l, h, d = 2, 20, 3, 32
    proj = torch.from_numpy(rng.standard_normal((b, l, 3 * h * d)).astype(np.float32))
    q, k, v = (t.view(b, l, h, d) for t in proj.split(h * d, dim=-1))
    assert not q.is_contiguous()
    out = flash_attention(q, k, v)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("shape,apply_silu,mean", [
    ((2, 100, 256), True, 0.0),       # HW not a multiple of the port's 32-row block
    ((2, 10, 10, 256), False, 0.0),   # NHWC input, normalize + affine only
    ((2, 64, 128), True, 100.0),      # mean ~100, std ~1: the shifted moment
])
def test_groupnorm_silu_plain_matches_pallas_kernel(shape, apply_silu, mean):
    rng = np.random.default_rng(int(mean) + shape[-1])
    c = shape[-1]
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = np.asarray(jax_gn(x, scale, bias, groups=8, eps=1e-6, apply_silu=apply_silu,
                            interpret=True, force_pallas=True))
    out = fused_groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), groups=8, eps=1e-6,
                               apply_silu=apply_silu)
    # the mean-100 case normalizes values whose f32 ulp is ~8e-6: allow
    # that much more there
    tol = TOL if mean == 0.0 else 1e-4
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)


def test_groupnorm_silu_shifted_moment_beats_naive_variance():
    """At mean 1e4 the E[x^2] - E[x]^2 form in f32 loses the variance
    entirely; the block-shifted Welford merge keeps it."""
    rng = np.random.default_rng(7)
    x = (1e4 + rng.standard_normal((1, 256, 64))).astype(np.float32)
    ones, zeros = torch.ones(64), torch.zeros(64)
    out = fused_groupnorm_silu(torch.from_numpy(x), ones, zeros, groups=8,
                               apply_silu=False).numpy()
    xd = x.astype(np.float64).reshape(1, 256, 8, 8)
    ref = ((xd - xd.mean(axis=(1, 3), keepdims=True))
           / np.sqrt(xd.var(axis=(1, 3), keepdims=True) + 1e-6)).reshape(x.shape)
    # the f32 group sum (~1e7, ulp 1) puts ~1e-3 on the mean; the variance
    # itself stays right
    np.testing.assert_allclose(out, ref, atol=5e-3)
    np.testing.assert_allclose(out.reshape(1, 256, 8, 8).std(axis=(1, 3)), 1.0, atol=1e-3)
    xf = torch.from_numpy(x).view(1, 256, 8, 8)
    naive = (xf * xf).mean(dim=(1, 3)) - xf.mean(dim=(1, 3)) ** 2
    assert (naive - 1.0).abs().max() > 0.5


@pytest.mark.parametrize("shape", [(2, 37, 96), (1, 8, 2 * 128)])
def test_geglu_plain_matches_pallas_kernel(shape):
    rng = np.random.default_rng(shape[1])
    proj = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    ref = np.asarray(jax_geglu(proj, interpret=True, force_pallas=True))
    out = fused_geglu(torch.from_numpy(proj))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_plain_paths_do_not_count_launches():
    reset_launch_counts()
    x = torch.randn(1, 16, 32)
    fused_groupnorm_silu(x, torch.ones(32), torch.zeros(32), groups=4)
    fused_geglu(torch.randn(1, 4, 8))
    q = torch.randn(1, 8, 2, 32)
    flash_attention(q, q, q)
    assert launch_counts() == {"flash_fwd": 0, "gn_stats": 0, "gn_norm": 0, "geglu": 0}


def test_wrappers_reject_what_the_kernels_cannot_take():
    with pytest.raises(ValueError):
        flash_attention(torch.randn(1, 4, 2, 8), torch.randn(1, 4, 3, 8), torch.randn(1, 4, 3, 8))
    with pytest.raises(ValueError):
        fused_groupnorm_silu(torch.randn(1, 4, 10), torch.ones(10), torch.zeros(10), groups=4)
    with pytest.raises(ValueError):
        fused_geglu(torch.randn(1, 4, 7))


@pytest.mark.parametrize("shape,transpose,groups,match", [
    ((1, 32, 16), True, 4, "contiguous"),    # a strided [1, 16, 32] view
    ((1, 16, 10), False, 4, "divisible"),
    ((1, 2, 8192), False, 8, "above"),
    ((16, 32), False, 4, r"\[B, HW, C\]"),
])
def test_groupnorm_wrappers_reject_what_the_kernels_cannot_take(shape, transpose, groups, match):
    x = torch.randn(*shape)
    if transpose:
        x = x.transpose(1, 2)
    c = x.shape[-1]
    stats = torch.zeros(x.shape[0], groups)
    with pytest.raises(ValueError, match=match):
        groupnorm_stats(x, groups)
    with pytest.raises(ValueError, match=match):
        groupnorm_normalize(x, stats, stats + 1.0, torch.ones(c), torch.zeros(c), True)

