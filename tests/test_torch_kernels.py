"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the real Pallas kernels through the interpreter, as tests/test_ops.py
does. Inputs are made with numpy from a seed and handed to both sides.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_gpu.py and chip_smoke.py.
"""
import ast
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flaxdiff_tpu.ops import fused_adaln as jax_adaln
from flaxdiff_tpu.ops.attention import _xla_attention
from flaxdiff_tpu.ops.flash_attention import _fwd_impl
from flaxdiff_tpu.ops.flash_attention import flash_attention as jax_flash
from flaxdiff_tpu.ops.fused_adaln import fused_geglu as jax_geglu
from flaxdiff_tpu.ops.fused_norm import _gn_stats_kernel
from flaxdiff_tpu.ops.fused_norm import fused_groupnorm_silu as jax_gn

from flaxdiff_tpu_torch.ops import _build
from flaxdiff_tpu_torch.ops import (KERNEL_WRAPPERS, dot_product_attention, flash_attention,
                                    fused_gate_residual, fused_geglu, fused_groupnorm_silu,
                                    fused_ln_modulate2, groupnorm_normalize, groupnorm_stats,
                                    launch_counts, reset_launch_counts)
from flaxdiff_tpu_torch.ops.attention import eager_attention
from flaxdiff_tpu_torch.ops.flash_attention import flash_fwd_plain
from flaxdiff_tpu_torch.ops.fused_norm import rows_per_block, stats_rows_per_block
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

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


# 32, 256, 320 and 384 are native to the flash kernels (above 256 the wide
# kernels take multiples of 64); 40, 72 (DiT-XL/2: 1152 / 16), 80 and 96 are
# zero-padded to the next of 64 and 128 by the dispatch, 160 (an SD-style
# UNet level of 1280 channels in 8 heads) and 192 to 256, 288 to 320
ODD_HEAD_DIMS = [40, 72, 80, 96, 160, 192, 288]


@pytest.mark.parametrize("d", [32] + ODD_HEAD_DIMS + [256, 320, 384])
@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_attention_dispatch_matches_jax_eager_attention(backend, d):
    """Both backends compute the JAX package's explicit attention math, at
    every head dim (above 256 too: UNet3D's 1280 channels in 4 heads give
    320)."""
    rng = np.random.default_rng(11 + d)
    q = rng.standard_normal((2, 30, 2, d)).astype(np.float32)
    k = rng.standard_normal((2, 77, 2, d)).astype(np.float32)
    v = rng.standard_normal((2, 77, 2, d)).astype(np.float32)
    ref = np.asarray(_xla_attention(q, k, v))
    out = dot_product_attention(*map(torch.from_numpy, (q, k, v)), backend=backend)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("d", ODD_HEAD_DIMS)
def test_padded_dispatch_equals_unpadded_math(d, scale):
    """The zero-padded flash path gives what the unpadded math gives, with
    the true head dim's scale (or the caller's), and gradients of the
    unpadded shape."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 3, d)).astype(np.float32))
               .requires_grad_() for n in (20, 33, 33))
    out = dot_product_attention(q, k, v, backend="flash", scale=scale)
    torch.testing.assert_close(out, eager_attention(q, k, v, scale), atol=TOL, rtol=TOL)
    torch.testing.assert_close(out, flash_fwd_plain(q, k, v, scale)[0], atol=TOL, rtol=TOL)
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape and v.grad.shape == v.shape


@pytest.mark.parametrize("backend", ["auto", "flash", "xla"])
def test_attention_dispatch_takes_any_head_dim(backend):
    """No head dim raises in the dispatch: the flash backends pad what the
    kernels do not take (300 to 320, 65 to 128), and the explicit math takes
    any head dim as it is."""
    for d in (65, 300):
        q = torch.randn(1, 8, 2, d, generator=torch.Generator().manual_seed(d))
        out = dot_product_attention(q, q, q, backend=backend)
        assert out.shape == q.shape
        torch.testing.assert_close(out, eager_attention(q, q, q), atol=TOL, rtol=TOL)


def test_flash_attention_raises_on_head_dims_no_kernel_takes():
    """flash_attention itself takes only what some kernel takes: 32, 64,
    128, 256 and multiples of 64 above 256, on every device."""
    for d in (48, 288):
        q = torch.randn(1, 8, 2, d)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 320)
    assert flash_attention(q, q, q).shape == q.shape


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


@pytest.mark.parametrize("shape,groups,apply_silu,mean", [
    # HW not a multiple of the port's 32-row block
    pytest.param((2, 100, 256), 8, True, 0.0, id="shape0-True-0.0"),
    # NHWC input, normalize + affine only
    pytest.param((2, 10, 10, 256), 8, False, 0.0, id="shape1-False-0.0"),
    # mean ~100, std ~1: the shifted moment
    pytest.param((2, 64, 128), 8, True, 100.0, id="shape2-True-100.0"),
    # 12 channels a group: a bf16 vector of 8 channels straddles two groups
    pytest.param((2, 9, 48), 4, True, 0.0, id="c48-groups4"),
])
def test_groupnorm_silu_plain_matches_pallas_kernel(shape, groups, apply_silu, mean):
    rng = np.random.default_rng(int(mean) + shape[-1])
    c = shape[-1]
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = np.asarray(jax_gn(x, scale, bias, groups=groups, eps=1e-6, apply_silu=apply_silu,
                            interpret=True, force_pallas=True))
    out = fused_groupnorm_silu(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), groups=groups, eps=1e-6,
                               apply_silu=apply_silu)
    # the mean-100 case normalizes values whose f32 ulp is ~8e-6: allow
    # that much more there
    tol = TOL if mean == 0.0 else 1e-4
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,groups,mean", [
    ((2, 1000, 64), 8, 0.0),     # 7 blocks of 143 rows, the last 142
    ((2, 701, 48), 4, 0.0),      # 4 blocks of 176 rows, the last 173; 12 channels a group
    ((1, 301, 128), 8, 100.0),   # mean 100, 4 blocks of 76 rows: moments around block means
])
def test_groupnorm_stats_plain_matches_pallas_kernel(shape, groups, mean):
    """The statistics kernel's plain version (B4's blocks of
    ``stats_rows_per_block`` rows) against the TPU kernel ``_gn_stats_kernel``,
    interpreted over the same blocks: per block, the group sums and second
    moments around the block's group mean."""
    b, hw, c = shape
    rows = stats_rows_per_block(hw, c)
    nblk = -(-hw // rows)
    assert nblk > 1 and hw % rows
    rng = np.random.default_rng(hw + c)
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    ref = pl.pallas_call(
        functools.partial(_gn_stats_kernel, groups=groups, hw=hw, block_hw=rows),
        grid=(b, nblk),
        in_specs=[pl.BlockSpec((1, rows, c), lambda i, j: (i, j, 0))],
        out_specs=pl.BlockSpec((1, 1, 2, groups), lambda i, j: (i, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, nblk, 2, groups), jnp.float32),
        interpret=True)(jnp.asarray(x))
    ref = np.asarray(ref)
    out = groupnorm_stats(torch.from_numpy(x), groups).numpy()
    assert out.shape == ref.shape
    # f32 sums of up to 176 x 16 elements in another order: a few ulps of
    # the largest sum (~3e4 at mean 100) or moment
    for k in range(2):
        np.testing.assert_allclose(out[:, :, k], ref[:, :, k], rtol=TOL,
                                   atol=TOL * np.abs(ref[:, :, k]).max())


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


@pytest.mark.parametrize("shape", [(16, 16384, 64), (16, 4096, 128), (16, 1024, 256),
                                   (16, 1024, 384), (16, 256, 512), (16, 256, 1024)])
def test_groupnorm_bwd_blocks_fill_the_card(shape):
    """At the UNet train step's shapes (batch 16 at 128^2), the backward
    statistics' blocks fill the H100's 132 SMs about two deep, no more than
    the kernel holds at once, each block a whole number of rows."""
    b, hw, c = shape
    rows = rows_per_block(b, hw, c)
    nblk = -(-hw // rows)
    assert 132 < b * nblk <= 2 * 132
    assert rows * c >= 8192 and (nblk - 1) * rows < hw


@pytest.mark.parametrize("shape", [(2, 37, 96), (1, 8, 2 * 128)])
def test_geglu_plain_matches_pallas_kernel(shape):
    rng = np.random.default_rng(shape[1])
    proj = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    ref = np.asarray(jax_geglu(proj, interpret=True, force_pallas=True))
    out = fused_geglu(torch.from_numpy(proj))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


# f16 on both sides: each output is rounded to f16 (an ulp of at most 2^-10
# of its value) from f32 math that differs in summation order; two ulps of
# the largest element cover one rounding apart and the f32 differences
F16_TOL = 2.0 ** -9


def _f16_cases():
    """(jax_fn, port_fn, inputs) per kernel family, the inputs f16 where the
    model passes f16 (the GroupNorm affine and the AdaLN modulators stay
    as the models pass them)."""
    rng = np.random.default_rng(16)
    h = lambda *shape, s=1.0, m=0.0: (m + s * rng.standard_normal(shape)).astype(np.float16)
    f = lambda *shape, s=1.0, m=0.0: (m + s * rng.standard_normal(shape)).astype(np.float32)
    return {
        # B1-B3: cross-attention to 77 tokens, 16-row tiles on the JAX side
        "flash": (lambda q, k, v: jax_flash(q, k, v, None, 16, 16, True),
                  lambda q, k, v: dot_product_attention(q, k, v, backend="flash"),
                  (h(2, 40, 2, 64), h(2, 77, 2, 64), h(2, 77, 2, 64))),
        # B4-B7
        "groupnorm_silu": (
            lambda x, s, b: jax_gn(x, s, b, groups=8, eps=1e-6, apply_silu=True, interpret=True,
                                   force_pallas=True),
            lambda x, s, b: fused_groupnorm_silu(x, s, b, groups=8, eps=1e-6, apply_silu=True),
            (h(2, 100, 64, m=0.5), f(64, s=0.1, m=1.0), f(64, s=0.1))),
        # B8-B9
        "geglu": (lambda p: jax_geglu(p, interpret=True, force_pallas=True), fused_geglu,
                  (h(2, 37, 192, s=2.0),)),
        # B10-B11: two views, as the DiT block takes them
        "ln_modulate": (
            lambda x, s0, b0, s1, b1: jax_adaln.fused_ln_modulate2(
                x, s0, b0, s1, b1, 1e-5, interpret=True, force_pallas=True),
            lambda x, s0, b0, s1, b1: fused_ln_modulate2(x, s0, b0, s1, b1, eps=1e-5),
            (h(2, 27, 64, s=2.0, m=3.0),) + tuple(h(2, 1, 64, s=0.5) for _ in range(4))),
        # B12-B13
        "gate_residual": (
            lambda x, g, y: jax_adaln.fused_gate_residual(x, g, y, interpret=True,
                                                          force_pallas=True),
            fused_gate_residual, (h(2, 27, 64), h(2, 1, 64, s=0.5), h(2, 27, 64))),
    }


@pytest.mark.parametrize("kernel", ["flash", "groupnorm_silu", "geglu", "ln_modulate",
                                    "gate_residual"])
def test_f16_plain_matches_pallas_kernels(kernel):
    """The float16 path of each kernel family (the f16 UNet's, and the
    AdaLN kernels'): the plain versions' forward and, through autograd,
    their backward against the Pallas kernels interpreted in f16 (the
    backward through ``jax.vjp``), every output in the reference's dtype
    and within F16_TOL of its largest element."""
    jax_fn, port_fn, inputs = _f16_cases()[kernel]
    refs, vjp = jax.vjp(jax_fn, *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = port_fn(*leaves)
    refs, outs = ((refs,), (outs,)) if not isinstance(refs, tuple) else (refs, outs)
    rng = np.random.default_rng(17)
    cot = [rng.standard_normal(r.shape).astype(r.dtype) for r in refs]
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cot])
    ref_grads = vjp(tuple(cot) if len(cot) > 1 else cot[0])
    for i, (out, ref) in enumerate(list(zip(outs, refs)) + list(zip(grads, ref_grads))):
        ref = np.asarray(ref)
        assert out.dtype == torch.from_numpy(ref).dtype, (kernel, i, out.dtype, ref.dtype)
        err = np.abs(out.detach().double().numpy() - ref.astype(np.float64)).max()
        assert err <= F16_TOL * np.abs(ref.astype(np.float64)).max(), (kernel, i, err)


def test_plain_paths_do_not_count_launches():
    """Forward and backward on CPU tensors run the plain versions only."""
    reset_launch_counts()
    x = torch.randn(1, 16, 32, requires_grad=True)
    out = fused_groupnorm_silu(x, torch.ones(32), torch.zeros(32), groups=4)
    out = out + fused_geglu(torch.cat([x, x], dim=-1))
    q = out.view(1, 16, 1, 32)
    flash_attention(q, q, q).sum().backward()
    assert x.grad is not None
    assert launch_counts() == {name: 0 for name in KERNEL_WRAPPERS}


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



# --- the C interface of the kernel library against its ctypes bindings --------

def _extern_c_signatures():
    """{name: [parameter type, ...]} of every extern "C" function in the port's
    CUDA sources, read from the text (nothing is compiled here)."""
    import re

    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', text):
            # each parameter's type: the declaration without its name
            found[name] = [re.sub(r"\s*\b\w+\s*$", "", p.strip()) for p in params.split(",")]
    return found


def _ctype_of(c_type: str):
    import ctypes
    if "*" in c_type:
        return ctypes.c_void_p
    kinds = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "float": ctypes.c_float}
    return kinds[c_type.replace("const", "").strip()]


def test_every_extern_c_kernel_entry_is_bound():
    assert set(_extern_c_signatures()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signature_matches_the_c_declaration(name):
    """Argument by argument: a pointer is c_void_p, int64_t c_int64, int
    c_int, float c_float. A parameter added or moved in a source but not in
    _SIGNATURES would otherwise pass a pointer as a 32-bit int."""
    declared = [_ctype_of(t) for t in _extern_c_signatures()[name]]
    assert declared == _build._SIGNATURES[name]


def _global_kernels(source: str) -> list:
    """The names of the __global__ functions a CUDA source defines."""
    names = []
    for chunk in source.split("__global__")[1:]:
        m = re.search(r"\b(?!__launch_bounds__\b)(\w+)\s*\(", chunk)
        if m:
            names.append(m.group(1))
    return names


def test_every_wgmma_kernel_is_checked_on_the_card_and_no_wmma_remains():
    """chip_smoke.py's phase 1 holds every instantiation of the kernels that
    WGMMA_KERNELS names to no spill, no serialised wgmma, HGMMA and no HMMA:
    each wgmma kernel in csrc must be named there. And the 16-bit paths all
    run on wgmma now, so no WMMA code remains."""
    sources = {p.name: p.read_text() for p in sorted(_build.CSRC.glob("*.cu*"))}
    wgmma = {name for text in sources.values() for name in _global_kernels(text)
             if name.endswith("_wgmma_kernel")}
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    named = ast.literal_eval(re.search(r"^WGMMA_KERNELS = (\(.*?\))", smoke,
                                       re.M | re.S).group(1))
    assert {"flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "flash_bwd_dkv_wgmma_kernel"} <= wgmma
    assert wgmma <= set(named)
    for name, text in sources.items():
        assert "wmma::" not in text and "<mma.h>" not in text, name
