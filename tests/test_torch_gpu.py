"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and skip without one. The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""
import contextlib
import json

import pytest
import torch

from flaxdiff_tpu_torch.ops import (KERNEL_WRAPPERS, bi_conv2d, bi_linear,
                                    dot_product_attention, flash_attention,
                                    flash_bwd_dkv, flash_bwd_dkv_wide, flash_bwd_dq,
                                    flash_bwd_dq_wide, flash_fwd, flash_fwd_wide,
                                    fused_gate_residual, fused_geglu,
                                    fused_groupnorm_silu, fused_ln_modulate, fused_ln_modulate2,
                                    gate_residual_bwd, gate_residual_fwd, geglu_bwd,
                                    groupnorm_bwd_dx, groupnorm_bwd_stats, groupnorm_normalize,
                                    groupnorm_stats, launch_counts, ln_modulate_bwd,
                                    ln_modulate_fwd, reset_launch_counts)
from flaxdiff_tpu_torch.ops.flash_attention import (flash_bwd_dkv_plain, flash_bwd_dq_plain,
                                                    flash_delta, flash_fwd_plain)
from flaxdiff_tpu_torch.ops.fused_adaln import (gate_residual_bwd_plain, gate_residual_plain,
                                                geglu_bwd_plain, geglu_plain,
                                                ln_modulate_bwd_plain, ln_modulate_plain)
from flaxdiff_tpu_torch.ops.fused_norm import (groupnorm_bwd_dx_plain, groupnorm_bwd_finalize,
                                               groupnorm_bwd_stats_plain, groupnorm_finalize,
                                               groupnorm_stats_plain, rows_per_block,
                                               stats_rows_per_block)

pytestmark = pytest.mark.gpu

# (atol, rtol) per element. bf16/f16: rtol is one output ulp relative to the
# value (2^-7, 2^-10), atol covers p rounded to the input dtype against a
# running (kernel) or final (plain) row max
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2.0 ** -7),
       torch.float16: (5e-4, 2.0 ** -10)}


@contextlib.contextmanager
def _route_census():
    """{kernel: calls} of the Dense and ConvLayer modules that took a
    batch-invariant kernel (inference mode, on the card) inside the block:
    the launches those kernels must show."""
    calls = {"bi_gemm": 0, "bi_conv": 0}

    def hook(module, args):
        kernel = getattr(module, "batch_invariant_kernel", None)
        if kernel and torch.is_inference_mode_enabled() and args[0].is_cuda:
            calls[kernel] += 1

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield calls
    finally:
        handle.remove()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)


# the edges of the kernels' tiling: q tiles of 32 (the f32 kernels at head
# dim 256), 64 and 128 rows (1, 65, 130, 200 rows leave them ragged), kv
# tiles of 32 (the 16-bit backward at 256), 64 and 128 rows (77, 127, 129,
# 190, 257 keys, and a single key); head dims 32 (64-byte swizzle), 64, 128
# (two column chunks) and 256 (four; two N = 128 halves of the output, the
# dk/dv kernel's two warpgroups split them). Batch x heads 6 gives fewer
# blocks than SMs (one consumer warpgroup a block), 160 more (two).
FLASH_LQ = [1, 64, 65, 130, 200]
FLASH_LK = [1, 64, 77, 127, 128, 129, 190, 257]
FLASH_BH = [(2, 3), (4, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("lk", FLASH_LK)
@pytest.mark.parametrize("lq", FLASH_LQ)
@pytest.mark.parametrize("b,h", FLASH_BH)
def test_flash_kernel_matches_plain(cuda, dtype, lq, lk, d, b, h):
    q = _randn(cuda, b, lq, h, d, dtype=dtype, seed=1)
    k = _randn(cuda, b, lk, h, d, dtype=dtype, seed=2)
    v = _randn(cuda, b, lk, h, d, dtype=dtype, seed=3)
    out, lse = flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = flash_fwd_plain(q, k, v)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_flash_kernel_takes_strided_projection_views(cuda):
    proj = _randn(cuda, 2, 100, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 100, 4, 64) for t in proj.split(4 * 64, dim=-1))
    out = flash_attention(q, k, v)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


# (shape, groups, storage offset): a bf16 vector straddling two groups
# (C 48, 4 groups), hw = 1, C % 8 != 0 (C 36), an x one element past a
# 16-byte boundary (a contiguous view at a storage offset: the scalar path),
# and the UNet's top level, whose row blocks run up to the batch boundary
GN_FWD_CASES = [((2, 300, 128), 8, 0), ((1, 7, 9, 48), 4, 0), ((2, 16, 1024), 32, 0),
                ((3, 1, 64), 8, 0), ((2, 50, 36), 4, 0), ((2, 300, 128), 8, 1),
                ((2, 65536, 64), 8, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,groups,offset", GN_FWD_CASES)
def test_groupnorm_silu_kernels_match_plain(cuda, dtype, shape, groups, offset):
    n = 1
    for size in shape:
        n *= size
    x = (_randn(cuda, n + offset, dtype=dtype) * 3.0 + 1.0)[offset:].view(shape)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset != 0)
    c = shape[-1]
    w = _randn(cuda, c, seed=4) * 0.1 + 1.0
    b = _randn(cuda, c, seed=5) * 0.1
    out = fused_groupnorm_silu(x, w, b, groups=groups)
    ref = fused_groupnorm_silu(x.cpu(), w.cpu(), b.cpu(), groups=groups)
    # the statistics are summed in another order on the CPU; then the same
    # f32 math, at most one output rounding apart
    torch.testing.assert_close(out.float().cpu(), ref.float(), atol=1e-5, rtol=TOL[dtype][1])


# (shape, groups, mean): the UNet's top level at its serving batch (264
# blocks of 497 rows, the last 429), a ragged last block (7 of 143 rows, the
# last 142), a bf16 vector straddling two groups (C 48), C 4096 (two slices
# of channel vectors in bf16), C % 8 != 0 (the scalar path), mean 100 (the
# shifted sums)
GN_STATS_CASES = [((2, 65536, 64), 8, 0.5), ((2, 1000, 64), 8, 0.5), ((1, 701, 48), 4, 0.5),
                  ((2, 64, 4096), 32, 0.5), ((2, 50, 36), 4, 0.5), ((2, 300, 128), 8, 100.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,groups,mean", GN_STATS_CASES)
def test_groupnorm_stats_kernel_matches_plain(cuda, dtype, shape, groups, mean):
    """The statistics kernel's partials against its plain version over the
    same blocks: f32 sums in another order, the kernel's shifted by each
    block's first row. chip_smoke.py's limits: per element atol 1e-3,
    rtol 1e-5, and 1e-5 on the relative RMS."""
    x = _randn(cuda, *shape, dtype=dtype) * 2.0 + mean
    part = groupnorm_stats(x, groups)
    ref = groupnorm_stats_plain(x, groups, stats_rows_per_block(*shape[1:]))
    torch.testing.assert_close(part, ref, atol=1e-3, rtol=1e-5)
    assert float((part - ref).norm() / ref.norm()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,groups", [((2, 65536, 64), 8), ((2, 50, 36), 4)])
def test_groupnorm_stats_is_deterministic(cuda, dtype, shape, groups):
    """No atomics, a fixed reduction order: two launches give bit-equal
    partials (16-byte and scalar paths)."""
    x = _randn(cuda, *shape, dtype=dtype) * 3.0 + 1.0
    assert torch.equal(groupnorm_stats(x, groups), groupnorm_stats(x, groups))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_geglu_kernel_matches_plain(cuda, dtype):
    for shape in [(2, 50, 256), (3, 7, 2 * 13)]:   # 16-byte and scalar paths
        p = _randn(cuda, *shape, dtype=dtype) * 2.0
        torch.testing.assert_close(fused_geglu(p).float(), geglu_plain(p).float(),
                                   atol=1e-5, rtol=TOL[dtype][1])


def test_each_wrapper_counts_its_launches(cuda):
    """One forward and one backward through each differentiable op: every
    kernel, forward and backward, launches once."""
    reset_launch_counts()
    q = _randn(cuda, 1, 64, 2, 64).requires_grad_()
    x = _randn(cuda, 1, 16, 32).requires_grad_()
    loss = flash_attention(q, q, q).sum()
    loss = loss + fused_groupnorm_silu(x, torch.ones(32, device=cuda),
                                       torch.zeros(32, device=cuda), groups=4).sum()
    loss = loss + fused_geglu(torch.cat([x, x], dim=-1)).sum()
    m = _randn(cuda, 1, 1, 32, seed=2).requires_grad_()
    loss = loss + fused_gate_residual(x, m, fused_ln_modulate(x, m, m).to(x.dtype)).sum()
    wide = _randn(cuda, 1, 64, 1, 320, seed=3).requires_grad_()
    loss = loss + flash_attention(wide, wide, wide).sum()
    loss.backward()
    # the batch-invariant kernels have no backward
    w = _randn(cuda, 8, 32, seed=4)
    bi_linear(x.detach(), w, None)
    bi_conv2d(x.detach().view(1, 4, 4, 32), w.view(8, 32, 1, 1), None, (1, 1), ((0, 0), (0, 0)))
    torch.cuda.synchronize()
    assert launch_counts() == {name: 1 for name in KERNEL_WRAPPERS}


def test_kernels_raise_on_what_they_cannot_take(cuda):
    q = _randn(cuda, 1, 16, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    # each forward wrapper takes its own head dims only: 288 no kernel, 256
    # not the wide kernels', 320 not the D <= 256 kernels'
    for fwd, d in ((flash_attention, 288), (flash_fwd_wide, 256), (flash_fwd, 320)):
        q = _randn(cuda, 1, 16, 2, d)
        with pytest.raises(ValueError, match="head dim"):
            fwd(q, q, q)
    x = _randn(cuda, 1, 16, 2 * 64)[..., 1:65]      # one-element offset: misaligned
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(x.view(1, 16, 1, 64), x.view(1, 16, 1, 64), x.view(1, 16, 1, 64))
    h = _randn(cuda, 1, 8, 8, 32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_groupnorm_silu(h, torch.ones(32, device=cuda), torch.zeros(32, device=cuda),
                             groups=4)
    with pytest.raises(TypeError):
        fused_geglu(_randn(cuda, 1, 4, 8).double())
    # the two kernel wrappers on their own, given a strided [1, 16, 32] view
    x = _randn(cuda, 1, 32, 16).transpose(1, 2)
    stats = torch.zeros(1, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_stats(x, 4)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_normalize(x, stats, stats + 1.0, torch.ones(32, device=cuda),
                            torch.zeros(32, device=cuda), True)


def test_tiny_unet_forward_card_matches_cpu(cuda):
    from flaxdiff_tpu_torch.models import Unet
    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8, context_dim=24)
    cpu = Unet(**cfg, device="cpu").eval()
    with torch.no_grad():
        for t in cpu.state_dict().values():
            t.copy_(torch.randn_like(t) * 0.2 if t.ndim < 2
                    else torch.randn_like(t) / t[0].numel() ** 0.5)
    gpu = Unet(**cfg, device=cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    x, t, c = torch.randn(2, 16, 16, 3), torch.tensor([3.0, 700.0]), torch.randn(2, 5, 24)
    with torch.inference_mode():
        ref = cpu(x, t, c)
        out = gpu(x.to(cuda), t.to(cuda), c.to(cuda)).cpu()
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)


# backward kernels against their plain versions: per element
# |out - ref| <= atol * max|ref| + rtol |ref|. bf16/f16: rtol is one output
# ulp; atol covers p and ds rounded to the input dtype on both sides from
# f32 values summed in another order (a rounding that flips moves a gradient
# by about one ulp of ds times |k|)
BWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2.0 ** -7),
           torch.float16: (1e-3, 2.0 ** -10)}


def _close(out, ref, dtype):
    atol, rtol = BWD_TOL[dtype]
    ref = ref.float()
    torch.testing.assert_close(out.float(), ref, atol=atol * float(ref.abs().max()), rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("lk", FLASH_LK)
@pytest.mark.parametrize("lq", FLASH_LQ)
@pytest.mark.parametrize("b,h", FLASH_BH)
def test_flash_bwd_kernels_match_plain(cuda, dtype, lq, lk, d, b, h):
    q = _randn(cuda, b, lq, h, d, dtype=dtype, seed=1)
    k = _randn(cuda, b, lk, h, d, dtype=dtype, seed=2)
    v = _randn(cuda, b, lk, h, d, dtype=dtype, seed=3)
    do = _randn(cuda, b, lq, h, d, dtype=dtype, seed=4)
    out, lse = flash_fwd(q, k, v)
    delta = flash_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dq_ref = flash_bwd_dq_plain(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    _close(dv, dv_ref, dtype)
    if lk == 1:
        # one key: p = 1 whatever the score, so ds = p (dO v^T - delta) scale
        # and with it dq and dk are zero by the math; both sides hold f32
        # rounding of dO v^T - delta, far below the gradients that are not
        # zero (dv)
        for g in (dq, dq_ref, dk, dk_ref):
            assert float(g.float().abs().max()) <= 1e-4 * float(dv_ref.float().abs().max())
        return
    _close(dq, dq_ref, dtype)
    _close(dk, dk_ref, dtype)


@pytest.mark.parametrize("d", [40, 72, 80, 96, 160, 192, 288, 300])
def test_attention_dispatch_pads_odd_head_dims(cuda, d):
    """The dispatch zero-pads a head dim the kernels do not take to the next
    they do (up to 256 the next of 32, 64, 128 and 256; above, the next
    multiple of 64, for the wide kernels): forward and dq, dk, dv in bf16
    against the plain versions at the true head dim, within the flash bf16
    limits."""
    q = _randn(cuda, 2, 130, 4, d, dtype=torch.bfloat16, seed=1).requires_grad_()
    k = _randn(cuda, 2, 77, 4, d, dtype=torch.bfloat16, seed=2).requires_grad_()
    v = _randn(cuda, 2, 77, 4, d, dtype=torch.bfloat16, seed=3).requires_grad_()
    do = _randn(cuda, 2, 130, 4, d, dtype=torch.bfloat16, seed=4)
    reset_launch_counts()
    out = dot_product_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    counts = launch_counts()
    suffix = "_wide" if d > 256 else ""
    assert [counts[n + suffix] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [1] * 3
    with torch.no_grad():
        ref, lse = flash_fwd_plain(q, k, v)
        delta = flash_delta(ref, do)
        refs = (flash_bwd_dq_plain(q, k, v, do, lse, delta),
                *flash_bwd_dkv_plain(q, k, v, do, lse, delta))
    atol, rtol = TOL[torch.bfloat16]
    assert out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for grad, grad_ref in zip(grads, refs):
        _close(grad, grad_ref, torch.bfloat16)


def test_flash_bwd_takes_strided_projection_views(cuda):
    """q/k/v as views of one [B, L, 3*H*D] projection, as the attention
    layers pass them: the same gradients as contiguous copies."""
    proj = _randn(cuda, 2, 100, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 100, 4, 64) for t in proj.split(4 * 64, dim=-1))
    do = _randn(cuda, 2, 100, 4, 64, dtype=torch.bfloat16, seed=5)
    out, lse = flash_fwd(q, k, v)
    delta = flash_delta(out, do)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    assert torch.equal(flash_bwd_dq(q, k, v, do, lse, delta),
                       flash_bwd_dq(qc, kc, vc, do, lse, delta))
    for a, b in zip(flash_bwd_dkv(q, k, v, do, lse, delta),
                    flash_bwd_dkv(qc, kc, vc, do, lse, delta)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_bwd_is_deterministic(cuda, dtype, d, kernel):
    """No atomics, a fixed order over the kv tiles (dq) or the q tiles
    (dk/dv): two runs give bit-equal gradients."""
    q, k, v, do = (_randn(cuda, 4, 300, 40, d, dtype=dtype, seed=s) for s in range(4))
    out, lse = flash_fwd(q, k, v)
    delta = flash_delta(out, do)
    if kernel == "dq":
        run = lambda: (flash_bwd_dq(q, k, v, do, lse, delta),)
    else:
        run = lambda: flash_bwd_dkv(q, k, v, do, lse, delta)
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_replay_in_cuda_graph(cuda, dtype, d):
    """The forward, dq and dk/dv kernels captured in a CUDA graph and
    replayed give what eager calls give: the tensor maps travel with the
    graph."""
    q, k, v, do = (_randn(cuda, 2, 200, 6, d, dtype=dtype, seed=s) for s in range(4))
    eager_out, eager_lse = flash_fwd(q, k, v)
    delta = flash_delta(eager_out, do)
    eager_dq = flash_bwd_dq(q, k, v, do, eager_lse, delta)
    eager_dk, eager_dv = flash_bwd_dkv(q, k, v, do, eager_lse, delta)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out, lse = flash_fwd(q, k, v)
        dq = flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    for t in (out, lse, dq, dk, dv):
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in ((out, eager_out), (lse, eager_lse), (dq, eager_dq), (dk, eager_dk),
                      (dv, eager_dv)):
        assert torch.equal(got, want)


# --- head dims above 256: the column-chunked (wide) kernels ---------------------
#
# D 320 (UNet3D's 1280 channels in 4 heads: three 128-column chunks, the last
# of 64, and five 64-column score chunks), 384 (whole 128-column chunks) and
# 640; self-attention, cross to 77 keys and a ragged case (q and kv tiles of
# 64 and 32 rows left partial)
WIDE_LQ_LK = [(128, 128), (200, 77), (65, 190)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [320, 384, 640])
@pytest.mark.parametrize("lq,lk", WIDE_LQ_LK)
def test_flash_wide_kernels_match_plain(cuda, dtype, lq, lk, d):
    """The wide forward, dq and dk/dv kernels against the plain versions,
    under the limits of the D <= 256 kernels."""
    q = _randn(cuda, 2, lq, 3, d, dtype=dtype, seed=1)
    k = _randn(cuda, 2, lk, 3, d, dtype=dtype, seed=2)
    v = _randn(cuda, 2, lk, 3, d, dtype=dtype, seed=3)
    do = _randn(cuda, 2, lq, 3, d, dtype=dtype, seed=4)
    out, lse = flash_fwd_wide(q, k, v)
    ref, ref_lse = flash_fwd_plain(q, k, v)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = flash_delta(out, do)
    dq = flash_bwd_dq_wide(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv_wide(q, k, v, do, lse, delta)
    _close(dq, flash_bwd_dq_plain(q, k, v, do, lse, delta), dtype)
    for got, want in zip((dk, dv), flash_bwd_dkv_plain(q, k, v, do, lse, delta)):
        _close(got, want, dtype)


# fault C5: batch * heads past gridDim.y's 65535, as a video UNet's temporal
# attention runs it (B*H*W sequences of 16 frames): the JAX default UNet3D's
# level 0 at 64x64, batch 8 (131072 at head dim 32), and 65600 at 320 (the
# wide kernels)
C5_CASES = [(32768, 4, 32), (16400, 4, 320)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,d", C5_CASES, ids=["bh131072-d32", "bh65600-d320"])
def test_flash_kernels_take_any_batch_heads(cuda, dtype, b, h, d):
    """Forward, dq and dk/dv over 16 frames at batch * heads above 65535
    against the plain versions, under the limits of the cases above."""
    wide = d > 256
    fwd, bwd_dq, bwd_dkv = ((flash_fwd_wide, flash_bwd_dq_wide, flash_bwd_dkv_wide) if wide
                            else (flash_fwd, flash_bwd_dq, flash_bwd_dkv))
    q, k, v, do = (_randn(cuda, b, 16, h, d, dtype=dtype, seed=s) for s in (1, 2, 3, 4))
    out, lse = fwd(q, k, v)
    ref, ref_lse = flash_fwd_plain(q, k, v)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    delta = flash_delta(out, do)
    _close(bwd_dq(q, k, v, do, lse, delta), flash_bwd_dq_plain(q, k, v, do, lse, delta), dtype)
    for got, want in zip(bwd_dkv(q, k, v, do, lse, delta),
                         flash_bwd_dkv_plain(q, k, v, do, lse, delta)):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [320, 384, 640])
def test_flash_wide_lse_is_bit_equal_across_column_chunks(cuda, dtype, d):
    """Every column chunk of a q tile sums the same scores in the same
    order: each chunk's own lse is bit-equal to chunk 0's, which the kernel
    returns."""
    q, k, v = (_randn(cuda, 2, n, 3, d, dtype=dtype, seed=s) for s, n in ((1, 200), (2, 77), (3, 77)))
    out, lse = flash_fwd_wide(q, k, v)
    out_c, lse_c = flash_fwd_wide(q, k, v, chunk_lse=True)
    assert lse_c.shape[0] == -(-d // (64 if dtype == torch.float32 else 128)) > 1
    for c in range(lse_c.shape[0]):
        assert torch.equal(lse_c[c], lse), c
    assert torch.equal(out_c, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wide_kernels_are_deterministic(cuda, dtype):
    """No atomics and a fixed loop order: two runs of each wide kernel give
    bit-equal results."""
    q, k, v, do = (_randn(cuda, 2, 300, 4, 320, dtype=dtype, seed=s) for s in range(4))
    run = lambda: (*flash_fwd_wide(q, k, v),)
    first, second = run(), run()
    out, lse = first
    delta = flash_delta(out, do)
    first += (flash_bwd_dq_wide(q, k, v, do, lse, delta),
              *flash_bwd_dkv_wide(q, k, v, do, lse, delta))
    second += (flash_bwd_dq_wide(q, k, v, do, lse, delta),
               *flash_bwd_dkv_wide(q, k, v, do, lse, delta))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [320, 384])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wide_kernels_replay_in_cuda_graph(cuda, dtype, d):
    """The wide kernels captured in a CUDA graph and replayed give what
    eager calls give."""
    q, k, v, do = (_randn(cuda, 2, 200, 3, d, dtype=dtype, seed=s) for s in range(4))
    eager_out, eager_lse = flash_fwd_wide(q, k, v)
    delta = flash_delta(eager_out, do)
    eager_dq = flash_bwd_dq_wide(q, k, v, do, eager_lse, delta)
    eager_dk, eager_dv = flash_bwd_dkv_wide(q, k, v, do, eager_lse, delta)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out, lse = flash_fwd_wide(q, k, v)
        dq = flash_bwd_dq_wide(q, k, v, do, lse, delta)
        dk, dv = flash_bwd_dkv_wide(q, k, v, do, lse, delta)
    for t in (out, lse, dq, dk, dv):
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in ((out, eager_out), (lse, eager_lse), (dq, eager_dq), (dk, eager_dk),
                      (dv, eager_dv)):
        assert torch.equal(got, want)


# (shape, groups): a bf16 vector straddling two groups (C 48, 4 groups), the
# UNet's top level at batch 2 (one wave of dx blocks strides over many rows;
# 128 stats blocks), a row count that leaves every kernel a partial last step
# (stats blocks of 143 rows, the last 142), and C 1024 in 32 groups
GN_BWD_CASES = [((2, 300, 128), 8), ((1, 63, 48), 4), ((2, 16, 1024), 32),
                ((2, 16384, 64), 8), ((3, 1000, 64), 8)]


def _gn_bwd_inputs(cuda, shape, groups, dtype):
    x = _randn(cuda, *shape, dtype=dtype) * 3.0 + 1.0
    g = _randn(cuda, *shape, dtype=dtype, seed=6)
    c = shape[-1]
    w = _randn(cuda, c, seed=4) * 0.1 + 1.0
    b = _randn(cuda, c, seed=5) * 0.1
    mean, rstd = groupnorm_finalize(groupnorm_stats(x, groups), shape[1], c, 1e-6)
    return x, g, mean, rstd, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("shape,groups", GN_BWD_CASES)
def test_groupnorm_bwd_kernels_match_plain(cuda, dtype, apply_silu, shape, groups):
    x, g, mean, rstd, w, b = _gn_bwd_inputs(cuda, shape, groups, dtype)
    gs, cs = groupnorm_bwd_stats(x, g, mean, rstd, w, b, apply_silu)
    gs_ref, cs_ref = groupnorm_bwd_stats_plain(x, g, mean, rstd, w, b, apply_silu,
                                               rows_per_block(*shape))
    # f32 sums of up to 1024 rows a block in another order
    torch.testing.assert_close(gs, gs_ref, atol=1e-5 * float(gs_ref.abs().max()), rtol=1e-5)
    torch.testing.assert_close(cs, cs_ref, atol=1e-5 * float(cs_ref.abs().max()), rtol=1e-5)
    s, _, _ = groupnorm_bwd_finalize(gs_ref, cs_ref, shape[1])
    dx = groupnorm_bwd_dx(x, g, mean, rstd, w, b, s, apply_silu)
    ref = groupnorm_bwd_dx_plain(x, g, mean, rstd, w, b, s, apply_silu)
    # the same f32 math, at most one output rounding apart
    torch.testing.assert_close(dx.float(), ref.float(), atol=1e-5, rtol=TOL[dtype][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 16384, 64), 8), ((2, 50, 36), 4)])
def test_groupnorm_bwd_stats_is_deterministic(cuda, dtype, shape, groups):
    """No atomics, a fixed reduction order: two launches give bit-equal sums
    (16-byte and scalar paths)."""
    x, g, mean, rstd, w, b = _gn_bwd_inputs(cuda, shape, groups, dtype)
    first = groupnorm_bwd_stats(x, g, mean, rstd, w, b, True)
    second = groupnorm_bwd_stats(x, g, mean, rstd, w, b, True)
    for a, b2 in zip(first, second):
        assert torch.equal(a, b2)


# (shape): 16-byte paths at F 128, 1024 (the UNet's GEGLU at 512 channels)
# and 2048 with column blocks of 128 threads left partial (F 1280), row counts
# not a multiple of the kernel's 4 rows a thread, and the scalar path
GEGLU_BWD_SHAPES = [(2, 50, 256), (2, 1023, 2048), (1, 77, 4096), (3, 5, 2560), (3, 7, 2 * 13)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", GEGLU_BWD_SHAPES)
def test_geglu_bwd_kernel_matches_plain(cuda, dtype, shape):
    """atol 1e-5, rtol one output ulp (2^-7 bf16, 2^-10 f16: the 16-bit
    path's tanh-free gelu is a few f32 ulps from tanhf) and 1e-5 in f32;
    relative RMS 1e-3."""
    p = _randn(cuda, *shape, dtype=dtype) * 2.0
    d = _randn(cuda, *shape[:-1], shape[-1] // 2, dtype=dtype, seed=7)
    out, ref = geglu_bwd(p, d).float(), geglu_bwd_plain(p, d).float()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=TOL[dtype][1])
    assert float((out - ref).norm() / ref.norm()) <= 1e-3


def test_autograd_through_the_kernels_matches_cpu(cuda):
    """Gradients of a small composition of the three differentiable ops, f32,
    card (kernels) against CPU (plain versions)."""
    def run(dev):
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(2, 40, 64, generator=gen).to(dev).requires_grad_()
        w = (torch.rand(64, generator=gen) + 0.5).to(dev).requires_grad_()
        b = (0.1 * torch.randn(64, generator=gen)).to(dev).requires_grad_()
        ctx = torch.randn(2, 77, 64, generator=gen).to(dev).requires_grad_()
        h = fused_groupnorm_silu(x, w, b, groups=8)
        h = flash_attention(h.view(2, 40, 2, 32), ctx.view(2, 77, 2, 32),
                            ctx.view(2, 77, 2, 32)).reshape(2, 40, 64)
        loss = (fused_geglu(torch.cat([h, x], dim=-1)) ** 2).sum()
        return torch.autograd.grad(loss, (x, w, b, ctx))

    for out, ref in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)


def test_tiny_unet_train_step_card_matches_cpu(cuda):
    """Loss and every gradient of one train step, f32, same weights and
    draws on both sides."""
    import numpy as np
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder

    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8, context_dim=24)
    rng = np.random.default_rng(0)
    arrays = dict(sample=rng.standard_normal((2, 16, 16, 3)), cond=rng.standard_normal((2, 77, 24)),
                  noise=rng.standard_normal((2, 16, 16, 3)))
    t = torch.tensor([3, 700], dtype=torch.int32)
    mask = torch.tensor([False, True])
    cpu = Unet(**cfg, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn_like(p) * 0.2 if p.ndim < 2 else torch.randn_like(p) / p[0].numel() ** 0.5)
    gpu = Unet(**cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    results = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        a = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in arrays.items()}
        build = make_loss_builder(CosineNoiseSchedule(1000, device=dev),
                                  EpsilonPredictionTransform(), TrainStepConfig(normalize=False),
                                  null_cond=torch.zeros(1, 77, 24, device=dev))
        loss = build({"sample": a["sample"], "cond": a["cond"]}, a["noise"], t.to(dev),
                     mask.to(dev))(model)
        results.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (loss, grads), (ref_loss, ref_grads) = results
    torch.testing.assert_close(loss.cpu(), ref_loss, atol=0, rtol=1e-5)
    gmax = max(float(r.abs().max()) for r in ref_grads)
    for (name, _), g, r in zip(cpu.named_parameters(), grads, ref_grads):
        if name.endswith("to_k.bias"):
            # zero by the math (softmax ignores the shift a key bias adds to
            # every logit of a row): both sides hold f32 rounding
            assert max(float(g.abs().max()), float(r.abs().max())) <= 1e-6 * gmax, name
            continue
        torch.testing.assert_close(g.cpu(), r, atol=1e-4 * float(r.abs().max()), rtol=0)


def test_train_step_flops_on_the_card_equal_the_cpu_count(cuda):
    """A train step's model FLOPs on the card, where autograd runs the flash
    backward on its device thread, equal the CPU count: attention's four
    backward products are counted there too."""
    import numpy as np
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.profiling import model_flops
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import DiffusionTrainer, TrainerConfig, adamw

    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8)
    sample = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    counts = {}
    for dev in (cuda, torch.device("cpu")):
        trainer = DiffusionTrainer(Unet(**cfg, device=dev), adamw(1e-3),
                                   CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
                                   TrainerConfig(), device=dev)
        counts[dev.type] = model_flops(trainer.train_step,
                                       {"sample": torch.from_numpy(sample).to(dev)})
    assert counts["cuda"] == counts["cpu"] > 0


# --- the AdaLN kernels (B10-B13) ---------------------------------------------------

def _adaln_inputs(cuda, shape, dtype, nviews):
    b, _, c = shape
    x = _randn(cuda, *shape, dtype=dtype, seed=1) * 2.0 + 3.0
    mods = [(_randn(cuda, b, 1, c, dtype=dtype, seed=2 + i) * 0.5) for i in range(2 * nviews)]
    gs = [_randn(cuda, *shape, seed=10 + i) for i in range(nviews)]
    return x, mods, gs


# (shape): DiT-B at its training rows, a ragged L = 77, and a C that takes
# the scalar path (not a multiple of the 16-byte vector); then the other
# widths B10's row kernel is compiled for (DiT-S 384, -L 1024, -XL 1152), a
# ragged row count (L = 77, odd batch) at one of them, and a 16-byte width
# it is not compiled for (1280: the generic kernel)
ADALN_SHAPES = [(4, 256, 768), (3, 77, 768), (2, 19, 36), (2, 64, 384), (3, 77, 1024),
                (2, 40, 1152), (2, 33, 1280)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("nviews", [1, 2])
@pytest.mark.parametrize("shape", ADALN_SHAPES)
def test_ln_modulate_kernels_match_plain(cuda, dtype, nviews, shape):
    x, mods, gs = _adaln_inputs(cuda, shape, dtype, nviews)
    pairs = tuple(zip(mods[0::2], mods[1::2]))
    views, mean, rstd = ln_modulate_fwd(x, pairs, 1e-5)
    ref_views, ref_mean, ref_rstd = ln_modulate_plain(x, pairs, 1e-5)
    # f32 row sums in another order, then the same f32 math: a few ulps
    for out, ref in zip(views, ref_views):
        torch.testing.assert_close(out, ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-5)
    torch.testing.assert_close(mean, ref_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, atol=1e-5, rtol=1e-5)
    scales = [s for s, _ in pairs]
    dx, part = ln_modulate_bwd(x, scales, ref_mean, ref_rstd, gs)
    dx_ref, part_ref = ln_modulate_bwd_plain(x, scales, ref_mean, ref_rstd, gs)
    # the same f32 math, at most one output rounding apart
    torch.testing.assert_close(dx.float(), dx_ref.float(),
                               atol=1e-5 * float(dx_ref.float().abs().max()),
                               rtol=TOL[dtype][1])
    # f32 sums of 16 rows a block in another order
    torch.testing.assert_close(part, part_ref, atol=1e-5 * float(part_ref.abs().max()), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", ADALN_SHAPES)
def test_gate_residual_kernels_match_plain(cuda, dtype, shape):
    x = _randn(cuda, *shape, dtype=dtype, seed=1)
    h = _randn(cuda, *shape, dtype=dtype, seed=2)
    dout = _randn(cuda, *shape, dtype=dtype, seed=3)
    # a [B, 1, C] chunk of a packed projection, as the DiT passes it
    gate = _randn(cuda, shape[0], 1, 6 * shape[2], dtype=dtype, seed=4).chunk(6, dim=-1)[2]
    # the product and the sum rounded apart, as torch does: bit-equal
    assert torch.equal(gate_residual_fwd(x, gate, h), gate_residual_plain(x, gate, h))
    dh, part = gate_residual_bwd(gate, h, dout)
    dh_ref, part_ref = gate_residual_bwd_plain(gate, h, dout)
    assert torch.equal(dh, dh_ref)
    torch.testing.assert_close(part, part_ref, atol=1e-5 * float(part_ref.abs().max()), rtol=1e-5)


def test_adaln_ops_card_match_cpu(cuda):
    """Gradients through the two-view LayerNorm + modulate and the gated
    residual, f32, card (kernels) against CPU (plain versions)."""
    def run(dev):
        gen = torch.Generator().manual_seed(5)
        leaf = lambda *s: torch.randn(*s, generator=gen).to(dev).requires_grad_()
        x, s1, b1, s2, b2, g = leaf(2, 40, 96), *(leaf(2, 1, 96) for _ in range(5))
        a, m = fused_ln_modulate2(x, s1, b1, s2, b2)
        y = fused_gate_residual(x, g, a * m)
        loss = (y * y).sum()
        return torch.autograd.grad(loss, (x, s1, b1, s2, b2, g))

    for out, ref in zip(run(cuda), run("cpu")):
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)


def test_tiny_dit_card_matches_cpu(cuda):
    """The tiny DiT's forward, f32, and one train step's loss and gradients,
    card against CPU with the same weights."""
    from flaxdiff_tpu_torch.models import SimpleDiT
    cfg = dict(output_channels=4, patch_size=2, emb_features=128, num_layers=2, num_heads=2,
               in_channels=4, context_dim=32)
    cpu = SimpleDiT(**cfg, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn_like(p) * 0.2 if p.ndim < 2 else torch.randn_like(p) / p[0].numel() ** 0.5)
    gpu = SimpleDiT(**cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(6)
    x, c = torch.randn(2, 16, 16, 4, generator=gen), torch.randn(2, 7, 32, generator=gen)
    t = torch.tensor([3.0, 700.0])
    results = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        out = model(x.to(dev), t.to(dev), c.to(dev))
        loss = out.square().mean()
        results.append((out.detach().cpu(), loss, torch.autograd.grad(loss, list(model.parameters()))))
    (out, loss, grads), (ref, ref_loss, ref_grads) = results
    torch.testing.assert_close(out, ref, atol=1e-4 * float(ref.abs().max()), rtol=0)
    torch.testing.assert_close(loss.cpu(), ref_loss, atol=0, rtol=1e-5)
    gmax = max(float(r.abs().max()) for r in ref_grads)
    for (name, _), g, r in zip(cpu.named_parameters(), grads, ref_grads):
        if float(r.abs().max()) <= 1e-6 * gmax:
            assert float(g.abs().max()) <= 1e-6 * gmax, name
            continue
        torch.testing.assert_close(g.cpu(), r, atol=1e-4 * float(r.abs().max()), rtol=0)


# --- every model family on the card -------------------------------------------------

_VIT = dict(patch_size=2, emb_features=64, num_layers=2, num_heads=2)
FAMILY_CASES = {
    "unet-ref_arch-gelu-separable": ("unet", dict(
        emb_features=32, feature_depths=(32, 64), num_res_blocks=1, norm_groups=8,
        attention_configs=[None, {"heads": 2, "dim_head": 32, "only_pure_attention": True}],
        activation="gelu", conv_type="separable")),
    "unet-remat": ("unet", dict(
        emb_features=32, feature_depths=(32, 64), num_res_blocks=1, norm_groups=8,
        attention_configs=[None, {"heads": 2, "dim_head": 32}], remat=True)),
    "uvit-residual": ("uvit", dict(_VIT, add_residualblock_output=True, max_image_size=16)),
    "simple_udit": ("simple_udit", _VIT),
    "simple_mmdit-unfused": ("simple_mmdit", dict(_VIT, fused_epilogues=False)),
    "simple_mmdit+hilbert": ("simple_mmdit+hilbert", dict(_VIT, learn_sigma=True)),
    "hierarchical_mmdit": ("hierarchical_mmdit", dict(
        base_patch_size=2, emb_features=(64, 128), num_layers=(1, 1), num_heads=(1, 2))),
    "hybrid_ssm+hilbert+2d": ("hybrid_ssm+hilbert+2d", dict(_VIT, num_layers=4,
                                                            ssm_state_dim=16)),
}


def _random_weights(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            r = torch.randn(p.shape, generator=gen)
            p.copy_(r * 0.2 if p.ndim < 2 else r / p[0].numel() ** 0.5)


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_model_family_card_matches_cpu(cuda, case):
    """Each 2D family of the registry at tiny widths, f32: the forward and
    every gradient, card (kernels) against CPU (plain versions), the same
    weights."""
    from flaxdiff_tpu_torch.inference import build_model
    name, cfg = FAMILY_CASES[case]
    cpu = build_model(name, device="cpu", context_dim=32, **cfg)
    _random_weights(cpu, 7)
    gpu = build_model(name, device=cuda, context_dim=32, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(8)
    x, c = torch.randn(2, 16, 16, 3, generator=gen), torch.randn(2, 7, 32, generator=gen)
    t = torch.tensor([3.0, 700.0])
    results = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        out = model(x.to(dev), t.to(dev), c.to(dev))
        g = torch.autograd.grad(out.square().mean(), list(model.parameters()))
        results.append((out.detach().cpu(), g))
    (out, grads), (ref, ref_grads) = results
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)
    gmax = max(float(r.abs().max()) for r in ref_grads)
    for (pname, _), g, r in zip(cpu.named_parameters(), grads, ref_grads):
        if float(r.abs().max()) <= 1e-6 * gmax:
            assert float(g.abs().max()) <= 1e-6 * gmax, pname
            continue
        torch.testing.assert_close(g.cpu(), r, atol=1e-3 * float(r.abs().max()), rtol=0,
                                   msg=pname)


@pytest.mark.parametrize("name", ["simple_dit+hilbert", "uvit+hilbert", "simple_mmdit+hilbert",
                                  "hybrid_ssm+zigzag+2d"])
def test_a_scan_order_model_trains_after_sampling_on_the_card(cuda, name):
    """One DDIM request (under inference mode), then one training step of
    the same model: the scan-order indices the request cached on the card
    serve the step's backward."""
    from flaxdiff_tpu_torch.inference import build_model
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DiffusionSampler, get_sampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer, TrainerConfig
    cfg = dict(_VIT, ssm_state_dim=16) if name.startswith("hybrid") else _VIT
    model = build_model(name, device=cuda, in_channels=3, context_dim=32, **cfg)
    null = torch.zeros(1, 7, 32, device=cuda)
    DiffusionSampler(model, CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
                     get_sampler("ddim"), device=cuda).generate_samples(
        1, 16, 2, conditioning=null, unconditional=null)
    trainer = DiffusionTrainer(model, AdamW(1e-3), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), TrainerConfig(seed=1),
                               null_cond=null, device=cuda)
    gen = torch.Generator().manual_seed(11)
    loss = trainer.train_step({"sample": torch.randint(0, 256, (2, 16, 16, 3), generator=gen,
                                                       dtype=torch.uint8),
                               "cond": torch.randn(2, 7, 32, generator=gen)})
    assert torch.isfinite(loss).all()


@pytest.mark.parametrize("name", ["unet", "simple_dit"])
def test_remat_is_bit_equal_on_the_card(cuda, name):
    """remat=True against remat=False in bf16 on the card: the output and
    every gradient bit for bit (cuDNN's deterministic algorithms asked for;
    the port's kernels are deterministic)."""
    from flaxdiff_tpu_torch.inference import build_model
    cfg = (dict(emb_features=32, feature_depths=(32, 64), num_res_blocks=1, norm_groups=8,
                attention_configs=[None, {"heads": 2, "dim_head": 32}])
           if name == "unet" else _VIT)
    gen = torch.Generator().manual_seed(9)
    x, c = torch.randn(4, 16, 16, 3, generator=gen), torch.randn(4, 7, 32, generator=gen)
    t, g = torch.tensor([3.0, 300.0, 600.0, 900.0]), torch.randn(4, 16, 16, 3, generator=gen)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = []
        for remat in (False, True):
            model = build_model(name, device=cuda, context_dim=32, dtype="bfloat16", remat=remat,
                                **cfg)
            _random_weights(model, 10)
            out = model(x.to(cuda), t.to(cuda), c.to(cuda))
            runs.append((out.detach(), torch.autograd.grad((out.float() * g.to(cuda)).sum(),
                                                           list(model.parameters()))))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    (out, grads), (rout, rgrads) = runs
    assert torch.equal(out, rout)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))


# --- samplers on the card ---------------------------------------------------------

SAMPLER_CASES = [("ddpm", {}, "vp"), ("simple_ddpm", {}, "vp"), ("ddim", {}, "vp"),
                 ("ddim", {"eta": 0.5}, "vp"), ("euler", {}, "vp"), ("simple_euler", {}, "vp"),
                 ("euler_ancestral", {}, "vp"), ("heun", {}, "vp"),
                 ("multistep_dpm", {"order": 2}, "vp"), ("multistep_dpm", {"order": 3}, "vp"),
                 ("simple_ddpm", {}, "ve"), ("ddim", {}, "ve"), ("euler", {}, "ve"),
                 ("euler_ancestral", {}, "ve"), ("heun", {}, "ve"), ("rk4", {}, "ve"),
                 ("multistep_dpm", {"order": 2}, "ve")]
STOCHASTIC_SAMPLERS = {"ddpm", "simple_ddpm", "euler_ancestral"}
SAMPLE_SHAPE = (2, 8, 8, 1)


def _schedule(kind):
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, KarrasVENoiseSchedule
    return CosineNoiseSchedule(1000) if kind == "vp" else KarrasVENoiseSchedule(1000,
                                                                             sigma_max=20.0)


def _delta_model(schedule, mu=0.35):
    """A perfect eps-predictor for data ~ delta(mu): the time input is the
    step for VP schedules and c_noise = log(sigma) / 4 for sigma schedules."""
    from flaxdiff_tpu_torch.schedulers import SigmaSchedule, bcast_right

    def model_fn(x, t, cond):
        if isinstance(schedule, SigmaSchedule):
            sigma = torch.exp(4.0 * t)
            signal = torch.ones_like(sigma)
        else:
            signal, sigma = schedule.rates(t)
        return (x - bcast_right(signal, x.ndim) * mu) / torch.clamp_min(
            bcast_right(sigma, x.ndim), 1e-6)
    return model_fn


def _engine(name, kwargs, kind, dev, model=None):
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DiffusionSampler, get_sampler
    schedule = _schedule(kind).to(dev)
    return DiffusionSampler(model or _delta_model(schedule), schedule,
                            EpsilonPredictionTransform(), get_sampler(name, **kwargs),
                            device=dev)


def _draws(name, kwargs, steps, inpaint=False, seed=0):
    """The trajectory's draws, made once on the CPU: the initial noise, a
    stochastic sampler's one a step, inpainting's one a step."""
    gen = torch.Generator().manual_seed(seed)
    per_step = int(name in STOCHASTIC_SAMPLERS or kwargs.get("eta", 0) > 0) + int(inpaint)
    return [torch.randn(SAMPLE_SHAPE, generator=gen) for _ in range(1 + steps * per_step)]


@pytest.mark.parametrize("name,kwargs,kind", SAMPLER_CASES)
def test_sampler_card_matches_cpu(cuda, name, kwargs, kind):
    """Every sampler on the delta model, f32, with the same given draws."""
    from flaxdiff_tpu_torch.samplers import GivenNoise
    draws = _draws(name, kwargs, 6)
    outs = []
    for dev in (cuda, "cpu"):
        given = GivenNoise(draws, device=dev)
        out = _engine(name, kwargs, kind, dev).generate_samples(
            num_samples=2, resolution=8, diffusion_steps=6, generator=given, channels=1)
        assert given.used == len(draws) and out.device.type == torch.device(dev).type
        outs.append(out.cpu())
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,kwargs", [("ddpm", {}), ("simple_ddpm", {}),
                                         ("euler_ancestral", {}), ("ddim", {"eta": 1.0})])
def test_stochastic_samplers_draw_from_a_cuda_generator(cuda, name, kwargs):
    """Seeded runs repeat and differ across seeds: an eps-model linear in x
    carries every draw into the samples (the delta model's would be mu)."""
    from flaxdiff_tpu_torch.device import make_generator
    engine = _engine(name, kwargs, "vp", cuda, model=lambda x, t, c: 0.5 * x)
    run = lambda seed: engine.generate_samples(num_samples=2, resolution=8, diffusion_steps=6,
                                               generator=make_generator(seed, cuda), channels=1)
    a, b, c = run(1), run(1), run(2)
    assert a.device.type == "cuda" and torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name,kwargs,kind", SAMPLER_CASES)
def test_sampler_steps_never_sync_with_the_host(cuda, name, kwargs, kind):
    """Each step of the loop, stochastic draws from a CUDA generator and
    inpainting's re-noising included, under sync debug mode "error": a
    step that reads a value back, or branches on one, raises."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.samplers import NoiseSource, get_timestep_spacing
    engine = _engine(name, kwargs, kind, cuda)
    schedule = engine.schedule
    steps = get_timestep_spacing("linear", 6, schedule.timesteps, device=cuda)
    noise = NoiseSource(make_generator(3, cuda))
    x = noise.normal(SAMPLE_SHAPE) * schedule.max_noise_std()
    known = torch.zeros(SAMPLE_SHAPE, device=cuda)
    mask = torch.ones(SAMPLE_SHAPE, device=cuda)
    denoise = engine._denoise_fn(None, None)
    state = engine.sampler.init_state(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(6):
            x, state = engine.sampler.step(denoise, x, steps[i], steps[i + 1], noise, state,
                                           schedule, i)
            known_t = schedule.add_noise(known, noise.normal(known.shape),
                                         steps[i + 1].expand(x.shape[0]))
            x = mask * x + (1.0 - mask) * known_t
        x0, _ = denoise(x, steps[-1])
        with pytest.raises(RuntimeError):
            float(x0.sum())       # a read-back: the mode is on and catches one
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(x0).all())


@pytest.mark.parametrize("name,kwargs", [("ddim", {}), ("ddpm", {})])
def test_inpainting_card_matches_cpu(cuda, name, kwargs):
    """Masked generation with the same draws on both devices: within 1e-5,
    and the kept region is the reference exactly."""
    from flaxdiff_tpu_torch.samplers import GivenNoise
    gen = torch.Generator().manual_seed(4)
    reference = torch.rand(SAMPLE_SHAPE, generator=gen) * 1.6 - 0.8
    mask = torch.zeros(2, 5, 5)           # resized 5 -> 8, nearest with half-pixel centres
    mask[:, :, :2] = 1.0
    draws = _draws(name, kwargs, 6, inpaint=True)
    outs = []
    for dev in (cuda, "cpu"):
        given = GivenNoise(draws, device=dev)
        out = _engine(name, kwargs, "vp", dev).generate_samples(
            num_samples=2, resolution=8, diffusion_steps=6, generator=given, channels=1,
            inpaint_reference=reference, inpaint_mask=mask)
        assert given.used == len(draws)
        outs.append(out.cpu())
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)
    keep = outs[1] == reference
    assert 0.3 < keep.float().mean() < 0.7
    assert torch.equal(outs[0][keep], reference[keep])


def test_rk4_raises_on_a_vp_schedule_on_the_card(cuda):
    with pytest.raises(TypeError, match="SigmaSchedule"):
        _engine("rk4", {}, "vp", cuda).generate_samples(num_samples=1, resolution=4,
                                                        diffusion_steps=2, channels=1)


# --- the fit loop ---------------------------------------------------------------------

def test_fit_syncs_with_the_host_once_per_window(cuda, monkeypatch):
    """fit on a small UNet under sync debug mode "error": the window's loss
    fetch is the only read-back (counted, with the mode lifted around it),
    so 7 steps in windows of 3 sync 3 times and the steps in between never
    (the upload through pinned memory and a side stream included). Depth 0:
    no bound on the steps in flight, whose backpressure wait would be a
    sync when the card falls behind."""
    import numpy as np
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import (DiffusionTrainer, TrainerConfig, adamw, chain,
                                            clip_by_global_norm, warmup_cosine_decay_schedule)
    from flaxdiff_tpu_torch.trainer import trainer as trainer_module

    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8, context_dim=24)
    tx = chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(0.0, 1e-3, 2, 20)))
    trainer = DiffusionTrainer(Unet(**cfg, device=cuda), tx, CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(),
                               TrainerConfig(log_every=3, pipeline_depth=0),
                               null_cond=torch.zeros(1, 77, 24), device=cuda)
    rng = np.random.default_rng(0)
    batches = [{"sample": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                "cond": rng.standard_normal((2, 77, 24)).astype(np.float32),
                "text": ["bright", "dark"]} for _ in range(8)]
    trainer.fit(iter(batches[:1]), total_steps=1)    # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    fetches = []
    fetch = trainer_module._fetch_losses

    def counted(window):
        torch.cuda.set_sync_debug_mode("default")
        try:
            fetches.append(len(window))
            return fetch(window)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(trainer_module, "_fetch_losses", counted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = trainer.fit(iter(batches[1:]), total_steps=7)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fetches == [3, 3, 1] and hist["steps"] == [3, 6, 7]
    assert all(np.isfinite(hist["loss"])) and trainer.state.step == 8
    assert all(bool(torch.isfinite(v).all()) for v in trainer.state.buffers().values())


def test_float16_cli_backs_the_loss_scale_off_on_the_card(cuda, tmp_path):
    """The CLI's float16 run on the card: a small UNet, MultiSteps(2) over
    lamb, 4 micro-steps through the f16 kernels (each forward and backward
    kernel launched), then a NaN batch: the scale halves, fin_steps resets,
    and the params, moments, accumulator and counts stay as they were."""
    import json

    import numpy as np
    from flaxdiff_tpu_torch import train

    cfg = dict(emb_features=32, feature_depths=(32, 64), num_res_blocks=1, norm_groups=8,
               attention_configs=(None, {"heads": 2, "dim_head": 32}))
    run = train.make_run(["--device", "cuda", "--image_size", "16", "--batch_size", "2",
                          "--dtype", "float16", "--model_config", json.dumps(cfg),
                          "--grad_accum", "2", "--optimizer", "lamb", "--total_steps", "4",
                          "--save_every", "100", "--log_every", "2",
                          "--checkpoint_dir", str(tmp_path)])
    trainer, state = run.trainer, run.trainer.state
    reset_launch_counts()
    hist = trainer.fit(run.batches(0), total_steps=4)
    counts = launch_counts()
    assert all(np.isfinite(hist["loss"])) and state.step == 4
    assert all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gn_stats",
                                       "gn_norm", "gn_bwd_stats", "gn_bwd_dx", "geglu",
                                       "geglu_bwd"))
    stream = run.batches(4)
    batch = next(stream)
    stream.close()
    batch["sample"] = np.full(batch["sample"].shape, np.nan, np.float32)
    before = {k: v.clone() for k, v in state.buffers().items()}
    assert not np.isfinite(float(trainer.train_step(batch)))
    after = state.buffers()
    for k in ("params", "exp_avg", "exp_avg_sq", "acc", "count", "mini_step"):
        assert torch.equal(before[k], after[k]), k
    assert float(after["loss_scale"]) == float(before["loss_scale"]) / 2
    assert int(after["loss_scale_fin_steps"]) == 0 and state.step == 5
    trainer.checkpointer.close()


# --- the training-free caches ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["timestep", "composed"])
def test_cached_dit_request_never_syncs_and_launches_as_planned(cuda, kind):
    """A cached DDIM + CFG trajectory of a small bf16 DiT under sync debug
    mode "error" (the plan's row is host numpy, the token selection stays on
    the card), its launches zeroed just before: every step runs all blocks
    (refresh, spatial) or the shallow split (reuse), 1 attention, 2
    LayerNorm + modulate and 2 gated residuals a block, plus the terminal
    call's."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.ops.diffcache import CachePlan, resolve_cache_fns
    from flaxdiff_tpu_torch.ops.spatialcache import (CODE_REUSE, ComposedPlan, SpatialPlan,
                                                     resolve_composed_fns)
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import (DDIMSampler, DiffusionSampler, NoiseSource,
                                             get_timestep_spacing)
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule
    layers, steps = 5, 12
    model = SimpleDiT(output_channels=4, patch_size=2, emb_features=128, num_layers=layers,
                      num_heads=2, in_channels=4, context_dim=32, dtype="bfloat16", device=cuda)
    _random_weights(model)
    timestep = CachePlan(refresh_every=4, refresh_head=1, refresh_tail=1)
    if kind == "timestep":
        plan, fns = timestep, resolve_cache_fns(model, timestep)
        full = plan.flags(steps)
    else:
        plan = ComposedPlan(timestep, SpatialPlan(keep_fraction=0.25, every=2))
        fns = resolve_composed_fns(model, plan)
        full = plan.step_codes(steps) != CODE_REUSE
    engine = DiffusionSampler(lambda x, t, c: model(x, t, c), LinearNoiseSchedule(1000),
                              EpsilonPredictionTransform(), DDIMSampler(), guidance_scale=3.0,
                              device=cuda, cache_plan=plan, cache_fns=fns)
    noise = NoiseSource(make_generator(3, cuda))
    x = noise.normal((2, 16, 16, 4))
    cond = _randn(cuda, 2, 7, 32, seed=4)
    uncond = torch.zeros_like(cond)
    spacing = get_timestep_spacing("linear", steps, 1000, device=cuda)
    with torch.inference_mode():
        engine.run_loop(x, spacing, noise, cond, uncond)      # warm-up: builds, GEMM choices
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with _route_census() as routed:
                x0 = engine.run_loop(x, spacing, noise, cond, uncond)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    blocks = int(full.sum()) * layers + int((~full).sum()) * model.cache_split_index(0.2) + layers
    counts = launch_counts()
    assert counts == {**{k: {"flash_fwd": 1, "ln_mod": 2, "gate_res": 2}.get(k, 0) * blocks
                         for k in counts}, **routed}
    assert bool(torch.isfinite(x0).all())


# --- the serving scheduler -------------------------------------------------------------

def _serving_pipe(cuda):
    """A small bf16 text-free DiT behind the port's pipeline, on the card."""
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.predictors import VPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    model = SimpleDiT(output_channels=4, patch_size=2, emb_features=128, num_layers=3,
                      num_heads=2, in_channels=4, dtype="bfloat16", device=cuda)
    _random_weights(model)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    return DiffusionInferencePipeline(model, params, CosineNoiseSchedule(1000),
                                      VPredictionTransform(), device=cuda)


def _serving_requests():
    from flaxdiff_tpu_torch.serving import SampleRequest
    return [SampleRequest(resolution=16, channels=4, diffusion_steps=n, sampler=s, seed=seed,
                          use_ema=False)
            for n, s, seed in ((5, "euler_ancestral", 1), (8, "euler_ancestral", 2),
                               (3, "euler_ancestral", 3))]


def _serve(pipe, reqs, **cfg):
    from flaxdiff_tpu_torch.serving import SchedulerConfig, ServingScheduler
    from flaxdiff_tpu_torch.telemetry import Telemetry
    sched = ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                             config=SchedulerConfig(**cfg))
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    outs = [f.result(timeout=300) for f in futs]
    sched.close()
    return [o.samples for o in outs]


def test_scheduler_round_never_syncs_on_the_card(cuda):
    """One engine round and its terminal program under sync debug mode
    "error": the step table goes up pinned and non-blocking, nothing is read
    back. The rows' carries were prepared before."""
    from flaxdiff_tpu_torch.serving import SamplerProgramEngine, ServingFuture
    from flaxdiff_tpu_torch.telemetry import Telemetry
    pipe = _serving_pipe(cuda)
    engine = SamplerProgramEngine(pipe, telemetry=Telemetry())
    reqs = _serving_requests()

    def rows():
        return [engine.prepare(r, ServingFuture(), 0.0, 0.0) for r in reqs]

    warm = rows()                       # builds, GEMM choices, pinned blocks
    while warm:
        done, _ = engine.advance(warm, 4, 4)
        if done:
            engine.finalize(done, 4)
        warm = [r for r in warm if r.remaining > 0]
    torch.cuda.synchronize()
    live = rows()
    torch.cuda.set_sync_debug_mode("error")
    try:
        done, _ = engine.advance(live, 4, 4)
        out, _ = engine.finalize(done, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [r.req.seed for r in done] == [3]
    assert tuple(out.shape) == (1, 1, 16, 16, 4) and bool(torch.isfinite(out).all())


def test_batched_request_is_bit_equal_alone_in_its_bucket_on_the_card(cuda):
    """Each request batched with two others (a padding row, rows ending in
    different rounds) equals itself served alone in bucket 4, and the solo
    generate_samples: the served route's Dense and ConvLayer run the
    batch-invariant kernels."""
    import numpy as np
    pipe = _serving_pipe(cuda)
    reqs = _serving_requests()
    batched = _serve(pipe, reqs, round_steps=3, batch_buckets=(4,))
    for r, out in zip(reqs, batched):
        alone = _serve(pipe, [r], round_steps=3, batch_buckets=(4,))[0]
        assert np.array_equal(out, alone), r.seed
        solo = pipe.generate_samples(num_samples=1, resolution=16, channels=4,
                                     diffusion_steps=r.diffusion_steps, sampler=r.sampler,
                                     seed=r.seed, use_ema=False)
        assert np.array_equal(out, solo), r.seed


def test_padding_row_leaves_the_generator_where_solo_leaves_it_on_the_card(cuda):
    """A padding row and the dead steps of a finished row draw nothing: each
    request's CUDA generator ends where its solo trajectory leaves it."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.samplers import NoiseSource
    from flaxdiff_tpu_torch.serving import SchedulerConfig, ServingScheduler
    from flaxdiff_tpu_torch.telemetry import Telemetry
    pipe = _serving_pipe(cuda)
    gens = {}

    def factory(req):
        gens[req.seed] = make_generator(req.seed, cuda)
        return NoiseSource(gens[req.seed])

    reqs = _serving_requests()
    sched = ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                             noise_factory=factory,
                             config=SchedulerConfig(round_steps=4, batch_buckets=(4,)))
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    for f in futs:
        f.result(timeout=300)
    sched.close()
    for r in reqs:
        solo = make_generator(r.seed, cuda)
        pipe.get_sampler(r.sampler).generate_samples(
            num_samples=1, resolution=16, channels=4, diffusion_steps=r.diffusion_steps,
            generator=solo)
        assert torch.equal(gens[r.seed].get_state(), solo.get_state()), r.seed


# --- the batch-invariant linear and convolution (fault C6) ----------------------------

# (batch, rows a sample, K, N): the text's keys (77 rows), a ragged row count
# past one tile, one row, a K that is no multiple of 8 (element-wise loads),
# a K past one 64-wide tile with a tail (72) and N a multiple of 8 but not of
# 64 (the wgmma loop's zero-filled edges), the UNet's level-0 time-embedding
# projection (64 outputs: half of a 128-column tile)
BI_LINEAR_SHAPES = [(2, 77, 768, 512), (3, 129, 256, 2048), (1, 1, 512, 512), (4, 33, 100, 70),
                    (3, 65, 72, 1096), (2, 1, 512, 64)]
# (batch, side, Cin, Cout, kernel, stride, padding): 3x3 SAME, 3 input
# channels (element-wise loads), stride 2 (SAME pads 0 low, 1 high), 1x1, a
# 2x2 patch embedding at stride 2, VALID; a deep 3x3 (K 4608), a side past one 128-pixel tile row, conv_out's 3 outputs (the narrow
# f32 kernel; mma.sync in 16 bits) on a side past one 128-pixel segment
BI_CONV_SHAPES = [(2, 16, 64, 64, 3, 1, "SAME"), (2, 17, 3, 32, 3, 1, "SAME"),
                  (2, 16, 32, 64, 3, 2, "SAME"), (2, 9, 64, 128, 1, 1, "SAME"),
                  (3, 16, 4, 96, 2, 2, "VALID"), (2, 8, 512, 512, 3, 1, "SAME"),
                  (1, 130, 64, 192, 3, 1, "SAME"), (2, 130, 64, 3, 3, 1, "SAME")]
# against the plain version run in f32 on the same inputs and rounded to the
# output dtype: f32 sums in another order, then one rounding (atol relative to
# max|ref|, rtol one output ulp). The 16-bit library calls are no yardstick:
# cuDNN's 3x3 algorithms read 2 bf16 ulps off the f32 result on an H100
BI_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-4, 2.0 ** -7),
          torch.float16: (1e-4, 2.0 ** -10)}
BI_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _same_padding(side, k, stride):
    total = max((-(-side // stride) - 1) * stride + k - side, 0)
    return total // 2, total - total // 2


def _bi_conv_operands(cuda, batch, side, cin, cout, k, stride, pad, dtype):
    from flaxdiff_tpu_torch.ops.batch_invariant import bi_conv2d_plain
    x = _randn(cuda, batch, side, side, cin, dtype=dtype, seed=1)
    w = (_randn(cuda, cout, cin, k, k, seed=2) * (cin * k * k) ** -0.5).to(dtype)
    b = _randn(cuda, cout, dtype=dtype, seed=3)
    p = _same_padding(side, k, stride) if pad == "SAME" else (0, 0)
    return x, w, b, (stride, stride), (p, p), bi_conv2d_plain


@pytest.mark.parametrize("dtype", BI_DTYPES, ids=str)
@pytest.mark.parametrize("shape", BI_LINEAR_SHAPES, ids=str)
def test_bi_linear_matches_its_plain_version(cuda, shape, dtype):
    from flaxdiff_tpu_torch.ops.batch_invariant import bi_linear_plain
    batch, rows, k, n = shape
    x = _randn(cuda, batch, rows, k, dtype=dtype, seed=1)
    w = (_randn(cuda, n, k, seed=2) * k ** -0.5).to(dtype)
    b = _randn(cuda, n, dtype=dtype, seed=3)
    reset_launch_counts()
    out = bi_linear(x, w, b)
    assert launch_counts()["bi_gemm"] == 1
    atol, rtol = BI_TOL[dtype]
    for bias, got in ((b, out), (None, bi_linear(x, w, None))):
        ref = bi_linear_plain(x.float(), w.float(), None if bias is None else bias.float())
        torch.testing.assert_close(got.float(), ref.to(dtype).float(),
                                   atol=atol * float(ref.abs().max()), rtol=rtol)


@pytest.mark.parametrize("dtype", BI_DTYPES, ids=str)
@pytest.mark.parametrize("shape", BI_CONV_SHAPES, ids=str)
def test_bi_conv2d_matches_its_plain_version(cuda, shape, dtype):
    x, w, b, stride, pads, plain = _bi_conv_operands(cuda, *shape, dtype)
    reset_launch_counts()
    out = bi_conv2d(x, w, b, stride, pads)
    assert launch_counts()["bi_conv"] == 1
    ref = plain(x.float(), w.float(), b.float(), stride, pads).to(dtype)
    assert out.shape == ref.shape
    atol, rtol = BI_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol * float(ref.abs().max()),
                               rtol=rtol)
    # the weight in channels-last memory, as ConvLayer passes it: no copy, same bits
    w_cl = w.contiguous(memory_format=torch.channels_last)
    assert torch.equal(bi_conv2d(x, w_cl, b, stride, pads), out)


@pytest.mark.parametrize("dtype", BI_DTYPES, ids=str)
def test_bi_kernels_give_each_sample_the_same_bits_in_any_batch(cuda, dtype):
    """A sample's bits at batch 2, 4 and 8 and at 16 in three other orders
    are its bits at 16: no tile shape follows the row count, no sum is split."""
    x = _randn(cuda, 16, 77, 256, dtype=dtype, seed=4)
    w = (_randn(cuda, 512, 256, seed=5) * 256 ** -0.5).to(dtype)
    cx, cw, cb, stride, pads, _ = _bi_conv_operands(cuda, 16, 12, 32, 48, 3, 1, "SAME", dtype)
    gen = torch.Generator(device="cpu").manual_seed(6)
    orders = [torch.arange(15, -1, -1), torch.cat([torch.arange(8, 16), torch.arange(8)]),
              torch.randperm(16, generator=gen)]
    for op, t in ((lambda a: bi_linear(a, w, None), x),
                  (lambda a: bi_conv2d(a, cw, cb, stride, pads), cx)):
        ref = op(t)
        for b in (2, 4, 8):
            assert torch.equal(op(t[:b]), ref[:b]), b
        for perm in orders:
            perm = perm.to(cuda)
            assert torch.equal(op(t[perm]), ref[perm])


# (Cin, Cout, kernel): one conv of each route the served UNet takes at 16
# bits (128 x 64 for 64 outputs, 128 x 128 for more and for a deep 3x3, on wgmma;
# conv_in's 3 channels on mma.sync) and conv_out's f32 narrow route
BI_ROUTE_CONVS = [(64, 64, 3), (512, 512, 3), (64, 128, 1), (3, 64, 3), (64, 3, 3)]


@pytest.mark.parametrize("dtype", BI_DTYPES, ids=str)
@pytest.mark.parametrize("conv", BI_ROUTE_CONVS, ids=str)
def test_bi_conv_routes_give_each_sample_the_same_bits_in_any_batch(cuda, conv, dtype):
    """Every route of bi_conv2d: a sample's bits at batch 1, 2, 4 and 8 and
    at 16 in three other orders are its bits at 16."""
    cin, cout, k = conv
    x, w, b, stride, pads, _ = _bi_conv_operands(cuda, 16, 12, cin, cout, k, 1, "SAME", dtype)
    gen = torch.Generator(device="cpu").manual_seed(7)
    op = lambda a: bi_conv2d(a, w, b, stride, pads)
    ref = op(x)
    for n in (1, 2, 4, 8):
        assert torch.equal(op(x[:n]), ref[:n]), n
    for perm in (torch.arange(15, -1, -1), torch.randperm(16, generator=gen)):
        perm = perm.to(cuda)
        assert torch.equal(op(x[perm]), ref[perm])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("n", [64, 512, 2048], ids=str)
def test_bi_linear_gives_77_token_rows_the_same_bits_at_batch_1_to_16(cuda, n, dtype):
    """77-token samples start at every offset of a 64-row wgmma tile as the
    batch grows: each sample's bits at batch 1-15 are its bits at 16 (64
    outputs fill half of a 128-column tile)."""
    x = _randn(cuda, 16, 77, 256, dtype=dtype, seed=8)
    w = (_randn(cuda, n, 256, seed=9) * 256 ** -0.5).to(dtype)
    b = _randn(cuda, n, dtype=dtype, seed=10)
    ref = bi_linear(x, w, b)
    for batch in range(1, 16):
        assert torch.equal(bi_linear(x[:batch], w, b), ref[:batch]), batch


def test_telemetry_fit_syncs_only_on_sampled_steps(cuda, monkeypatch, tmp_path):
    """fit under an enabled hub, sampled every 3rd step, under sync debug
    mode "error": the device closes (``_settle``) and the window's fetch are
    the only waits (each counted with the mode lifted around it), so of 6
    steps only 1 (the first), 3 and 6 close the device phase; the memory
    gauges, the program row and the phase rows add none. The gauges are the
    allocator's, never the host's."""
    import numpy as np
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.telemetry import MemoryMonitor, Telemetry, read_registry
    from flaxdiff_tpu_torch.trainer import DiffusionTrainer, TrainerConfig, adamw
    from flaxdiff_tpu_torch.trainer import trainer as trainer_module

    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8)
    tel = Telemetry.create(str(tmp_path / "tel"))
    trainer = DiffusionTrainer(Unet(**cfg, device=cuda), adamw(1e-3), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(),
                               TrainerConfig(log_every=6, pipeline_depth=0,
                                             telemetry_sample_every=3),
                               device=cuda, telemetry=tel)
    rng = np.random.default_rng(0)
    batches = [{"sample": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)}
               for _ in range(8)]
    trainer.fit(iter(batches[:1]), total_steps=1)     # builds the kernels, warms the allocator
    torch.cuda.synchronize()
    waits = []

    def lifted(fn, what):
        def call(*a):
            torch.cuda.set_sync_debug_mode("default")
            try:
                waits.append(what)
                return fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    monkeypatch.setattr(trainer_module, "_settle", lifted(trainer_module._settle, "settle"))
    monkeypatch.setattr(trainer_module, "_fetch_losses",
                        lifted(trainer_module._fetch_losses, "fetch"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = trainer.fit(iter(batches[1:]), total_steps=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tel.close()
    assert waits == ["settle", "settle", "settle", "fetch"] and hist["steps"] == [6]
    rows = [json.loads(line) for line in (tmp_path / "tel" / "telemetry.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows if r["type"] == "step_phases"][-3:] == [1, 3, 6]
    assert len(read_registry(str(tmp_path / "tel" / "programs.jsonl"))) == 1
    stats = MemoryMonitor(cuda).sample()
    assert stats["memory/bytes_in_use"] > 0 and not any("host" in k for k in stats)


# --- data, FSDP and sequence parallelism (flaxdiff_tpu_torch/parallel/) ----------------

def test_ring_hop_loop_matches_one_flash_call(cuda):
    """The ring's hop loop over 4 sequence shards in one process (the
    in-process transport) against one flash call over the whole sequence,
    bf16 [2, 512, 4, 64]: the output within flash's limits, the gradients
    within its backward limits times the hops (each hop's kernels round a
    partial gradient to bf16), one launch of each flash kernel per shard
    per hop."""
    from flaxdiff_tpu_torch.parallel import InProcessTransport, ring_backward, ring_forward
    q, k, v, do = (_randn(cuda, 2, 512, 4, 64, dtype=torch.bfloat16, seed=s) for s in range(4))
    out, lse = flash_fwd(q, k, v)
    delta = flash_delta(out, do)
    want = (out, flash_bwd_dq(q, k, v, do, lse, delta), *flash_bwd_dkv(q, k, v, do, lse, delta))
    split = lambda t: list(t.chunk(4, dim=1))
    reset_launch_counts()
    outs, lses = ring_forward(split(q), split(k), split(v), InProcessTransport(4))
    grads = ring_backward(split(q), split(k), split(v), outs, lses, split(do), InProcessTransport(4))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert [counts[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [16, 16, 16]
    got = (torch.cat(outs, 1), *(torch.cat(g, 1) for g in grads))
    torch.testing.assert_close(torch.cat(lses, 2), lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=4e-3, rtol=2 ** -7)
    for g, r in zip(got[1:], want[1:]):
        scale = float(r.float().abs().max())
        torch.testing.assert_close(g.float(), r.float(), atol=4 * 4e-3 * scale, rtol=2 ** -7)
        assert float((g.float() - r.float()).norm() / r.float().norm()) <= 4 * 1e-3


def test_cuda_tensor_on_a_gloo_group_raises(cuda):
    """No collective stages a CUDA tensor through the host: a gloo group
    refuses it, and an NCCL group refuses a CPU tensor."""
    import socket

    import torch.distributed as dist
    from flaxdiff_tpu_torch.parallel import collectives
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="gloo"):
            collectives.all_reduce_(torch.ones(4, device=cuda), None)
        with pytest.raises(RuntimeError, match="gloo"):
            collectives.all_gather_flat(torch.ones(4, device=cuda), None)
        nccl = dist.new_group([0], backend="nccl")
        with pytest.raises(RuntimeError, match="NCCL"):
            collectives.all_reduce_(torch.ones(4), nccl)
    finally:
        dist.destroy_process_group()


def test_two_rank_nccl_ring_and_fsdp_step(cuda, tmp_path):
    """Two cards: the ring over a {seq: 2} NCCL mesh against one flash call,
    and an {fsdp: 2} step of a small UNet against one rank's step on the
    global batch (tests/torch_gpu_world.py)."""
    import os

    import numpy as np
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from torch_world import spawn
    world = spawn(os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_gpu_world.py"),
                  2, str(tmp_path), backend="nccl")
    world.wait()
    for rank in range(2):
        assert np.load(tmp_path / f"ring_{rank}.npy").all(), rank
        assert np.load(tmp_path / f"fsdp_{rank}.npy").all(), rank


def test_phase_18_within_its_time(cuda):
    """chip_smoke.py's phase 18 (18a-c) passes its checks within 60 s."""
    import os
    import sys
    import time
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    chip_smoke.install_route_census()
    t0 = time.perf_counter()
    res = chip_smoke.parallel_paths(cuda)
    assert time.perf_counter() - t0 <= 60.0, {k: r["phase_s"] for k, r in res.items()}
