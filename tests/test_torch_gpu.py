"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and skip without one. The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""
import pytest
import torch

from flaxdiff_tpu_torch.ops import (KERNEL_WRAPPERS, dot_product_attention, flash_attention,
                                    flash_bwd_dkv, flash_bwd_dq, flash_fwd, fused_gate_residual,
                                    fused_geglu,
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
                                               groupnorm_stats_plain, rows_per_block)

pytestmark = pytest.mark.gpu

# (atol, rtol) per element. bf16/f16: rtol is one output ulp relative to the
# value (2^-7, 2^-10), atol covers p rounded to the input dtype against a
# running (kernel) or final (plain) row max
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2.0 ** -7),
       torch.float16: (5e-4, 2.0 ** -10)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,mean", GN_STATS_CASES)
def test_groupnorm_stats_kernel_matches_plain(cuda, dtype, shape, groups, mean):
    """The statistics kernel's partials against its plain version over the
    same blocks: f32 sums in another order, the kernel's shifted by each
    block's first row. chip_smoke.py's limits: per element atol 1e-3,
    rtol 1e-5, and 1e-5 on the relative RMS."""
    x = _randn(cuda, *shape, dtype=dtype) * 2.0 + mean
    part = groupnorm_stats(x, groups)
    ref = groupnorm_stats_plain(x, groups, rows_per_block(*shape))
    torch.testing.assert_close(part, ref, atol=1e-3, rtol=1e-5)
    assert float((part - ref).norm() / ref.norm()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 65536, 64), 8), ((2, 50, 36), 4)])
def test_groupnorm_stats_is_deterministic(cuda, dtype, shape, groups):
    """No atomics, a fixed reduction order: two launches give bit-equal
    partials (16-byte and scalar paths)."""
    x = _randn(cuda, *shape, dtype=dtype) * 3.0 + 1.0
    assert torch.equal(groupnorm_stats(x, groups), groupnorm_stats(x, groups))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
    loss.backward()
    torch.cuda.synchronize()
    assert launch_counts() == {name: 1 for name in KERNEL_WRAPPERS}


def test_kernels_raise_on_what_they_cannot_take(cuda):
    q = _randn(cuda, 1, 16, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
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


@pytest.mark.parametrize("d", [40, 72, 80, 96, 160, 192])
def test_attention_dispatch_pads_odd_head_dims(cuda, d):
    """The dispatch zero-pads a head dim outside (32, 64, 128, 256) to the
    next of them: forward and dq, dk, dv in bf16 against the plain versions
    at the true head dim, within the flash bf16 limits."""
    q = _randn(cuda, 2, 130, 4, d, dtype=torch.bfloat16, seed=1).requires_grad_()
    k = _randn(cuda, 2, 77, 4, d, dtype=torch.bfloat16, seed=2).requires_grad_()
    v = _randn(cuda, 2, 77, 4, d, dtype=torch.bfloat16, seed=3).requires_grad_()
    do = _randn(cuda, 2, 130, 4, d, dtype=torch.bfloat16, seed=4)
    reset_launch_counts()
    out = dot_product_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd_dq"], counts["flash_bwd_dkv"]) == (1, 1, 1)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_bwd_kernel_matches_plain(cuda, dtype):
    for shape in [(2, 50, 256), (3, 7, 2 * 13)]:   # 16-byte and scalar paths
        p = _randn(cuda, *shape, dtype=dtype) * 2.0
        d = _randn(cuda, *shape[:-1], shape[-1] // 2, dtype=dtype, seed=7)
        torch.testing.assert_close(geglu_bwd(p, d).float(), geglu_bwd_plain(p, d).float(),
                                   atol=1e-5, rtol=TOL[dtype][1])


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


# --- the AdaLN kernels (B10-B13) ---------------------------------------------------

def _adaln_inputs(cuda, shape, dtype, nviews):
    b, _, c = shape
    x = _randn(cuda, *shape, dtype=dtype, seed=1) * 2.0 + 3.0
    mods = [(_randn(cuda, b, 1, c, dtype=dtype, seed=2 + i) * 0.5) for i in range(2 * nviews)]
    gs = [_randn(cuda, *shape, seed=10 + i) for i in range(nviews)]
    return x, mods, gs


# (shape): DiT-B at its training rows, a ragged L = 77, and a C that takes
# the scalar path (not a multiple of the 16-byte vector)
ADALN_SHAPES = [(4, 256, 768), (3, 77, 768), (2, 19, 36)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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
