"""The port's AdaLN kernel module (LayerNorm + modulate, gated residual)
against the JAX package's Pallas kernels, on the CPU.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the real Pallas kernels through the interpreter (``force_pallas``,
``interpret``), the backward through ``jax.vjp`` of the custom VJPs.
Inputs are made with numpy from a seed and handed to both sides. The CUDA
kernels are held against the plain versions in tests/test_torch_gpu.py and
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.ops import fused_adaln as fa

from flaxdiff_tpu_torch.ops import (KERNEL_WRAPPERS, GateResidualFn, LNModulateFn,
                                    fused_gate_residual, fused_ln_modulate, fused_ln_modulate2,
                                    gate_residual_bwd, gate_residual_fwd, launch_counts,
                                    ln_modulate_bwd, ln_modulate_fwd, reset_launch_counts)
from flaxdiff_tpu_torch.ops.fused_adaln import (ADALN_ROWS, gate_residual_bwd_plain,
                                                ln_modulate_bwd_plain, ln_modulate_finalize)

# f32 on both sides: summation order and the libraries' rsqrt, a few ulps
TOL = 1e-5
EPS = 1e-5
C = 64


def assert_close_to_max(out, ref, what, tol=TOL):
    """Every element within tol * max|ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, f"{what}: shape {out.shape} against {ref.shape}"
    bound = tol * np.abs(ref).max()
    err = np.abs(out - ref).max()
    assert err <= bound, f"{what}: max error {err:.3g} above {bound:.3g}"


def _inputs(seed, b, l, nviews):
    rng = np.random.default_rng(seed)
    # mean 3, std 2 per row: the fast variance must hold its cancellation
    x = (3.0 + 2.0 * rng.standard_normal((b, l, C))).astype(np.float32)
    mods = [(0.5 * rng.standard_normal((b, 1, C))).astype(np.float32) for _ in range(2 * nviews)]
    gs = [rng.standard_normal((b, l, C)).astype(np.float32) for _ in range(nviews)]
    return x, mods, gs


# 16 rows in one 64-row Pallas block; 27 rows over four 8-row blocks with a
# padded tail, and two port backward blocks of 16 with a ragged second
CASES = [(16, None), (27, 8 * C * 4)]


@pytest.mark.parametrize("nviews", [1, 2])
@pytest.mark.parametrize("l,block_bytes", CASES, ids=["one-block", "ragged-multiblock"])
def test_ln_modulate_plain_matches_pallas_kernel(monkeypatch, nviews, l, block_bytes):
    if block_bytes is not None:
        monkeypatch.setattr(fa, "_BLOCK_BYTES", block_bytes)
    x, mods, _ = _inputs(l + nviews, 2, l, nviews)
    pairs = tuple(zip(mods[0::2], mods[1::2]))
    views_j, mean_j, rstd_j = fa._ln_mod_impl(x, pairs, EPS, True, True, True)
    tpairs = tuple((torch.from_numpy(s), torch.from_numpy(b)) for s, b in pairs)
    views, mean, rstd = ln_modulate_fwd(torch.from_numpy(x), tpairs, EPS)
    assert len(views) == nviews
    for i, (out, ref) in enumerate(zip(views, views_j)):
        assert_close_to_max(out.numpy(), np.asarray(ref), f"view {i}")
    assert_close_to_max(mean.numpy(), np.asarray(mean_j)[:, :l, 0], "mean")
    assert_close_to_max(rstd.numpy(), np.asarray(rstd_j)[:, :l, 0], "rstd")


@pytest.mark.parametrize("nviews", [1, 2])
@pytest.mark.parametrize("l,block_bytes", CASES, ids=["one-block", "ragged-multiblock"])
def test_ln_modulate_backward_matches_pallas_kernel(monkeypatch, nviews, l, block_bytes):
    if block_bytes is not None:
        monkeypatch.setattr(fa, "_BLOCK_BYTES", block_bytes)
    x, mods, gs = _inputs(100 + l + nviews, 2, l, nviews)
    jax_fn = fa.fused_ln_modulate if nviews == 1 else fa.fused_ln_modulate2
    _, vjp = jax.vjp(lambda *a: jax_fn(*a, EPS, interpret=True, force_pallas=True),
                     *map(jnp.asarray, [x, *mods]))
    refs = vjp(gs[0] if nviews == 1 else tuple(gs))
    port_fn = fused_ln_modulate if nviews == 1 else fused_ln_modulate2
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x, *mods]]
    out = port_fn(*leaves, eps=EPS)
    outs = torch.autograd.grad(out, leaves, [torch.from_numpy(g) for g in gs])
    names = ["dx"] + [f"d{k}{i}" for i in range(nviews) for k in ("s", "b")]
    for name, got, ref in zip(names, outs, refs):
        assert_close_to_max(got.numpy(), np.asarray(ref), name)


def test_ln_modulate_bwd_partials_cover_every_row_once():
    """The plain backward's partials are per block of ADALN_ROWS rows, a
    zero-padded ragged last block included, and sum to the full sums."""
    x, mods, gs = _inputs(7, 2, 37, 2)
    t = lambda a: torch.from_numpy(a)
    xt = t(x)
    _, mean, rstd = ln_modulate_fwd(xt, ((t(mods[0]), t(mods[1])), (t(mods[2]), t(mods[3]))), EPS)
    _, partials = ln_modulate_bwd_plain(xt, [t(mods[0]), t(mods[2])], mean, rstd,
                                        [t(g) for g in gs])
    assert partials.shape == (2, -(-37 // ADALN_ROWS), 4, C)
    xhat = (xt - mean[..., None]) * rstd[..., None]
    want = torch.stack([t(gs[0]).sum(1), (t(gs[0]) * xhat).sum(1),
                        t(gs[1]).sum(1), (t(gs[1]) * xhat).sum(1)], dim=1)
    assert_close_to_max(partials.sum(1).numpy(), want.numpy(), "summed partials")
    (ds0, db0), (ds1, db1) = ln_modulate_finalize(
        partials, [(t(mods[0]), t(mods[1])), (t(mods[2]), t(mods[3]))])
    for got, ref in ((db0, want[:, 0]), (ds0, want[:, 1]), (db1, want[:, 2]), (ds1, want[:, 3])):
        assert got.shape == (2, 1, C)
        assert_close_to_max(got[:, 0].numpy(), ref.numpy(), "finalized")


@pytest.mark.parametrize("l,block_bytes", CASES, ids=["one-block", "ragged-multiblock"])
def test_gate_residual_matches_pallas_kernels(monkeypatch, l, block_bytes):
    if block_bytes is not None:
        monkeypatch.setattr(fa, "_BLOCK_BYTES", block_bytes)
    rng = np.random.default_rng(l)
    x, h, g = (rng.standard_normal((2, l, C)).astype(np.float32) for _ in range(3))
    gate = (0.5 * rng.standard_normal((2, 1, C))).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: fa.fused_gate_residual(*a, interpret=True, force_pallas=True),
                       *map(jnp.asarray, (x, gate, h)))
    refs = vjp(g)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gate, h)]
    out = fused_gate_residual(*leaves)
    assert_close_to_max(out.detach().numpy(), np.asarray(ref), "out")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, got, want in zip(("dx", "dgate", "dh"), grads, refs):
        assert_close_to_max(got.numpy(), np.asarray(want), name)
    dh, partials = gate_residual_bwd_plain(leaves[1].detach(), leaves[2].detach(),
                                           torch.from_numpy(g))
    assert partials.shape == (2, -(-l // ADALN_ROWS), C)


def test_dtype_rules_match_jax():
    """bf16 tokens and modulators give f32 views (the JAX result_type); the
    gated residual stays bf16 and equals the Pallas kernel's native-dtype
    ``x + g * h`` bit for bit, the product rounded before the add."""
    rng = np.random.default_rng(3)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    x = bf(3.0 + 2.0 * rng.standard_normal((2, 24, C)))
    s, b, gate = (bf(0.5 * rng.standard_normal((2, 1, C))) for _ in range(3))
    h = bf(rng.standard_normal((2, 24, C)))
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    v1, v2 = fused_ln_modulate2(tb(x), tb(s), tb(b), tb(b), tb(s), EPS)
    r1, r2 = fa.fused_ln_modulate2(x, s, b, b, s, EPS, interpret=True, force_pallas=True)
    assert v1.dtype == v2.dtype == torch.float32 and r1.dtype == jnp.float32
    assert_close_to_max(v1.numpy(), np.asarray(r1), "bf16 view 1")
    assert_close_to_max(v2.numpy(), np.asarray(r2), "bf16 view 2")
    out = fused_gate_residual(tb(x), tb(gate), tb(h))
    ref = fa.fused_gate_residual(x, gate, h, interpret=True, force_pallas=True)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_adaln_ops_record_their_function():
    """Each differentiable op records the port's Function, so its gradient
    takes the backward kernels on the card, never autograd of the plain
    forward."""
    x, mods, _ = _inputs(5, 1, 8, 2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x, *mods]]
    one = fused_ln_modulate(*leaves[:3])
    a, b = fused_ln_modulate2(*leaves)
    res = fused_gate_residual(leaves[0], leaves[1], leaves[0] * 2)
    for out, fn in ((one, LNModulateFn), (a, LNModulateFn), (b, LNModulateFn),
                    (res, GateResidualFn)):
        assert isinstance(out.grad_fn, fn._backward_cls), out.grad_fn
    grads = torch.autograd.grad((one.sum() + a.sum() + b.sum() + res.sum()), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


def test_plain_paths_count_no_launches():
    reset_launch_counts()
    x, mods, _ = _inputs(6, 1, 8, 1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in [x, *mods]]
    fused_gate_residual(leaves[0], leaves[1], fused_ln_modulate(*leaves)).sum().backward()
    assert launch_counts() == {name: 0 for name in KERNEL_WRAPPERS}


def test_adaln_wrappers_never_take_the_plain_path_off_the_cpu():
    """A tensor not on the CPU (a meta tensor here: no card) goes to the
    kernel or raises, forward and backward alike."""
    meta = lambda *s: torch.empty(*s, device="meta")
    x, m, rows = meta(2, 8, C), meta(2, 1, C), meta(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ln_modulate_fwd(x, ((m, m),))
    with pytest.raises(ValueError, match="CUDA"):
        fused_ln_modulate2(x, m, m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        ln_modulate_bwd(x, [m, m], rows, rows, [x, x])
    with pytest.raises(ValueError, match="CUDA"):
        gate_residual_fwd(x, m, x)
    with pytest.raises(ValueError, match="CUDA"):
        gate_residual_bwd(m, x, x)


@pytest.mark.parametrize("bad,match", [
    (lambda x, m: fused_ln_modulate(x, m[:, :, :8], m), r"\[B, 1, C\]"),
    (lambda x, m: fused_ln_modulate(x[0], m, m), r"\[B, L, C\]"),
    (lambda x, m: fused_ln_modulate(x, m.double(), m.double()), "dtype"),
    (lambda x, m: fused_gate_residual(x, m, x[:, :4]), "against"),
    (lambda x, m: ln_modulate_fwd(x, ()), "one or two"),
])
def test_adaln_wrappers_reject_what_the_kernels_cannot_take(bad, match):
    with pytest.raises((ValueError, TypeError), match=match):
        bad(torch.randn(2, 8, C), torch.randn(2, 1, C))
