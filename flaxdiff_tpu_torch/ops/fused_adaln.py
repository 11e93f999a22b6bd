"""The DiT epilogues and GEGLU, forward and backward: the CUDA kernels
(``csrc/adaln.cu``, ``csrc/geglu.cu``), their plain PyTorch versions, and the
autograd Functions that join them.

Counterpart of ``flaxdiff_tpu/ops/fused_adaln.py``:

- ``ln_modulate_fwd`` replaces ``_ln_mod_kernel``: LayerNorm without affine
  (fast-variance form, clamped at 0, as flax's ``LayerNorm``), then
  ``xhat * (1 + s_i) + b_i`` for one or two views from one read of x. Views
  are f32 (the JAX ``result_type(f32, s)``); the per-row mean and rstd
  [B, L] f32 are saved for the backward.
- ``ln_modulate_bwd`` replaces ``_ln_mod_bwd_kernel``: dx in x's dtype, and
  per-(sample, row block) f32 partials of db_i = sum g_i and
  ds_i = sum g_i xhat, summed in a fixed order by ``ln_modulate_finalize``.
- ``gate_residual_fwd`` replaces ``_gate_res_kernel``: x + gate * h in the
  native dtype (bf16 stays bf16, the product rounded before the add).
- ``gate_residual_bwd`` replaces ``_gate_res_bwd_kernel``: dh = gate * dO in
  h's dtype and per-block f32 partials of sum_L dO h for dgate; dx is dO
  itself.
- ``geglu_fwd`` and ``geglu_bwd`` replace ``_geglu_kernel`` and
  ``_geglu_bwd_kernel``.

Modulators and gates are per-sample [B, 1, C] over [B, L, C] tokens (the
AdaLN-Zero layout); the kernels take them as strided views of the packed
AdaLN projection. The clip of AdaLN-Zero's MLP pair stays outside, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import _build

_SQRT_2_OVER_PI = 0.7978845608028654


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), written as fused_adaln.py:486-490."""
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / dx, written as fused_adaln.py:493-497."""
    t = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x)))
    return (0.5 * (1.0 + t)
            + 0.5 * x * (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * x * x))


def geglu_plain(proj: torch.Tensor) -> torch.Tensor:
    """val * gelu_tanh(gate), gate = first half, in f32, proj's dtype out."""
    gate, val = proj.float().chunk(2, dim=-1)
    return (val * gelu_tanh(gate)).to(proj.dtype)


def geglu_bwd_plain(proj: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """[dgate, dval] = [dO val gelu'(gate), dO gelu(gate)] in f32, one
    [..., 2F] cotangent in proj's dtype (fused_adaln.py:506-516)."""
    gate, val = proj.float().chunk(2, dim=-1)
    d = dout.float()
    return torch.cat([d * val * gelu_tanh_grad(gate), d * gelu_tanh(gate)],
                     dim=-1).to(proj.dtype)


def _check(proj: torch.Tensor) -> int:
    f2 = proj.shape[-1]
    if f2 % 2:
        raise ValueError(f"GEGLU needs an even last dim, got {f2}")
    return f2 // 2


def geglu_fwd(proj: torch.Tensor) -> torch.Tensor:
    """The forward kernel (B8). proj: [..., 2F], contiguous -> [..., F]."""
    f = _check(proj)
    if proj.device.type == "cpu":
        return geglu_plain(proj)
    _build.require_cuda(proj)
    if not proj.is_contiguous():
        raise ValueError("fused_geglu needs a contiguous projection")
    out = torch.empty(proj.shape[:-1] + (f,), dtype=proj.dtype, device=proj.device)
    err = _build.library().geglu_fwd(
        proj.data_ptr(), out.data_ptr(), proj.numel() // (2 * f), f,
        _build.dtype_code(proj), _build.stream_handle(proj.device))
    _build.check(err, "geglu_fwd")
    geglu_fwd.launches += 1
    return out


geglu_fwd.launches = 0


def geglu_bwd(proj: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The backward kernel (B9). proj: [..., 2F], dout: [..., F], both
    contiguous -> dproj [..., 2F] with the gate's half first."""
    f = _check(proj)
    if dout.shape != proj.shape[:-1] + (f,) or dout.dtype != proj.dtype:
        raise ValueError(f"dout: want {proj.dtype} {tuple(proj.shape[:-1]) + (f,)}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")
    if proj.device.type == "cpu":
        return geglu_bwd_plain(proj, dout)
    _build.require_cuda(proj, dout)
    if not (proj.is_contiguous() and dout.is_contiguous()):
        raise ValueError("geglu_bwd needs a contiguous projection and cotangent")
    dproj = torch.empty_like(proj)
    err = _build.library().geglu_bwd(
        proj.data_ptr(), dout.data_ptr(), dproj.data_ptr(), proj.numel() // (2 * f), f,
        _build.dtype_code(proj), _build.stream_handle(proj.device))
    _build.check(err, "geglu_bwd")
    geglu_bwd.launches += 1
    return dproj


geglu_bwd.launches = 0


class GEGLUFn(torch.autograd.Function):
    """geglu_fwd forward, geglu_bwd backward from the saved projection, as
    ``_geglu``'s custom VJP does (fused_adaln.py:549-584)."""

    @staticmethod
    def forward(ctx, proj):
        ctx.save_for_backward(proj)
        return geglu_fwd(proj)

    @staticmethod
    def backward(ctx, dout):
        (proj,) = ctx.saved_tensors
        return geglu_bwd(proj, dout.contiguous())


def fused_geglu(proj: torch.Tensor) -> torch.Tensor:
    """val * gelu_tanh(gate) where gate, val = proj.chunk(2, -1).
    proj: [..., 2F], contiguous -> [..., F]. Differentiable through
    ``GEGLUFn``."""
    _check(proj)
    return GEGLUFn.apply(proj)


# --- LayerNorm + modulate (B10, B11) -------------------------------------------

# rows of one backward block: the per-block partials are [B, ceil(L / 16), ., C]
ADALN_ROWS = 16

Pair = Tuple[torch.Tensor, torch.Tensor]


def ln_stats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (mean, rstd) [..., L] in f32, flax's fast-variance form:
    var = max(E[x^2] - E[x]^2, 0) (fused_adaln.py:130-134)."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = torch.clamp_min((xf * xf).mean(dim=-1) - mean * mean, 0.0)
    return mean, torch.rsqrt(var + eps)


def _xhat(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    return (x.float() - mean[..., None]) * rstd[..., None]


def ln_modulate_plain(x: torch.Tensor, pairs: Sequence[Pair], eps: float
                      ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """(views, mean, rstd): xhat (1 + s_i) + b_i in f32 for each (s_i, b_i),
    and the per-row statistics [B, L] f32, as ``_ln_mod_kernel``."""
    mean, rstd = ln_stats(x, eps)
    xhat = _xhat(x, mean, rstd)
    return tuple(xhat * (1.0 + s.float()) + b.float() for s, b in pairs), mean, rstd


def _row_blocks(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, L, ...] -> [B, ceil(L / rows), rows, ...], zero-padded."""
    b, l = t.shape[:2]
    nblk = -(-l // rows)
    pad = nblk * rows - l
    if pad:
        t = torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))], dim=1)
    return t.view((b, nblk, rows) + tuple(t.shape[2:]))


def ln_modulate_bwd_plain(x: torch.Tensor, scales: Sequence[torch.Tensor], mean: torch.Tensor,
                          rstd: torch.Tensor, gs: Sequence[torch.Tensor], rows: int = ADALN_ROWS
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, partials): dxhat = sum_i g_i (1 + s_i), dx = rstd (dxhat -
    mean(dxhat) - xhat mean(dxhat xhat)) in x's dtype; partials
    [B, nblk, 2 * views, C] f32, per block of `rows` rows, of (sum g_i,
    sum g_i xhat) for each view in turn (fused_adaln.py:161-188)."""
    xhat = _xhat(x, mean, rstd)
    dxhat = None
    sums = []
    for s, g in zip(scales, gs):
        g = g.float()
        term = g * (1.0 + s.float())
        dxhat = term if dxhat is None else dxhat + term
        sums += [g, g * xhat]
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd[..., None] * (dxhat - m1 - xhat * m2)).to(x.dtype)
    partials = torch.stack([_row_blocks(t, rows).sum(dim=2) for t in sums], dim=2)
    return dx, partials


def ln_modulate_finalize(partials: torch.Tensor, pairs: Sequence[Pair]
                         ) -> Tuple[Pair, ...]:
    """((ds_i, db_i), ...) [B, 1, C] in the modulators' dtypes: the block
    partials summed in a fixed order (fused_adaln.py:278-283)."""
    merged = partials.sum(dim=1)
    return tuple((merged[:, 2 * i + 1, None, :].to(s.dtype), merged[:, 2 * i, None, :].to(b.dtype))
                 for i, (s, b) in enumerate(pairs))


def _check_tokens(x: torch.Tensor, mods: Sequence[torch.Tensor], what: str) -> None:
    """[B, L, C] tokens and per-sample [B, 1, C] modulators of x's dtype."""
    if x.ndim != 3 or min(x.shape) < 1:
        raise ValueError(f"{what}: want non-empty [B, L, C] tokens, got {tuple(x.shape)}")
    b, _, c = x.shape
    for m in mods:
        if tuple(m.shape) != (b, 1, c):
            raise ValueError(f"{what}: want [B, 1, C] = {(b, 1, c)} modulators, got "
                             f"{tuple(m.shape)}")
        if m.dtype != x.dtype:
            raise TypeError(f"{what}: modulator dtype {m.dtype} != token dtype {x.dtype}")


def _mod_stride(x: torch.Tensor, mods: Sequence[torch.Tensor]) -> Tuple[list, int]:
    """The modulators as the kernels take them: unit stride along C and one
    batch stride shared by all (the [B, 1, 6C] AdaLN projection's chunks
    already are); any others are copied contiguous."""
    ok = all(m.stride(-1) == 1 for m in mods) and len({m.stride(0) for m in mods}) == 1
    if not ok:
        mods = [m.contiguous() for m in mods]
    _build.require_cuda(x, *mods)
    return mods, mods[0].stride(0)


def _contiguous(what: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous token tensors")


def ln_modulate_fwd(x: torch.Tensor, pairs: Sequence[Pair], eps: float = 1e-5
                    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """The forward kernel (B10). x: [B, L, C]; pairs: one or two (scale,
    shift) of [B, 1, C] -> (views [B, L, C] f32, mean [B, L], rstd [B, L])."""
    if len(pairs) not in (1, 2):
        raise ValueError(f"one or two (scale, shift) views, got {len(pairs)}")
    mods = [m for pair in pairs for m in pair]
    _check_tokens(x, mods, "ln_modulate")
    if x.device.type == "cpu":
        return ln_modulate_plain(x, pairs, eps)
    mods, stride = _mod_stride(x, mods)
    _contiguous("ln_modulate", x)
    b, l, c = x.shape
    views = [torch.empty(x.shape, dtype=torch.float32, device=x.device) for _ in pairs]
    mean = torch.empty(b, l, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    second = (mods[2], mods[3], views[1]) if len(pairs) == 2 else (mods[0], mods[1], views[0])
    err = _build.library().ln_mod_fwd(
        x.data_ptr(), mods[0].data_ptr(), mods[1].data_ptr(), second[0].data_ptr(),
        second[1].data_ptr(), views[0].data_ptr(), second[2].data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), b * l, l, c, stride, len(pairs), float(eps), _build.dtype_code(x),
        _build.stream_handle(x.device))
    _build.check(err, "ln_mod_fwd")
    ln_modulate_fwd.launches += 1
    return tuple(views), mean, rstd


ln_modulate_fwd.launches = 0


def ln_modulate_bwd(x: torch.Tensor, scales: Sequence[torch.Tensor], mean: torch.Tensor,
                    rstd: torch.Tensor, gs: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel (B11). x: [B, L, C]; scales: the views' [B, 1, C]
    scales; mean, rstd: [B, L] f32 from the forward; gs: the views'
    cotangents [B, L, C] f32 -> (dx [B, L, C] in x's dtype, partials
    [B, ceil(L / ADALN_ROWS), 2 * views, C] f32) for ``ln_modulate_finalize``."""
    if len(scales) not in (1, 2) or len(gs) != len(scales):
        raise ValueError("one or two views, a cotangent for each")
    _check_tokens(x, scales, "ln_modulate_bwd")
    b, l, c = x.shape
    for name, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != (b, l) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want f32 {(b, l)}, got {t.dtype} {tuple(t.shape)}")
    for g in gs:
        if g.shape != x.shape or g.dtype != torch.float32:
            raise ValueError(f"cotangent: want f32 {tuple(x.shape)}, got {g.dtype} "
                             f"{tuple(g.shape)}")
    if x.device.type == "cpu":
        return ln_modulate_bwd_plain(x, scales, mean, rstd, gs)
    scales, stride = _mod_stride(x, list(scales))
    _build.require_cuda(x, mean, rstd, *gs)
    _contiguous("ln_modulate_bwd", x, mean, rstd, *gs)
    dx = torch.empty_like(x)
    nblk = -(-l // ADALN_ROWS)
    partials = torch.empty(b, nblk, 2 * len(gs), c, dtype=torch.float32, device=x.device)
    s1, g1 = (scales[1], gs[1]) if len(gs) == 2 else (scales[0], gs[0])
    err = _build.library().ln_mod_bwd(
        x.data_ptr(), scales[0].data_ptr(), s1.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        gs[0].data_ptr(), g1.data_ptr(), dx.data_ptr(), partials.data_ptr(), b, l, c, stride,
        len(gs), ADALN_ROWS, _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "ln_mod_bwd")
    ln_modulate_bwd.launches += 1
    return dx, partials


ln_modulate_bwd.launches = 0


class LNModulateFn(torch.autograd.Function):
    """ln_modulate_fwd forward (one or two views); ln_modulate_bwd and the
    finalize backward, from the saved x, mean and rstd, as ``_ln_mod1`` and
    ``_ln_mod2``'s custom VJPs do (fused_adaln.py:287-332)."""

    @staticmethod
    def forward(ctx, x, eps, *mods):
        pairs = tuple(zip(mods[0::2], mods[1::2]))
        views, mean, rstd = ln_modulate_fwd(x, pairs, eps)
        ctx.save_for_backward(x, mean, rstd, *mods)
        return views if len(views) > 1 else views[0]

    @staticmethod
    def backward(ctx, *gs):
        x, mean, rstd, *mods = ctx.saved_tensors
        pairs = tuple(zip(mods[0::2], mods[1::2]))
        gs = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) if g is None
              else g.float().contiguous() for g in gs]
        dx, partials = ln_modulate_bwd(x, [s for s, _ in pairs], mean, rstd, gs)
        grads = [d for pair in ln_modulate_finalize(partials, pairs) for d in pair]
        return (dx, None, *grads)


def fused_ln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """``modulate(LayerNorm(x), scale, shift)`` in one pass, f32 out.
    x: [B, L, C]; scale, shift: [B, 1, C]. Differentiable through
    ``LNModulateFn``."""
    _check_tokens(x, (scale, shift), "fused_ln_modulate")
    return LNModulateFn.apply(x, eps, scale, shift)


def fused_ln_modulate2(x: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                       s2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both AdaLN-Zero views, ``modulate(norm_x, s1, b1)`` and
    ``modulate(norm_x, s2, b2)``, from one read of x. Clip the MLP pair
    before calling, as the JAX package does."""
    _check_tokens(x, (s1, b1, s2, b2), "fused_ln_modulate2")
    return LNModulateFn.apply(x, eps, s1, b1, s2, b2)


# --- gated residual (B12, B13) -----------------------------------------------------

def gate_residual_plain(x: torch.Tensor, gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x + gate * h in the native dtype: a bf16 product is rounded to bf16
    before the add (fused_adaln.py:380-383)."""
    return x + gate * h


def gate_residual_bwd_plain(gate: torch.Tensor, h: torch.Tensor, dout: torch.Tensor,
                            rows: int = ADALN_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh, partials): dh = gate * dO in h's dtype; partials [B, nblk, C]
    f32, per block of `rows` rows, of sum dO h (fused_adaln.py:386-391)."""
    dh = (gate * dout).to(h.dtype)
    return dh, _row_blocks(dout.float() * h.float(), rows).sum(dim=2)


def _check_gate(x: Optional[torch.Tensor], gate: torch.Tensor, h: torch.Tensor,
                what: str) -> None:
    _check_tokens(h, (gate,), what)
    if x is not None and (x.shape != h.shape or x.dtype != h.dtype):
        raise ValueError(f"{what}: x {x.dtype} {tuple(x.shape)} against h {h.dtype} "
                         f"{tuple(h.shape)}")


def gate_residual_fwd(x: torch.Tensor, gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The forward kernel (B12). x, h: [B, L, C]; gate: [B, 1, C]; one dtype."""
    _check_gate(x, gate, h, "gate_residual")
    if x.device.type == "cpu":
        return gate_residual_plain(x, gate, h)
    (gate,), stride = _mod_stride(x, [gate])
    _build.require_cuda(x, h)
    _contiguous("gate_residual", x, h)
    b, l, c = x.shape
    out = torch.empty_like(x)
    err = _build.library().gate_res_fwd(
        x.data_ptr(), gate.data_ptr(), h.data_ptr(), out.data_ptr(), b * l, l, c, stride,
        _build.dtype_code(x), _build.stream_handle(x.device))
    _build.check(err, "gate_res_fwd")
    gate_residual_fwd.launches += 1
    return out


gate_residual_fwd.launches = 0


def gate_residual_bwd(gate: torch.Tensor, h: torch.Tensor, dout: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel (B13). gate: [B, 1, C]; h, dout: [B, L, C] ->
    (dh in h's dtype, partials [B, ceil(L / ADALN_ROWS), C] f32 of sum dO h)."""
    _check_gate(dout, gate, h, "gate_residual_bwd")
    if h.device.type == "cpu":
        return gate_residual_bwd_plain(gate, h, dout)
    (gate,), stride = _mod_stride(h, [gate])
    _build.require_cuda(h, dout)
    _contiguous("gate_residual_bwd", h, dout)
    b, l, c = h.shape
    dh = torch.empty_like(h)
    partials = torch.empty(b, -(-l // ADALN_ROWS), c, dtype=torch.float32, device=h.device)
    err = _build.library().gate_res_bwd(
        gate.data_ptr(), h.data_ptr(), dout.data_ptr(), dh.data_ptr(), partials.data_ptr(),
        b, l, c, stride, ADALN_ROWS, _build.dtype_code(h), _build.stream_handle(h.device))
    _build.check(err, "gate_res_bwd")
    gate_residual_bwd.launches += 1
    return dh, partials


gate_residual_bwd.launches = 0


class GateResidualFn(torch.autograd.Function):
    """gate_residual_fwd forward; gate_residual_bwd backward, whose partials
    sum to dgate; dx is the cotangent itself (fused_adaln.py:418-467)."""

    @staticmethod
    def forward(ctx, x, gate, h):
        ctx.save_for_backward(gate, h)
        return gate_residual_fwd(x, gate, h)

    @staticmethod
    def backward(ctx, dout):
        gate, h = ctx.saved_tensors
        dout = dout.contiguous()
        dh, partials = gate_residual_bwd(gate, h, dout)
        return dout, partials.sum(dim=1, keepdim=True).to(gate.dtype), dh


def fused_gate_residual(x: torch.Tensor, gate: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + gate * h``, the AdaLN-Zero gated residual. x, h: [B, L, C];
    gate: [B, 1, C]. Differentiable through ``GateResidualFn``."""
    _check_gate(x, gate, h, "fused_gate_residual")
    return GateResidualFn.apply(x, gate, h)
