"""FAVOR+ linear attention (counterpart of
``flaxdiff_tpu/ops/linear_attention.py``; Performer, Choromanski et al. 2021).

Positive softmax-kernel random features over Gaussian-orthogonal
projections: non-causal attention is two O(N m d) products (the N x N score
matrix never exists), causal attention takes prefix sums along the sequence
(``torch.cumsum``, where JAX uses ``associative_scan``). Plain PyTorch: the
JAX package has no Pallas kernel here.

torch cannot reproduce JAX's threefry draws, so the projection is an
argument (``projection=``, a test hands in JAX's ``_cached_projection``) or
is drawn from a ``torch.Generator`` seeded with ``seed``, cached per
(head dim, features, seed) as the JAX package caches its own. Layout: [batch,
seq, heads, head_dim].
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _cached_projection(d: int, n_features: int, seed: int) -> torch.Tensor:
    gen = torch.Generator()
    gen.manual_seed(seed)
    return orthogonal_random_features(gen, n_features, d)


def orthogonal_random_features(generator: torch.Generator, n_features: int,
                               d: int) -> torch.Tensor:
    """[n_features, d] (f32, on the generator's device): Gaussian blocks
    made orthogonal per d rows by QR, each row rescaled to the norm of an
    iid Gaussian row (chi(d)): orthogonality lowers the estimator's
    variance at equal compute."""
    dev = generator.device
    blocks = []
    n_full = n_features // d
    for _ in range(n_full):
        q, _ = torch.linalg.qr(torch.randn(d, d, generator=generator, device=dev))
        blocks.append(q)
    rem = n_features - n_full * d
    if rem > 0:
        q, _ = torch.linalg.qr(torch.randn(d, d, generator=generator, device=dev))
        blocks.append(q[:rem])
    proj = torch.cat(blocks, dim=0)
    norms = torch.randn(n_features, d, generator=generator, device=dev).pow(2).sum(1).sqrt()
    return proj * norms[:, None]


def softmax_kernel_features(x: torch.Tensor, proj: torch.Tensor, is_query: bool,
                            eps: float = 1e-4) -> torch.Tensor:
    """Positive random features phi(x) with E[phi(q) . phi(k)] = exp(q . k).

    x: [B, L, H, D] (already scaled by d^-1/4); proj: [m, D]. Stabilised by
    the largest exponent: per query position, or over the whole sequence
    and features for keys (the normalisation cancels it)."""
    m = proj.shape[0]
    u = torch.einsum("blhd,md->blhm", x, proj)
    sq = 0.5 * (x * x).sum(dim=-1, keepdim=True)
    if is_query:
        stab = u.amax(dim=-1, keepdim=True)
    else:
        stab = u.amax(dim=(1, 3), keepdim=True)
    return (torch.exp(u - sq - stab) + eps) / np.sqrt(np.float32(m))


def default_features(d: int) -> int:
    """2 d log(d) features, at least 64 (log taken in f32, as JAX does)."""
    return max(64, int(2 * d * max(float(np.log(np.float32(d))), 1.0)))


def favor_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_features: Optional[int] = None, causal: bool = False,
                    scale: Optional[float] = None, seed: int = 0,
                    projection: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear-time attention over [B, L, H, D]: approximates
    softmax(scale q k^T) v (scale 1/sqrt(D) by default), its error falling
    with `n_features`. `projection` ([n_features, D]) overrides the cached
    seeded draw."""
    d = q.shape[-1]
    if projection is None:
        n = default_features(d) if n_features is None else int(n_features)
        projection = _cached_projection(d, n, seed)
    proj = torch.as_tensor(projection, dtype=torch.float32).to(q.device)

    # softmax(s q k) = E[phi(sqrt(s) q) phi(sqrt(s) k)]; s = 1/sqrt(d) is the
    # FAVOR+ d^-1/4 input scaling
    s = (d ** -0.5) if scale is None else float(scale)
    alpha = s ** 0.5
    qf = softmax_kernel_features(q.float() * alpha, proj, True)
    kf = softmax_kernel_features(k.float() * alpha, proj, False)
    vf = v.float()

    if not causal:
        kv = torch.einsum("blhm,blhd->bhmd", kf, vf)
        z = torch.einsum("blhm,bhm->blh", qf, kf.sum(dim=1))
        out = torch.einsum("blhm,bhmd->blhd", qf, kv) / (z[..., None] + 1e-6)
        return out.to(q.dtype)

    kv_prefix = torch.cumsum(torch.einsum("blhm,blhd->blhmd", kf, vf), dim=1)
    k_prefix = torch.cumsum(kf, dim=1)
    num = torch.einsum("blhm,blhmd->blhd", qf, kv_prefix)
    den = torch.einsum("blhm,blhm->blh", qf, k_prefix)
    return (num / (den[..., None] + 1e-6)).to(q.dtype)
