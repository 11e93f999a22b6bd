"""SimpleMMDiT, HierarchicalMMDiT and their layers (the two-projection
AdaLN-Zero, patch merging and expanding) against the JAX package, on the CPU
in f32, with seeded numpy leaves (helpers in
``test_torch_unet_variants.py``)."""
import jax
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models import mmdit as jmmdit
from test_torch_unet import randomize, one_torch_thread  # noqa: F401 (autouse)
from test_torch_unet_variants import _x, flax_leaves, forward_and_grads, load_port
from test_torch_uvit import INPUTS, TEXT, VIT

from flaxdiff_tpu_torch.models import (HierarchicalMMDiT, PatchExpanding, PatchMerging,
                                       SimpleMMDiT)


def _scaled_ada(params):
    """The AdaLN projections scaled 8x, so the MLP pair crosses the +-10
    clip (|s| reaches 13-16 in these models). Forward cases only: a
    modulation near 10 amplifies f32 rounding about tenfold, and the
    gradients of such a model differ by ~1.2e-4 of their max whether the
    port runs its kernels' plain versions or JAX's unfused composition; the
    gradient cases run at the drawn scale (the clip's gradient is held in
    test_torch_dit.py's AdaLNZero test)."""
    def scale(path, a):
        names = [getattr(p, "key", "") for p in path]
        return a * 8.0 if any(n.startswith("ada_") for n in names) else a
    return jax.tree_util.tree_map_with_path(scale, params)


MM_CASES = {"raster": {}, "hilbert-learn_sigma": {"use_hilbert": True, "learn_sigma": True},
            "unfused-relu": {"fused_epilogues": False}}


@pytest.mark.parametrize("case", list(MM_CASES))
def test_simple_mmdit_matches_jax(case):
    """Raster with gradients; Hilbert order (RoPE along the curve) with the
    log-variance half dropped; the unfused epilogues with another MLP
    activation. The forward cases scale the AdaLN projections so the clip
    engages."""
    cfg = dict(VIT, **MM_CASES[case])
    port_cfg = dict(cfg)
    if case == "unfused-relu":
        cfg["activation"], port_cfg["activation"] = jax.nn.relu, "relu"
    jm = jmmdit.SimpleMMDiT(**cfg)
    args = INPUTS(90)
    grads = case == "raster"
    params = flax_leaves(jm, 91, *args, transform=None if grads else _scaled_ada)
    tm = load_port(SimpleMMDiT(**port_cfg, in_channels=3, context_dim=TEXT, device="cpu"), params)
    forward_and_grads(jm, tm, params, args, grads=grads, jit=True)


HIER = dict(output_channels=3, base_patch_size=2, emb_features=(16, 32), num_layers=(1, 2),
            num_heads=(2, 2))


@pytest.mark.parametrize("hilbert", [False, True], ids=["raster", "hilbert"])
def test_hierarchical_mmdit_matches_jax(hilbert):
    """Two stages: 4x4 tokens of 16 merged to 2x2 of 32 and expanded back,
    the skip fused by LayerNorm + Dense; per-stage conditioning from the
    coarsest-width base and per-stage RoPE; gradients in raster order. Its
    Hilbert mode only swaps the embedding (forward, the clip engaged)."""
    cfg = dict(HIER, use_hilbert=hilbert)
    jm = jmmdit.HierarchicalMMDiT(**cfg)
    args = INPUTS(100)
    params = flax_leaves(jm, 101, *args, transform=_scaled_ada if hilbert else None)
    tm = load_port(HierarchicalMMDiT(**cfg, in_channels=3, context_dim=TEXT, device="cpu"),
                   params)
    forward_and_grads(jm, tm, params, args, grads=not hilbert, jit=True)


def test_patch_merging_and_expanding_match_jax():
    """The exact reshape and transpose order of both, on a 4x6 grid (a square
    grid would hide a swapped axis)."""
    x = _x((2, 24, 8), 110)
    jm = jmmdit.PatchMerging(out_features=12)
    params = randomize(jm.init(jax.random.PRNGKey(0), x, 4, 6)["params"], 111)
    tm = load_port(PatchMerging(8, 12, device="cpu"), params)
    ref, hp, wp = jm.apply({"params": params}, x, 4, 6)
    out, thp, twp = tm(torch.from_numpy(x), 4, 6)
    assert (hp, wp) == (thp, twp) == (2, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    y = _x((2, 6, 12), 112)
    jm = jmmdit.PatchExpanding(out_features=8)
    params = randomize(jm.init(jax.random.PRNGKey(0), y, 2, 3)["params"], 113)
    tm = load_port(PatchExpanding(12, 8, device="cpu"), params)
    ref, hp, wp = jm.apply({"params": params}, y, 2, 3)
    out, thp, twp = tm(torch.from_numpy(y), 2, 3)
    assert (hp, wp) == (thp, twp) == (4, 6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
