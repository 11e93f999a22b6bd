"""UViT, SimpleUDiT and the DiT block's options (another activation, the
unfused epilogues) against the JAX package, on the CPU in f32, with seeded
numpy leaves (helpers in ``test_torch_unet_variants.py``)."""
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models.dit import SimpleDiT as JaxDiT
from flaxdiff_tpu.models.uvit import SimpleUDiT as JaxUDiT
from flaxdiff_tpu.models.uvit import UViT as JaxUViT
from flaxdiff_tpu.typing import ACTIVATION_MAP as JAX_ACTIVATIONS
from test_torch_unet_variants import _x, flax_leaves, forward_and_grads, load_port
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch.models import SimpleDiT, SimpleMMDiT, SimpleUDiT, UViT

# 8x8x3 images (4x4 patches of 2) with a 5-token text context of width 12
TEXT = 12
INPUTS = lambda seed: (_x((2, 8, 8, 3), seed), np.array([17.0, 640.0], np.float32),
                       _x((2, 5, TEXT), seed + 1))
VIT = dict(output_channels=3, patch_size=2, emb_features=32, num_layers=2, num_heads=2)
UVIT_CASES = {"raster": {}, "hilbert": {"use_hilbert": True},
              "residual": {"add_residualblock_output": True, "use_projection": True}}


def _pair(jax_cls, port_cls, seed, jax_cfg, port_cfg):
    jm = jax_cls(**jax_cfg)
    args = INPUTS(seed)
    params = flax_leaves(jm, seed + 2, *args)
    tm = load_port(port_cls(**port_cfg, in_channels=3, context_dim=TEXT, device="cpu"), params)
    return jm, tm, params, args


@pytest.mark.parametrize("case", list(UVIT_CASES))
def test_uvit_matches_jax(case):
    """The [patches; time; text] sequence through the U of transformer
    blocks: raster (conv patch embed) with gradients, Hilbert (raw patches
    + Dense, unpermuted at the end), and the residual conv output stage (over
    [input; prediction], LayerNorm over channels, swish) with in/out
    projections in the blocks."""
    cfg = dict(VIT, max_image_size=16, **UVIT_CASES[case])
    jm, tm, params, args = _pair(JaxUViT, UViT, 50, cfg, cfg)
    forward_and_grads(jm, tm, params, args, grads=case == "raster", jit=True)


@pytest.mark.parametrize("scan", ["raster", "zigzag"])
def test_simple_udit_matches_jax(scan):
    """The U of DiT blocks with scan-order RoPE, the scan patch embed and
    the pooled time + text conditioning; gradients in raster order."""
    cfg = dict(VIT, use_zigzag=scan == "zigzag")
    jm, tm, params, args = _pair(JaxUDiT, SimpleUDiT, 60, cfg, cfg)
    forward_and_grads(jm, tm, params, args, grads=scan == "raster", jit=True)


@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_dit_unfused_epilogues_and_activation_match_jax(activation):
    """fused_epilogues=False runs JAX's unfused composition (parameter-free
    f32 LayerNorm, modulate, x + g h) and the MLP takes another activation:
    forward and gradients against the same JAX configuration."""
    cfg = dict(VIT, fused_epilogues=False)
    jm, tm, params, args = _pair(JaxDiT, SimpleDiT, 70,
                                 dict(cfg, activation=JAX_ACTIVATIONS[activation]),
                                 dict(cfg, activation=activation))
    assert not tm.block_0.fused
    forward_and_grads(jm, tm, params, args, grads=True, jit=True)


@pytest.mark.parametrize("cls", [SimpleDiT, SimpleUDiT, SimpleMMDiT])
def test_cache_mode_names_the_roadmap(cls):
    """The training-free caches are ROADMAP.md A8; every DiT-family model
    that takes ``cache_mode`` in JAX raises naming it."""
    model = cls(**VIT, in_channels=3, context_dim=TEXT, device="cpu")
    x, t, ctx = map(torch.from_numpy, INPUTS(80))
    with pytest.raises(NotImplementedError, match="A8"):
        model(x, t, ctx, cache_mode="record", cache_split=1)
