"""The port's video UNet (``flaxdiff_tpu_torch/models/unet3d.py``) against
the JAX package, on the CPU in f32: the temporal conv and attention layers,
the whole tiny UNet3D forward and gradients (with the ControlNet residual
hooks), ``remat``, and one train step's loss and gradients fed the JAX
step's own draws.

Every flax leaf is replaced with seeded numpy values (a fresh temporal
layer is the identity and a fresh UNet3D outputs 0, which would compare
nothing). At these sizes the JAX attention takes its XLA path (under 128
tokens), the port's the flash kernels' plain versions; the JAX GroupNorm +
SiLU Pallas kernels run interpreted in ``tests/test_torch_autoencoder.py``'s
KL VAE case.
"""
import functools
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models.unet3d import TemporalAttention as JaxTemporalAttention
from flaxdiff_tpu.models.unet3d import TemporalConvLayer as JaxTemporalConv
from flaxdiff_tpu.models.unet3d import UNet3D as JaxUNet3D
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
from flaxdiff_tpu.trainer.train_step import TrainStepConfig as JaxStepConfig
from flaxdiff_tpu.trainer.train_step import _make_loss_builder as jax_loss_builder
from test_torch_train import assert_close_to_max, jax_draw_arrays
from test_torch_unet_variants import MODULE_TOL, flax_leaves, forward_and_grads, load_port
from test_torch_unet import randomize, one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import convert
from flaxdiff_tpu_torch.inference import build_model
from flaxdiff_tpu_torch.models.unet3d import TemporalAttention, TemporalConvLayer, UNet3D
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder

# tests/test_models_unet3d.py's TINY, with a text context of 5 x 16
TINY = dict(output_channels=3, emb_features=32, feature_depths=(8, 16),
            attention_levels=(False, True), num_res_blocks=1, heads=2, norm_groups=4)
BATCH, FRAMES, RES, CTX_LEN, CTX_DIM = 2, 3, 8, 5, 16


class StepState(NamedTuple):
    """What the JAX loss builder reads of a train state (its key, step and
    params): a full TrainState would compile adamw's init leaf by leaf."""
    rng: jax.Array
    step: int
    params: dict


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class JaxFramed:
    """A JAX temporal layer with its frame count bound: flax's traced init
    would turn the int into an array."""

    def __init__(self, jm):
        self.jm = jm

    def init(self, key, x):
        return self.jm.init(key, x, FRAMES)

    def apply(self, variables, x):
        return self.jm.apply(variables, x, FRAMES)


def framed(cls):
    """The port's temporal layer with the same frame count bound."""
    class Framed(cls):
        def forward(self, x):
            return super().forward(x, FRAMES)
    return Framed


@pytest.mark.parametrize("layer", ["conv", "attention"])
def test_temporal_layers_match_flax(layer):
    """Forward and every gradient within 1e-4, over 2 clips of 3 frames:
    the GroupNorm reduces over the whole clip, the attention over frames."""
    x = _x((BATCH * FRAMES, 4, 4, 8), 1)
    if layer == "conv":
        jm, tm = JaxTemporalConv(features=12, norm_groups=4), \
            framed(TemporalConvLayer)(8, 12, norm_groups=4, device="cpu")
    else:
        jm, tm = JaxTemporalAttention(features=8, heads=2, norm_groups=4), \
            framed(TemporalAttention)(8, heads=2, norm_groups=4, device="cpu")
    jm = JaxFramed(jm)
    params = flax_leaves(jm, 2, x)
    load_port(tm, params)
    forward_and_grads(jm, tm, params, (x,), grads=True, jit=True)


def test_fresh_temporal_layers_are_the_identity():
    """The zero-initialised last conv and output projection (flax's
    ``initializers.zeros``) make a fresh layer return its input exactly."""
    x = torch.from_numpy(_x((BATCH * FRAMES, 4, 4, 8), 3))
    for layer in (TemporalConvLayer(8, 8, 4, device="cpu"),
                  TemporalAttention(8, 2, 4, device="cpu")):
        torch.testing.assert_close(layer(x, FRAMES), x, atol=0, rtol=0)


def _inputs(seed):
    return (_x((BATCH, FRAMES, RES, RES, 3), seed), np.array([17.0, 640.0], np.float32),
            _x((BATCH, CTX_LEN, CTX_DIM), seed + 1))


@functools.cache
def _param_shapes():
    """The tiny JAX UNet3D's parameter tree, traced once for every case."""
    return jax.eval_shape(JaxUNet3D(**TINY).init, jax.random.PRNGKey(0), *_inputs(0))["params"]


def _pair(seed):
    jm = JaxUNet3D(**TINY)
    params = randomize(_param_shapes(), seed)
    tm = UNet3D(**TINY, in_channels=3, context_dim=CTX_DIM, device="cpu")
    return jm, load_port(tm, params), params


@functools.cache
def hooked_pair():
    """The tiny UNet3D in both packages, and the JAX forward with the
    ControlNet residuals as inputs, jitted once for both cases below."""
    jm, tm, params = _pair(7)
    return tm, params, jax.jit(lambda p, x, t, c, down, mid: jm.apply(
        {"params": p}, x, t, c, down, mid))


@pytest.mark.parametrize("hooks", [False, True], ids=["plain", "hooks"])
def test_unet3d_forward_matches_jax(hooks):
    """The tiny UNet3D's output within 1e-4 of max(1, max|ref|) (its
    gradients: the train step's test below), plain and with ControlNet-style
    additions, one residual per skip and one to the middle block's output,
    which move it as in JAX (the plain case is the JAX forward with zero
    residuals); a wrong count raises."""
    tm, params, fwd = hooked_pair()
    x, t, ctx = _inputs(8)
    # the skips: conv_in, each level's blocks and downsamples
    shapes = [(BATCH * FRAMES, RES, RES, 8), (BATCH * FRAMES, RES, RES, 8),
              (BATCH * FRAMES, RES // 2, RES // 2, 8), (BATCH * FRAMES, RES // 2, RES // 2, 16)]
    down = [_x(s, 20 + i) for i, s in enumerate(shapes)]
    mid = _x((BATCH * FRAMES, RES // 2, RES // 2, 16), 30)
    if not hooks:
        down, mid = [np.zeros_like(d) for d in down], np.zeros_like(mid)
    ref = np.asarray(fwd(params, x, t, ctx, tuple(down), mid))
    args = [torch.from_numpy(a) for a in (x, t, ctx)]
    with torch.no_grad():
        out = tm(*args, [torch.from_numpy(d) for d in down], torch.from_numpy(mid)) if hooks \
            else tm(*args)
        if hooks:
            assert (out - tm(*args)).abs().max() > 0.05, "the hooks moved nothing"
    assert np.abs(ref).max() > 0.05, "a near-zero output compares nothing"
    np.testing.assert_allclose(out.numpy(), ref, rtol=MODULE_TOL,
                               atol=MODULE_TOL * max(1.0, float(np.abs(ref).max())))
    with pytest.raises(ValueError, match="additional residuals"):
        tm(*args[:2], None, [torch.from_numpy(down[0])])


def test_unet3d_remat_is_bit_equal_to_plain():
    """``remat=True`` recomputes each level block in the backward pass and
    changes no bit of the output or of any gradient."""
    x, t, ctx = (torch.from_numpy(a) for a in _inputs(9))
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        tm = UNet3D(**TINY, remat=remat, in_channels=3, context_dim=CTX_DIM, device="cpu")
        torch.nn.init.normal_(tm.conv_out.weight)
        out = tm(x, t, ctx)
        grads = torch.autograd.grad(out.square().sum(), list(tm.parameters()))
        outs.append((out.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_build_model_builds_unet3d_with_the_jax_keys():
    """The registry builds UNet3D from every key of the JAX dataclass."""
    tm = build_model("unet_3d", device="cpu", **TINY, backend="auto", dtype="float32",
                     precision=None, activation="swish", remat=False, in_channels=4,
                     context_dim=CTX_DIM)
    assert isinstance(tm, UNet3D) and tm.conv_in.weight.shape[1] == 4
    out = tm(torch.zeros(1, 2, RES, RES, 4), torch.zeros(1), torch.zeros(1, CTX_LEN, CTX_DIM))
    assert out.shape == (1, 2, RES, RES, 3)


def test_unet3d_train_step_loss_and_grads_match_jax():
    """One video train step (float clips, cosine / eps, CFG dropout against
    a null context): the loss within 1e-5 relative and every gradient within
    1e-4 of its max|g|, the port fed the JAX step's own draws."""
    jm, tm, params = _pair(11)
    apply_fn = lambda p, x, t, c: jm.apply({"params": p}, x, t, c)
    cfg = JaxStepConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True)
    null = np.zeros((1, CTX_LEN, CTX_DIM), np.float32)
    jstate = StepState(jax.random.PRNGKey(3), 0, params)
    x, _, ctx = _inputs(12)
    batch = {"sample": x, "cond": ctx}
    build = jax_loss_builder(apply_fn, JaxCosine(timesteps=1000), JaxEps(), cfg, None, None, null)
    # the draws in the same program as the step: one compile, not one per draw
    ref_loss, ref_grads, draws = jax.jit(lambda st, b: (
        *jax.value_and_grad(build(st, b))(st.params), jax_draw_arrays(st, x.shape)))(
        jstate, batch)

    port_build = make_loss_builder(CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
                                   TrainStepConfig(uncond_prob=0.12, normalize=False),
                                   null_cond=torch.from_numpy(null))
    draws = [torch.from_numpy(np.array(d)) for d in draws]
    loss = port_build({k: torch.from_numpy(v) for k, v in batch.items()}, *draws)(tm)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    ref = {k: v.numpy() for k, v in convert.state_dict_from_flax(tm, ref_grads).items()}
    gmax = max(np.abs(r).max() for r in ref.values())
    for name, g in grads.items():
        if np.abs(ref[name]).max() <= 1e-6 * gmax:
            # zero by the math (a key bias without RoPE): rounding on both sides
            assert np.abs(g.numpy()).max() <= 1e-6 * gmax, name
            continue
        assert_close_to_max(g.numpy(), ref[name], 1e-4, f"grad {name}")
