"""The port's UNet modules, the whole tiny UNet and DDIM + CFG and Heun +
CFG (Karras) trajectories against the JAX package, on the CPU in f32.

Every parameter of the flax side is replaced with seeded numpy values and
converted with flaxdiff_tpu_torch.convert: a freshly initialised UNet has
zero-initialised output convolutions and would compare nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models import attention as jattn
from flaxdiff_tpu.models import common as jcommon
from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.predictors import KarrasPredictionTransform as JaxKarras
from flaxdiff_tpu.samplers import DDIMSampler as JaxDDIM
from flaxdiff_tpu.samplers import HeunSampler as JaxHeun
from flaxdiff_tpu.samplers import DiffusionSampler as JaxSampler
from flaxdiff_tpu.samplers.common import get_timestep_spacing as jax_spacing
from flaxdiff_tpu.schedulers import CosineNoiseSchedule as JaxCosine
from flaxdiff_tpu.schedulers import KarrasVENoiseSchedule as JaxKarrasVE

from flaxdiff_tpu import predictors as jpredictors
from flaxdiff_tpu import schedulers as jschedulers
from flaxdiff_tpu_torch import convert, predictors, schedulers
from flaxdiff_tpu_torch.models import attention as tattn
from flaxdiff_tpu_torch.models import common as tcommon
from flaxdiff_tpu_torch.models.unet import Unet
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform, KarrasPredictionTransform
from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler, HeunSampler
from flaxdiff_tpu_torch.samplers.common import get_timestep_spacing
from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, KarrasVENoiseSchedule

# module outputs in f32: both sides sum convolutions and matmuls in their
# own order; a few layers deep that stays below 1e-4 at unit scale
MODULE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU tests (every test module of
    the port takes this fixture): their shapes are tiny, and under a
    parallel test run torch's thread pool would only contend with the other
    workers (a tiny UNet3D step took 4 s on 8 threads against 0.1 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize(params, seed):
    """Seeded numpy values for every flax leaf: kernels N(0, 1/fan_in),
    norm scales around 1, biases small."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        shape = p.shape
        if name == "kernel":
            fan_in = shape[0] if (p.ndim == 3 and parent != "to_out") else np.prod(shape[:-1])
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def flax_to_torch(jmod, tmod, seed, *args):
    params = randomize(jmod.init(jax.random.PRNGKey(0), *args)["params"], seed)
    tmod.load_state_dict(convert.state_dict_from_flax(tmod, params), strict=True)
    return params


def run_both(jmod, tmod, seed, *arrays):
    params = flax_to_torch(jmod, tmod, seed, *arrays)
    ref = np.asarray(jmod.apply({"params": params}, *arrays))
    with torch.no_grad():
        out = tmod(*(None if a is None else torch.from_numpy(np.array(a)) for a in arrays))
    return out.numpy(), ref


def test_residual_block_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    jm = jcommon.ResidualBlock(features=32, norm_groups=4)
    tm = tcommon.ResidualBlock(16, 32, 32, norm_groups=4, device="cpu")
    out, ref = run_both(jm, tm, 1, x, temb)
    np.testing.assert_allclose(out, ref, atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("size", [8, 6])
def test_downsample_pads_like_xla_same(size):
    """Stride 2 "SAME" pads (0, 1) on even sizes: torch's padding=1 would
    shift every output pixel."""
    x = np.random.default_rng(size).standard_normal((1, size, size, 4)).astype(np.float32)
    jm = jcommon.Downsample(features=8)
    tm = tcommon.Downsample(4, 8, device="cpu")
    out, ref = run_both(jm, tm, 2, x)
    assert out.shape == ref.shape == (1, size // 2, size // 2, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_fourier_embedding_and_time_projection_match_flax():
    t = np.array([0.0, 3.5, 979.02, 999.0], np.float32)
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (16,)) * 16.0)
    ref_emb = np.asarray(jcommon.FourierEmbedding(features=32).apply({}, t))
    emb = tcommon.FourierEmbedding(32, device="cpu")
    emb.freqs.copy_(torch.from_numpy(freqs.copy()))
    out_emb = emb(torch.from_numpy(t)).numpy()
    # the f32 arguments (up to ~1e5 rad) are computed in the same order, so
    # only the libraries' sin/cos differ, by an ulp or so
    np.testing.assert_allclose(out_emb, ref_emb, atol=1e-5)
    jm = jcommon.TimeProjection(features=32)
    tm = tcommon.TimeProjection(32, 32, device="cpu")
    out, ref = run_both(jm, tm, 3, ref_emb)
    np.testing.assert_allclose(out, ref, atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_layer_matches_flax(cross):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 12)).astype(np.float32) if cross else None
    jm = jattn.AttentionLayer(heads=2, dim_head=8, backend="auto")
    tm = tattn.AttentionLayer(16, 12 if cross else None, heads=2, dim_head=8, device="cpu")
    out, ref = run_both(jm, tm, 5, x, ctx)
    np.testing.assert_allclose(out, ref, atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("self_and_cross,depth,projection", [
    (True, 1, False), (False, 1, False), (True, 2, True)])
def test_transformer_block_matches_flax(self_and_cross, depth, projection):
    """Self + cross attention; the middle block's cross-only form, whose
    attn1 attends to the context and which has no attn2; and two blocks
    inside an in/out projection."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 12)).astype(np.float32)
    jm = jattn.TransformerBlock(heads=2, dim_head=8, depth=depth, use_projection=projection,
                                use_self_and_cross=self_and_cross)
    tm = tattn.TransformerBlock(16, 12, heads=2, dim_head=8, depth=depth,
                                use_projection=projection,
                                use_self_and_cross=self_and_cross, device="cpu")
    assert (tm.block_0.attn2 is None) == (not self_and_cross)
    out, ref = run_both(jm, tm, 7, x, ctx)
    np.testing.assert_allclose(out, ref, atol=MODULE_TOL, rtol=MODULE_TOL)


# --- the slice: tiny UNet, forward and trajectory ---------------------------

ATTN = {"heads": 2, "dim_head": 8, "backend": "auto"}
START = 333.0
TINY = dict(output_channels=3, emb_features=32, feature_depths=(16, 32),
            attention_configs=(None, ATTN), num_res_blocks=2, norm_groups=4)


@pytest.fixture(scope="module")
def tiny_pair():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([17.0, 640.0], np.float32)
    ctx = rng.standard_normal((2, 7, 12)).astype(np.float32)
    jm = JaxUnet(**TINY)
    params = randomize(jm.init(jax.random.PRNGKey(0), x, t, ctx)["params"], 11)
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (16,)) * 16.0)
    tm = Unet(**TINY, in_channels=3, context_dim=12, device="cpu").eval()
    tm.load_flax_params(params, freqs)
    return jm, params, tm, (x, t, ctx)


def test_tiny_unet_forward_matches_flax(tiny_pair):
    jm, params, tm, (x, t, ctx) = tiny_pair
    ref = np.asarray(jm.apply({"params": params}, x, t, ctx))
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (x, t, ctx))).numpy()
    assert np.abs(ref).max() > 0.1   # random weights: the output is not the zero-init 0
    np.testing.assert_allclose(out, ref, atol=MODULE_TOL, rtol=MODULE_TOL)


@pytest.mark.parametrize("clip_denoised", [False, True])
def test_ddim_cfg_trajectory_matches_jax(tiny_pair, clip_denoised):
    """4 DDIM steps with CFG 3.0 from t = 333 (an image-to-image start):
    from t = 999 a random-weight model drives every sample into the clip,
    since x0 = (x - sigma * eps) / signal divides by signal ~ 0.006.
    333 / 4 steps keeps the fractional t values that the schedule truncates."""
    jm, params, tm, (_, _, ctx) = tiny_pair
    rng = np.random.default_rng(12)
    x_init = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    uncond = np.zeros_like(ctx)
    engine = JaxSampler(model_fn=lambda p, x, t, c: jm.apply({"params": p}, x, t, c),
                        schedule=JaxCosine(timesteps=1000), transform=JaxEps(),
                        sampler=JaxDDIM(), guidance_scale=3.0, clip_denoised=clip_denoised)
    ref = np.asarray(engine.generate_samples(
        params, num_samples=2, resolution=16, diffusion_steps=4, conditioning=ctx,
        unconditional=uncond, init_samples=jnp.asarray(x_init), start_step=START))
    sampler = DiffusionSampler(lambda x, t, c: tm(x, t, c), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(),
                               guidance_scale=3.0, clip_denoised=clip_denoised, device="cpu")
    out = sampler.generate_samples(diffusion_steps=4, init_samples=torch.from_numpy(x_init),
                                   conditioning=torch.from_numpy(ctx),
                                   unconditional=torch.from_numpy(uncond),
                                   start_step=START).numpy()
    # most samples must stay inside the clip range, or the comparison is
    # one of +-1 against +-1
    assert (np.abs(ref) >= 1.0).mean() < 0.5 and np.abs(ref).mean() > 0.05
    # early DDIM steps divide by a small signal rate (~0.03 at t=749),
    # amplifying the forward's 1e-5-scale differences
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)


def test_heun_karras_cfg_trajectory_matches_jax(tiny_pair):
    """4 Heun steps with CFG 3.0 on the KarrasVE schedule with EDM
    preconditioning and karras spacing, from full noise (sigma 80): two
    model calls a step at c_noise = log(sigma) / 4, then the terminal one."""
    jm, params, tm, (_, _, ctx) = tiny_pair
    x_init = (80.0 * np.random.default_rng(14).standard_normal((2, 16, 16, 3))).astype(np.float32)
    uncond = np.zeros_like(ctx)
    engine = JaxSampler(model_fn=lambda p, x, t, c: jm.apply({"params": p}, x, t, c),
                        schedule=JaxKarrasVE(timesteps=1000), transform=JaxKarras(),
                        sampler=JaxHeun(), guidance_scale=3.0, timestep_spacing="karras")
    ref = np.asarray(engine.generate_samples(
        params, num_samples=2, resolution=16, diffusion_steps=4, conditioning=ctx,
        unconditional=uncond, init_samples=jnp.asarray(x_init)))
    sampler = DiffusionSampler(lambda x, t, c: tm(x, t, c), KarrasVENoiseSchedule(1000),
                               KarrasPredictionTransform(), HeunSampler(), guidance_scale=3.0,
                               timestep_spacing="karras", device="cpu")
    out = sampler.generate_samples(diffusion_steps=4, init_samples=torch.from_numpy(x_init),
                                   conditioning=torch.from_numpy(ctx),
                                   unconditional=torch.from_numpy(uncond)).numpy()
    assert (np.abs(ref) >= 1.0).mean() < 0.5 and np.abs(ref).mean() > 0.05
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("method", ["linear", "quadratic", "exponential"])
@pytest.mark.parametrize("steps", [1, 4, 25, 50])
def test_timestep_spacing_matches_jax(method, steps):
    """The model sees fractional t and the schedule truncates it: both the
    f32 values and the truncated indices must equal the JAX package's."""
    ref = np.asarray(jax_spacing(method, steps, 1000))
    out = get_timestep_spacing(method, steps, 1000).numpy()
    np.testing.assert_array_equal(out.astype(np.int32), ref.astype(np.int32))
    if method == "linear":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("name", ["Linear", "Cosine", "Exp"])
def test_schedule_rates_and_initial_noise_scale_match_jax(name):
    """Tables built in float64 and cast to f32 on both sides: bit-equal."""
    js = getattr(jschedulers, f"{name}NoiseSchedule")(timesteps=1000)
    ts = getattr(schedulers, f"{name}NoiseSchedule")(1000)
    t = np.array([0.0, 0.7, 499.5, 979.02, 999.0, 1500.0], np.float32)
    for a, b in zip(js.rates(jnp.asarray(t)), ts.rates(torch.from_numpy(t))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(ts.max_noise_std()) == float(js.max_noise_std())


@pytest.mark.parametrize("name", ["EpsilonPredictionTransform", "DirectPredictionTransform",
                                  "VPredictionTransform"])
def test_prediction_transforms_invert_like_jax(name):
    rng = np.random.default_rng(13)
    x_t = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    pred = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    t = np.array([0.0, 321.5, 999.0], np.float32)
    ref = getattr(jpredictors, name)().to_x0_eps(x_t, t, pred, JaxCosine(timesteps=1000))
    out = getattr(predictors, name)().to_x0_eps(
        *map(torch.from_numpy, (x_t, t, pred)), CosineNoiseSchedule(1000))
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
