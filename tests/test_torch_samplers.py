"""The port's schedules, Karras transform, samplers and sampler engine against
the JAX package, on the CPU in f32.

Samplers run on the reference's own analytic models (`test_samplers.py`: a
perfect eps-predictor for data ~ delta(MU), and one for N(0, c^2)) and its
VP_SAMPLERS / VE_SAMPLERS lists. torch cannot reproduce threefry, so each
trajectory's draws are rebuilt from the JAX engine's key sequence and handed
to the port through a `GivenNoise`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu import predictors as jpredictors
from flaxdiff_tpu import samplers as jsamplers
from flaxdiff_tpu import schedulers as jschedulers
from flaxdiff_tpu.samplers.common import get_timestep_spacing as jax_spacing
from flaxdiff_tpu.schedulers.common import bcast_right as jbcast
from flaxdiff_tpu.utils import RngSeq
from test_samplers import MU, VE_SAMPLERS, VP_SAMPLERS, make_delta_model

from flaxdiff_tpu_torch import predictors, samplers, schedulers
from flaxdiff_tpu_torch.samplers import DiffusionSampler, GivenNoise, get_timestep_spacing
from flaxdiff_tpu_torch.samplers.common import _resize_nearest
from flaxdiff_tpu_torch.schedulers import SigmaSchedule, bcast_right

T = 1000
# a step index at 0, fractions a continuous schedule reads as normalized
# (0.5, 1.0), a fractional index, the last index and one beyond the range
TS = np.array([0.0, 0.5, 1.0, 333.7, 999.0, 1500.0], np.float32)
# closed forms: the same f32 operations on both sides, the libraries' exp,
# log, pow and trig a few ulps apart at most
CLOSED_RTOL = 1e-6
STEP_TOL = 1e-5          # one sampler step, times max(1, max|ref|)
TRAJ_TOL = 1e-4          # a whole trajectory
# the Gaussian model's trajectories follow every rounding: Euler's first VP
# step from t = 999 takes x_hat = x / signal, signal(999) = 4.9e-5, and
# cancels it back. One f32 ulp of x_hat (2e-3 at 2e4) times signal(799.2) =
# 0.31 is 6e-4, and the two sides round that multiply-add differently (XLA
# fuses it into one rounding)
GAUSS_TRAJ_TOL = 1e-3
GAUSS_C = 0.4
STOCHASTIC = (jsamplers.DDPMSampler, jsamplers.SimpleDDPMSampler,
              jsamplers.EulerAncestralSampler)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(out, ref, tol, what=""):
    """Every element within tol * max(1, max|ref|)."""
    out, ref = np.asarray(_np(out), np.float64), np.asarray(_np(ref), np.float64)
    assert out.shape == ref.shape, f"{what}: shape {out.shape} vs {ref.shape}"
    bound = tol * max(1.0, np.abs(ref).max())
    err = np.abs(out - ref).max()
    assert err <= bound, f"{what}: max error {err:.3g} above {bound:.3g}"


# --- schedules --------------------------------------------------------------------

def test_registries_match_jax():
    assert list(schedulers.SCHEDULE_REGISTRY) == list(jschedulers.SCHEDULE_REGISTRY)
    assert list(samplers.SAMPLER_REGISTRY) == list(jsamplers.SAMPLER_REGISTRY)
    assert list(predictors.TRANSFORM_REGISTRY) == list(jpredictors.TRANSFORM_REGISTRY)
    for registry, jregistry in ((schedulers.SCHEDULE_REGISTRY, jschedulers.SCHEDULE_REGISTRY),
                                (samplers.SAMPLER_REGISTRY, jsamplers.SAMPLER_REGISTRY),
                                (predictors.TRANSFORM_REGISTRY, jpredictors.TRANSFORM_REGISTRY)):
        for name in registry:
            assert registry[name].__name__ == jregistry[name].__name__, name
    for get in (schedulers.get_schedule, samplers.get_sampler, predictors.get_transform):
        with pytest.raises(ValueError, match="Unknown"):
            get("nope")
    assert isinstance(samplers.get_sampler("multistep_dpm", order=3),
                      samplers.MultiStepDPMSampler)


@pytest.mark.parametrize("name", list(jschedulers.SCHEDULE_REGISTRY))
def test_schedule_matches_jax(name):
    js = jschedulers.get_schedule(name, timesteps=T)
    ts = schedulers.get_schedule(name, timesteps=T)
    t, tj = torch.from_numpy(TS), jnp.asarray(TS)
    assert ts.is_continuous == js.is_continuous
    table = name in ("linear", "cosine", "exp")
    check = (np.testing.assert_array_equal if table
             else lambda a, b: np.testing.assert_allclose(a, b, rtol=CLOSED_RTOL, atol=0))
    for a, b in zip(ts.rates(t), js.rates(tj)):
        check(a.numpy(), np.asarray(b))
    check(ts.loss_weights(t).numpy(), np.asarray(js.loss_weights(tj)))
    x = np.random.default_rng(1).standard_normal((6, 2, 2, 1)).astype(np.float32)
    (x_in, t_in), (jx_in, jt_in) = ts.transform_inputs(torch.from_numpy(x), t), \
        js.transform_inputs(jnp.asarray(x), tj)
    np.testing.assert_array_equal(x_in.numpy(), np.asarray(jx_in))
    check(t_in.numpy(), np.asarray(jt_in))
    check(ts.max_noise_std().numpy(), np.asarray(js.max_noise_std()))
    noise = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    x_t = ts.add_noise(torch.from_numpy(x), torch.from_numpy(noise), t)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(js.add_noise(x, noise, tj)),
                               rtol=CLOSED_RTOL, atol=1e-7)
    np.testing.assert_allclose(
        ts.remove_all_noise(x_t, torch.from_numpy(noise), t).numpy(),
        np.asarray(js.remove_all_noise(jnp.asarray(x_t.numpy()), noise, tj)),
        rtol=CLOSED_RTOL, atol=1e-6)
    if isinstance(ts, SigmaSchedule):
        sig = ts.sigmas(t)
        check(sig.numpy(), np.asarray(js.sigmas(tj)))
        back = ts.timesteps_from_sigmas(sig)
        np.testing.assert_allclose(back.numpy(), np.asarray(js.timesteps_from_sigmas(
            jnp.asarray(sig.numpy()))), rtol=CLOSED_RTOL, atol=1e-4)
        # the round trip returns t, clipped to the ramp [0, T - 1]; the
        # inverse's f32 pow/log/atan loses a few ulps of sigma near 0
        np.testing.assert_allclose(back.numpy(), np.clip(TS, 0, T - 1), rtol=1e-4, atol=1e-2)
    if table:
        for field in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                      "sqrt_one_minus_alphas_cumprod", "posterior_variance",
                      "posterior_log_variance_clipped", "posterior_mean_coef1",
                      "posterior_mean_coef2"):
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)), err_msg=field)
        np.testing.assert_array_equal(
            ts.posterior_mean(torch.from_numpy(x), torch.from_numpy(noise), t).numpy(),
            np.asarray(js.posterior_mean(x, noise, tj)))
        np.testing.assert_array_equal(ts.posterior_log_variance(t, 4).numpy(),
                                      np.asarray(js.posterior_log_variance(tj, 4)))


@pytest.mark.parametrize("name", list(jschedulers.SCHEDULE_REGISTRY))
def test_sample_timesteps_dtype_range_and_generator(name):
    js = jschedulers.get_schedule(name, timesteps=T)
    ts = schedulers.get_schedule(name, timesteps=T)
    a = ts.sample_timesteps(torch.Generator().manual_seed(3), 4096)
    b = ts.sample_timesteps(torch.Generator().manual_seed(3), 4096)
    c = ts.sample_timesteps(torch.Generator().manual_seed(4), 4096)
    ref = js.sample_timesteps(jax.random.PRNGKey(0), 4096)
    assert str(a.dtype).split(".")[-1] == str(ref.dtype)
    assert a.shape == (4096,) and torch.equal(a, b) and not torch.equal(a, c)
    lo, hi = float(jnp.min(ref)), float(jnp.max(ref))
    top = {"cosine_continuous": 1.0, "sqrt": 1.0}.get(name, T - 1)
    assert 0 <= float(a.min()) and float(a.max()) <= top
    # both sides spread over the same range (4096 draws of either law)
    assert abs(float(a.min()) - lo) <= 0.02 * top and abs(float(a.max()) - hi) <= 0.02 * top


def test_edm_training_sigmas_are_log_normal():
    ts = schedulers.EDMNoiseSchedule(timesteps=T)
    t = ts.sample_timesteps(torch.Generator().manual_seed(5), 20000)
    log_sigma = torch.log(ts.sigmas(t)).double()
    # N(-1.2, 1.2) clipped to [log 0.002, log 80], 4.2 and 4.6 sigmas out;
    # the mean's standard error over 20k draws is 0.0085
    assert abs(float(log_sigma.mean()) + 1.2) < 0.03
    assert abs(float(log_sigma.std()) - 1.2) < 0.03


KARRAS_SCHEDULES = [None, "karras", "simple_exp", "cosine_general"]


@pytest.mark.parametrize("sched", KARRAS_SCHEDULES, ids=lambda s: s or "t_domain")
@pytest.mark.parametrize("steps", [1, 2, 3, 25, 50])
def test_karras_spacing_matches_jax(steps, sched):
    js = None if sched is None else jschedulers.get_schedule(sched, timesteps=T)
    ts = None if sched is None else schedulers.get_schedule(sched, timesteps=T)
    ref = np.asarray(jax_spacing("karras", steps, T, schedule=js))
    out = get_timestep_spacing("karras", steps, T, schedule=ts).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == (steps + 1,)
    assert out[0] == ref[0] == T - 1 and out[-1] == ref[-1] == 0.0
    np.testing.assert_allclose(out, ref, rtol=CLOSED_RTOL, atol=0)
    assert np.all(np.diff(out) < 0)


def test_karras_transform_matches_jax():
    js, ts = jschedulers.KarrasVENoiseSchedule(timesteps=T), schedulers.KarrasVENoiseSchedule(T)
    jtr, ttr = jpredictors.KarrasPredictionTransform(), predictors.KarrasPredictionTransform()
    rng = np.random.default_rng(6)
    x0, noise, raw = (rng.standard_normal((6, 3, 3, 2)).astype(np.float32) for _ in range(3))
    t = torch.from_numpy(TS)
    x_t, target = ttr.forward(ts, torch.from_numpy(x0), torch.from_numpy(noise), t)
    for a, b in zip((x_t, target), jtr.forward(js, x0, noise, jnp.asarray(TS))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CLOSED_RTOL, atol=1e-6)
    np.testing.assert_allclose(ttr.input_scale(ts, t).numpy(),
                               np.asarray(jtr.input_scale(js, jnp.asarray(TS))),
                               rtol=CLOSED_RTOL, atol=0)
    pred = ttr.transform_output(x_t, t, torch.from_numpy(raw), ts)
    ref_pred = jtr.transform_output(jnp.asarray(x_t.numpy()), jnp.asarray(TS), raw, js)
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred), rtol=CLOSED_RTOL, atol=1e-6)
    for a, b in zip(ttr.to_x0_eps(x_t, t, pred, ts),
                    jtr.to_x0_eps(jnp.asarray(x_t.numpy()), jnp.asarray(TS), ref_pred, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# --- samplers -------------------------------------------------------------------

def port_twin(sampler):
    """The port's sampler of the same class and settings as a JAX one."""
    kwargs = {k: getattr(sampler, k) for k in ("eta", "order") if hasattr(sampler, k)}
    return getattr(samplers, type(sampler).__name__)(**kwargs)


def sampler_id(s):
    return type(s).__name__ + "".join(f"_{k}{getattr(s, k)}" for k in ("eta", "order")
                                      if getattr(s, k, 0))


def delta_model(schedule):
    """The port's twin of the reference's delta(MU) model (test_samplers.py:34-52)."""
    def model_fn(x, t, cond):
        if isinstance(schedule, SigmaSchedule):
            sigma = torch.exp(4.0 * t)
            signal = torch.ones_like(sigma)
        else:
            signal, sigma = schedule.rates(t)
        return (x - bcast_right(signal, x.ndim) * MU) / torch.clamp_min(
            bcast_right(sigma, x.ndim), 1e-6)
    return model_fn


def both_models(jschedule, schedule):
    """The reference's two analytic eps-models on each side, mixed by
    `params` (1: delta(MU), test_samplers.py:34-52; 0: data ~ N(0, c^2),
    test_samplers.py:106-110 and 127-129), so one compiled JAX program runs
    both."""
    jdelta, tdelta = make_delta_model(jschedule), delta_model(schedule)

    def jax_fn(params, x, t, cond):
        if isinstance(jschedule, jschedulers.SigmaSchedule):
            s, sg = 1.0, jbcast(jnp.exp(4.0 * t), x.ndim)
        else:
            signal, sigma = jschedule.rates(t)
            s, sg = jbcast(signal, x.ndim), jbcast(sigma, x.ndim)
        gauss = sg * x / (s ** 2 * GAUSS_C ** 2 + sg ** 2)
        return params * jdelta(None, x, t, cond) + (1.0 - params) * gauss

    def port_fn(mix):
        def model_fn(x, t, cond):
            if isinstance(schedule, SigmaSchedule):
                s, sg = 1.0, bcast_right(torch.exp(4.0 * t), x.ndim)
            else:
                signal, sigma = schedule.rates(t)
                s, sg = bcast_right(signal, x.ndim), bcast_right(sigma, x.ndim)
            gauss = sg * x / (s ** 2 * GAUSS_C ** 2 + sg ** 2)
            return mix * tdelta(x, t, cond) + (1.0 - mix) * gauss
        return model_fn

    return jax_fn, port_fn


def vp_pair():
    return jschedulers.CosineNoiseSchedule(timesteps=T), schedulers.CosineNoiseSchedule(T)


def ve_pair():
    # the reference's VE sampler tests: sigma_max 20
    return (jschedulers.KarrasVENoiseSchedule(timesteps=T, sigma_min=0.002, sigma_max=20.0),
            schedulers.KarrasVENoiseSchedule(T, sigma_min=0.002, sigma_max=20.0))


MODELS = {"delta": 1.0, "gaussian": 0.0}


def engines(jsampler, pair, model="delta", **kw):
    """The JAX engine, whose `params` pick the model (`MODELS`), and the
    port's engine on `model`."""
    js, ts = pair
    jfn, port_fn = both_models(js, ts)
    ref = jsamplers.DiffusionSampler(model_fn=jfn, schedule=js,
                                     transform=jpredictors.EpsilonPredictionTransform(),
                                     sampler=jsampler, **kw)
    out = DiffusionSampler(port_fn(MODELS[model]), ts, predictors.EpsilonPredictionTransform(),
                           port_twin(jsampler), device="cpu", **kw)
    return ref, out


def is_stochastic(jsampler):
    return isinstance(jsampler, STOCHASTIC) or getattr(jsampler, "eta", 0.0) > 0


def jax_draws(jsampler, shape, steps, seed=0, initial=True, inpaint=False):
    """The JAX engine's draws, in the order the port makes them: the initial
    noise (`noise_key`), then each step's sampler noise from `split(rng)`
    and, with inpainting, the re-noising from a further split
    (flaxdiff_tpu/samplers/common.py:569-571, 477-488)."""
    rng = RngSeq.create(seed)
    rng, noise_key = rng.next_key()
    rng, key = rng.next_key()
    draws = [jax.random.normal(noise_key, shape)] if initial else []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        if is_stochastic(jsampler):
            draws.append(jax.random.normal(sub, shape))
        if inpaint:
            key, nk = jax.random.split(key)
            draws.append(jax.random.normal(nk, shape, jnp.float32))
    return [np.array(d) for d in draws]


ALL_SAMPLERS = ([pytest.param(s, vp_pair, id="vp-" + sampler_id(s)) for s in VP_SAMPLERS]
                + [pytest.param(s, ve_pair, id="ve-" + sampler_id(s)) for s in VE_SAMPLERS])


@pytest.mark.parametrize("jsampler,pair", ALL_SAMPLERS)
def test_sampler_steps_match_jax(jsampler, pair):
    """Three steps from the same x, each side carrying its own state, the
    stochastic samplers given one draw a step."""
    ref_engine, engine = engines(jsampler, pair())
    js, ts = ref_engine.schedule, engine.schedule
    jden = ref_engine._denoise_fn(MODELS["delta"], None, None)
    tden = engine._denoise_fn(None, None)
    steps = np.asarray(jax_spacing("linear", 6, T, schedule=js))
    x = (np.random.default_rng(7).standard_normal((2, 4, 4, 1))
         * float(js.max_noise_std())).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate, tstate = jsampler.init_state(jx), engine.sampler.init_state(tx)
    noise_rng = jax.random.PRNGKey(8)
    for i in range(3):
        noise_rng, key = jax.random.split(noise_rng)
        given = GivenNoise([np.array(jax.random.normal(key, x.shape))])
        jx, jstate = jsampler.step(jden, jx, jnp.float32(steps[i]), jnp.float32(steps[i + 1]),
                                   key, jstate, js, i)
        tx, tstate = engine.sampler.step(tden, tx, torch.tensor(steps[i]),
                                         torch.tensor(steps[i + 1]), given, tstate, ts, i)
        assert given.used == int(is_stochastic(jsampler))
        assert_close(tx, jx, STEP_TOL, f"step {i}")


@pytest.mark.parametrize("jsampler,pair", ALL_SAMPLERS)
def test_trajectory_matches_jax(jsampler, pair):
    """A 6-step trajectory from full noise with the JAX engine's draws, on
    each model (one JAX program). The delta model's output is MU whatever
    the path; the Gaussian model's follows every draw."""
    js, ts = pair()
    for model, mix in MODELS.items():
        if model == "delta":
            ref_engine, engine = engines(jsampler, (js, ts), model)
        else:
            engine = engines(jsampler, (js, ts), model)[1]
        ref = ref_engine.generate_samples(params=mix, num_samples=2, resolution=8,
                                          diffusion_steps=6, rngstate=RngSeq.create(0),
                                          channels=1)
        given = GivenNoise(jax_draws(jsampler, (2, 8, 8, 1), 6))
        out = engine.generate_samples(num_samples=2, resolution=8, diffusion_steps=6,
                                      generator=given, channels=1)
        assert given.used == len(given.arrays)
        assert_close(out, ref, TRAJ_TOL if model == "delta" else GAUSS_TRAJ_TOL,
                     f"{model} trajectory")
    assert float(np.std(np.asarray(ref))) > 0.1   # the draws shaped the Gaussian samples


def test_rk4_raises_on_a_vp_schedule():
    engine = DiffusionSampler(delta_model(schedulers.CosineNoiseSchedule(T)),
                              schedulers.CosineNoiseSchedule(T),
                              predictors.EpsilonPredictionTransform(), samplers.RK4Sampler(),
                              device="cpu")
    with pytest.raises(TypeError, match="SigmaSchedule"):
        engine.generate_samples(num_samples=1, resolution=4, diffusion_steps=2, channels=1)
    jsched = jschedulers.CosineNoiseSchedule(timesteps=T)
    ref = jsamplers.DiffusionSampler(model_fn=make_delta_model(jsched), schedule=jsched,
                                     transform=jpredictors.EpsilonPredictionTransform(),
                                     sampler=jsamplers.RK4Sampler())
    with pytest.raises(AssertionError, match="SigmaSchedule"):
        ref.generate_samples(params=None, num_samples=1, resolution=4, diffusion_steps=2,
                             channels=1)


def test_given_noise_checks_its_draws():
    given = GivenNoise([np.zeros((2, 3), np.float32)])
    with pytest.raises(ValueError, match="given"):
        given.normal((3, 2))
    assert given.normal((2, 3)).shape == (2, 3)
    with pytest.raises(IndexError):
        given.normal((2, 3))


# --- the engine: video, inpainting --------------------------------------------------

def test_video_shapes_match_jax():
    jsampler = jsamplers.DDIMSampler()
    ref_engine, engine = engines(jsampler, vp_pair(), "gaussian")
    shape = (2, 3, 8, 8, 1)
    ref = ref_engine.generate_samples(params=MODELS["gaussian"], num_samples=2, resolution=8,
                                      diffusion_steps=6, rngstate=RngSeq.create(0),
                                      sequence_length=3, channels=1)
    out = engine.generate_images(num_samples=2, resolution=8, diffusion_steps=6,
                                 generator=GivenNoise(jax_draws(jsampler, shape, 6)),
                                 sequence_length=3, channels=1)
    assert out.shape == ref.shape == shape
    assert_close(out, ref, TRAJ_TOL, "video trajectory")


@pytest.mark.parametrize("m,n", [(8, 5), (5, 8), (8, 3), (3, 8), (7, 7)])
def test_mask_resize_matches_jax_nearest(m, n):
    """jax.image.resize's nearest takes half-pixel centres; torch's
    F.interpolate "nearest" does not (8 -> 5 picks 0 1 3 4 6 there, 0 2 4 5 7
    here and in JAX)."""
    mask = np.random.default_rng(m * 10 + n).random((2, m, m + 1, 1)).astype(np.float32)
    ref = np.asarray(jax.image.resize(mask, (2, n, n + 2, 1), method="nearest"))
    out = _resize_nearest(torch.from_numpy(mask), (n, n + 2)).numpy()
    np.testing.assert_array_equal(out, ref)


INPAINT_CASES = [
    # sampler, sample shape (N, [T,] R, R, C), the mask's H and W, whether it
    # has a channel dim
    pytest.param(jsamplers.DDIMSampler(), (2, 8, 8, 1), 8, False, id="ddim"),
    pytest.param(jsamplers.DDPMSampler(), (2, 5, 5, 1), 8, True, id="ddpm-mask-8-to-5"),
    pytest.param(jsamplers.EulerAncestralSampler(), (1, 3, 6, 6, 2), 4, False,
                 id="euler_a-video-mask-4-to-6"),
]


@pytest.mark.parametrize("jsampler,shape,hw,channel", INPAINT_CASES)
def test_inpainting_matches_jax(jsampler, shape, hw, channel):
    """The left half generated, the right half kept: the output keeps the
    reference there exactly."""
    ref_engine, engine = engines(jsampler, vp_pair(), "gaussian")
    reference = np.random.default_rng(9).uniform(-0.8, 0.8, shape).astype(np.float32)
    mask = np.zeros(shape[:-3] + (hw, hw, 1), np.float32)
    mask[..., : hw // 2, :] = 1.0
    mask = mask if channel else mask[..., 0]
    kw = dict(num_samples=shape[0], resolution=shape[-2], diffusion_steps=6,
              channels=shape[-1], sequence_length=shape[1] if len(shape) == 5 else None)
    ref = np.asarray(ref_engine.generate_samples(
        params=MODELS["gaussian"], rngstate=RngSeq.create(0), inpaint_reference=reference,
        inpaint_mask=mask, **kw))
    given = GivenNoise(jax_draws(jsampler, shape, 6, inpaint=True))
    out = engine.generate_samples(generator=given, inpaint_reference=torch.from_numpy(reference),
                                  inpaint_mask=torch.from_numpy(mask), **kw).numpy()
    assert given.used == len(given.arrays)
    assert_close(out, ref, TRAJ_TOL, "inpainted trajectory")
    keep = ref == reference
    assert 0.3 < keep.mean() < 0.7
    np.testing.assert_array_equal(out[keep], reference[keep])


def test_inpainting_checks_like_jax():
    jsampler = jsamplers.DDIMSampler()
    ref_engine, engine = engines(jsampler, vp_pair())
    reference = np.zeros((2, 8, 8, 1), np.float32)
    kw = dict(num_samples=2, resolution=8, diffusion_steps=2, channels=1)
    for bad in (dict(inpaint_reference=reference),                             # no mask
                dict(inpaint_reference=reference, inpaint_mask=np.ones((8, 8))),  # rank 2
                dict(inpaint_reference=reference[:1], inpaint_mask=np.ones((1, 8, 8)))):
        with pytest.raises(ValueError) as jerr:
            ref_engine.generate_samples(params=None, **kw, **bad)
        with pytest.raises(ValueError) as terr:
            engine.generate_samples(**kw, **{k: torch.from_numpy(np.asarray(v))
                                             for k, v in bad.items()})
        assert str(terr.value) == str(jerr.value)
