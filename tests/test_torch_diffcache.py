"""The training-free caches (the timestep cache and the spatial token cache)
against the JAX package, on the CPU in f32: the plans' host schedules, the
split indices, the four ``cache_mode`` forwards of SimpleDiT, SimpleUDiT and
SimpleMMDiT, cached DDIM and Heun trajectories with CFG, and the inference
pipeline's plan handling and counters.

Every leaf of the flax side is a seeded numpy draw (``flax_leaves``, the
output projection at a tenth of its scale so that trajectories stay mostly
inside the clip), loaded into the port by ``convert.state_dict_from_flax``.
The JAX forwards run flash attention's Pallas kernel through the
interpreter (``FLAXDIFF_FLASH_INTERPRET=1``), SimpleDiT's the AdaLN kernels
too (``FLAXDIFF_FUSED_ADALN=interpret``: ~7 s of compiling a family, the
same kernels the other two call), each family's forwards in one jitted
program; the trajectories run JAX's CPU composition. The port runs its
kernels' plain versions either way.
"""
import contextlib
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models.dit import SimpleDiT as JaxDiT
from flaxdiff_tpu.models.mmdit import SimpleMMDiT as JaxMMDiT
from flaxdiff_tpu.models.uvit import SimpleUDiT as JaxUDiT
from flaxdiff_tpu.ops import diffcache as jdc
from flaxdiff_tpu.ops import spatialcache as jsc
from flaxdiff_tpu.predictors import EpsilonPredictionTransform as JaxEps
from flaxdiff_tpu.samplers import DDIMSampler as JaxDDIM
from flaxdiff_tpu.samplers import DiffusionSampler as JaxSampler
from flaxdiff_tpu.samplers import HeunSampler as JaxHeun
from flaxdiff_tpu.schedulers import LinearNoiseSchedule as JaxLinear
from test_torch_dit import _env
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)
from test_torch_unet_variants import _x, flax_leaves, load_port

from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline, build_model
from flaxdiff_tpu_torch.models import SimpleDiT, SimpleMMDiT, SimpleUDiT
from flaxdiff_tpu_torch.ops import diffcache as tdc
from flaxdiff_tpu_torch.ops import spatialcache as tsc
from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler, HeunSampler
from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule
from flaxdiff_tpu_torch.telemetry import global_telemetry

# f32 on both sides: matmuls and reductions summed in another order
MODULE_TOL = 1e-4
TRAJ_TOL = 1e-3
# 8x8x4 latents in patches of 2 (16 tokens), 32 wide in 2 heads, a 5-token
# text context of width 12
TEXT, CH, RES = 12, 4, 8
BASE = dict(output_channels=CH, patch_size=2, emb_features=32, num_heads=2)
# name -> (JAX class, port class, config, score metric, the JAX forwards'
# interpreted kernels)
FLASH = {"FLAXDIFF_FLASH_INTERPRET": "1"}
FAMILIES = {"simple_dit": (JaxDiT, SimpleDiT, dict(BASE, num_layers=3), "l2",
                           dict(FLASH, FLAXDIFF_FUSED_ADALN="interpret")),
            "simple_udit": (JaxUDiT, SimpleUDiT, dict(BASE, num_layers=4), "l2", FLASH),
            "simple_mmdit": (JaxMMDiT, SimpleMMDiT, dict(BASE, num_layers=3), "linf", FLASH)}
KEEP = 0.5


def inputs(seed):
    return (_x((2, RES, RES, CH), seed), np.array([17.0, 640.0], np.float32),
            _x((2, 5, TEXT), seed + 1))


# --- the host schedules -------------------------------------------------------------

CACHE_PLANS = [dict(), dict(refresh_every=1), dict(enabled=False),
               dict(refresh_every=4, refresh_head=0, refresh_tail=0),
               dict(refresh_every=2, refresh_head=3, refresh_tail=2),
               dict(refresh_every=16, depth_fraction=0.2, refresh_head=2, refresh_tail=1)]
SPATIAL_PLANS = [dict(), dict(keep_fraction=0.125, every=2), dict(keep_fraction=1.0),
                 dict(enabled=False), dict(keep_fraction=0.3, metric="linf", every=3)]


def _key(plan):
    return None if plan is None else plan.key()


@pytest.mark.parametrize("cache_kw", CACHE_PLANS, ids=lambda kw: str(kw) or "default")
def test_cache_plan_schedule_equals_jax(cache_kw):
    """flags, the reused fraction, the key, active_plan and resolve_plan of
    a CachePlan, at trajectory lengths 1 to 50."""
    jplan, tplan = jdc.CachePlan(**cache_kw), tdc.CachePlan(**cache_kw)
    assert tplan.key() == jplan.key()
    for n in (1, 2, 5, 10, 50):
        np.testing.assert_array_equal(tplan.flags(n), jplan.flags(n))
        assert tplan.reused_fraction(n) == jplan.reused_fraction(n)
    assert _key(tdc.active_plan(tplan)) == _key(jdc.active_plan(jplan))
    assert _key(tsc.resolve_plan(tplan)) == _key(jsc.resolve_plan(jplan))


@pytest.mark.parametrize("cache_kw,spatial_kw", list(itertools.product(
    CACHE_PLANS[::2] + CACHE_PLANS[3:4], SPATIAL_PLANS)), ids=lambda kw: str(kw) or "default")
def test_composed_plan_schedule_equals_jax(cache_kw, spatial_kw):
    """step_codes, counts, the key and resolve_plan's routing of a
    ComposedPlan (a bare SpatialPlan too): the same effective plan, or None,
    and the plan itself when nothing falls off."""
    jplan = jsc.ComposedPlan(jdc.CachePlan(**cache_kw), jsc.SpatialPlan(**spatial_kw))
    tplan = tsc.ComposedPlan(tdc.CachePlan(**cache_kw), tsc.SpatialPlan(**spatial_kw))
    assert tplan.key() == jplan.key()
    for n in (1, 6, 9, 50):
        np.testing.assert_array_equal(tplan.step_codes(n), jplan.step_codes(n))
        assert tplan.counts(n) == jplan.counts(n)
    jres, tres = jsc.resolve_plan(jplan), tsc.resolve_plan(tplan)
    assert _key(tres) == _key(jres)
    assert (tres is tplan) == (jres is jplan)
    assert _key(tsc.resolve_plan(tsc.SpatialPlan(**spatial_kw))) == \
        _key(jsc.resolve_plan(jsc.SpatialPlan(**spatial_kw)))


def test_plans_reject_what_jax_rejects():
    for kw in (dict(refresh_every=0), dict(depth_fraction=0.0), dict(depth_fraction=1.0),
               dict(refresh_head=-1)):
        for mod in (jdc, tdc):
            with pytest.raises(ValueError):
                mod.CachePlan(**kw)
    for kw in (dict(keep_fraction=0.0), dict(keep_fraction=1.5), dict(metric="cos"),
               dict(every=0)):
        for mod in (jsc, tsc):
            with pytest.raises(ValueError):
                mod.SpatialPlan(**kw)
    with pytest.raises(ValueError):
        tsc.ComposedPlan(cache="not-a-plan")
    assert tsc.DEFAULT_COMPOSED_PLAN.key() == jsc.DEFAULT_COMPOSED_PLAN.key()
    assert tdc.DEFAULT_CACHE_PLAN.key() == jdc.DEFAULT_CACHE_PLAN.key()
    # the counts quoted for DDIM-50 at DiT-B/2
    assert int(tdc.DEFAULT_CACHE_PLAN.flags(50).sum()) == 19
    assert tsc.DEFAULT_COMPOSED_PLAN.counts(50) == {"refresh": 6, "spatial": 21, "reused": 23}


# the half-to-even cases of Python's round: 2.5 -> 2, 3.5 -> 4, 0.5 -> 0
FRACTIONS = (0.1, 0.2, 0.25, 0.5, 0.6, 0.75, 0.9)


@pytest.mark.parametrize("num_layers", [2, 3, 5, 6, 7, 10, 12])
def test_flat_split_index_equals_jax(num_layers):
    """SimpleDiT's and SimpleMMDiT's split, and the refusal below 2 layers."""
    for frac in FRACTIONS:
        ref = JaxDiT(num_layers=num_layers).cache_split_index(frac)
        assert SimpleDiT.cache_split_index(_Layers(num_layers), frac) == ref
        assert SimpleMMDiT.cache_split_index(_Layers(num_layers), frac) == \
            JaxMMDiT(num_layers=num_layers).cache_split_index(frac)
    assert SimpleDiT.cache_split_index(_Layers(12), 0.2) == 2
    with pytest.raises(ValueError, match="num_layers >= 2"):
        SimpleDiT.cache_split_index(_Layers(1), 0.2)


@pytest.mark.parametrize("num_layers", [4, 6, 8, 12, 14])
def test_u_split_index_equals_jax(num_layers):
    for frac in FRACTIONS:
        assert SimpleUDiT.cache_split_index(_Layers(num_layers), frac) == \
            JaxUDiT(num_layers=num_layers).cache_split_index(frac)
    assert SimpleUDiT.cache_split_index(_Layers(12), 0.2) == 1
    with pytest.raises(ValueError, match="num_layers >= 4"):
        SimpleUDiT.cache_split_index(_Layers(2), 0.2)


class _Layers:
    """Just the depth a model's ``cache_split_index`` reads."""

    def __init__(self, num_layers):
        self.num_layers = num_layers


@pytest.mark.parametrize("num_tokens", [1, 4, 10, 16, 20, 256])
def test_spatial_k_equals_jax(num_tokens):
    for keep in (0.01, 0.125, 0.25, 0.3, 0.5, 0.75, 1.0):
        assert tsc.spatial_k(num_tokens, keep) == jsc.spatial_k(num_tokens, keep)
    assert tsc.spatial_k(256, 0.125) == 32


def test_selection_order_and_ties_equal_lax_top_k():
    """Descending score, the lower index first among equal scores, as
    ``lax.top_k`` returns them; the l2 and linf scores against JAX's; the
    scatter out of place."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 20, 6)).astype(np.float32)
    ref = h.copy()
    ref[:, [3, 7, 11, 15]] -= 1.0          # four tokens with one equal score
    ref[:, [2, 9]] -= 2.0
    for metric in tsc.METRICS:
        scores = tsc.token_change_scores(torch.from_numpy(h), torch.from_numpy(ref), metric)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jsc.token_change_scores(
            jnp.asarray(h), jnp.asarray(ref), metric)), rtol=1e-6, atol=1e-7)
        for keep in (0.1, 0.25, 0.3, 0.5):
            idx = tsc.select_tokens(torch.from_numpy(h), torch.from_numpy(ref), keep, metric)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jsc.select_tokens(
                jnp.asarray(h), jnp.asarray(ref), keep, metric)))
    full = torch.zeros(2, 5, 3)
    out = tsc.scatter_tokens(full, torch.tensor([4, 1]), torch.ones(2, 2, 3))
    assert float(full.abs().sum()) == 0.0 and float(out[:, [1, 4]].sum()) == 12.0


# --- the four cache_mode forwards -----------------------------------------------------

@functools.cache
def family(name):
    """(JAX module, the port model loaded with its leaves, the split, the
    score metric, the JAX forwards jitted into one program, the JAX
    variables)."""
    jcls, tcls, cfg, metric, _ = FAMILIES[name]
    jm = jcls(**cfg)
    params = flax_leaves(jm, 300 + len(name), *inputs(0))
    params["final_proj"] = jax.tree_util.tree_map(lambda a: a * 0.1, params["final_proj"])
    tm = load_port(tcls(**cfg, in_channels=CH, context_dim=TEXT, device="cpu"), params)
    split = jm.cache_split_index(0.2)
    v = {"params": params}

    def run(x1, x2, t, c):
        # JAX's record is its plain forward, bit for bit (tests/test_diffcache.py)
        apply = functools.partial(jm.apply, v, cache_split=split)
        plain, taps, ref = apply(x1, t, c, cache_mode="record_ref")
        reuse = apply(x2, t, c, cache_mode="reuse", cache_taps=taps)
        sp = apply(x2, t, c, cache_mode="spatial", cache_taps=taps, cache_ref=ref,
                   cache_keep=KEEP, cache_metric=metric)
        plain2, _, ref2 = apply(x2, t, c, cache_mode="record_ref")
        idx = jsc.select_tokens(ref2, ref, KEEP, metric)
        return dict(plain=plain, taps=taps, ref=ref, reuse=reuse, sp=sp[0], sp_taps=sp[1],
                    sp_ref=sp[2], plain2=plain2, idx=idx)

    return jm, tm, split, metric, jax.jit(run), v


def _close(out, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=MODULE_TOL,
                               atol=MODULE_TOL * max(1.0, float(np.abs(ref).max())), err_msg=what)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_cache_mode_forwards_match_jax(name):
    """record, record_ref, reuse (on another input, the first one's taps) and
    spatial (keep 1/2) against JAX's, the selected tokens equal; record and
    record_ref bit-equal to the port's plain forward."""
    jm, tm, split, metric, run, _ = family(name)
    x1, t, c = inputs(10)
    x2 = x1 + 0.3 * _x(x1.shape, 11)
    with contextlib.ExitStack() as stack:
        for var, value in FAMILIES[name][4].items():
            stack.enter_context(_env(var, value))
        ref = run(x1, x2, t, c)
    a1, a2, at, ac = (torch.from_numpy(a) for a in (x1, x2, t, c))
    with torch.no_grad():
        plain = tm(a1, at, ac)
        rec, taps = tm(a1, at, ac, cache_mode="record", cache_split=split)
        rr, taps_rr, shallow = tm(a1, at, ac, cache_mode="record_ref", cache_split=split)
        reuse = tm(a2, at, ac, cache_mode="reuse", cache_split=split, cache_taps=taps)
        sp, sp_taps, sp_ref = tm(a2, at, ac, cache_mode="spatial", cache_split=split,
                                 cache_taps=taps, cache_ref=shallow, cache_keep=KEEP,
                                 cache_metric=metric)
        plain2, _, shallow2 = tm(a2, at, ac, cache_mode="record_ref", cache_split=split)
    assert torch.equal(rec, plain) and torch.equal(rr, plain) and torch.equal(taps_rr, taps)
    idx = tsc.select_tokens(shallow2, shallow, KEEP, metric)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref["idx"]))
    assert np.abs(np.asarray(ref["taps"])).max() > 0.05, "an empty delta compares nothing"
    for key, out in dict(plain=plain, taps=taps, ref=shallow, reuse=reuse, sp=sp,
                         sp_taps=sp_taps, sp_ref=sp_ref, plain2=plain2).items():
        _close(out, ref[key], f"{name} {key}")
    # the unselected tokens kept their recorded taps and reference
    rest = np.setdiff1d(np.arange(taps.shape[1]), idx.numpy())
    assert torch.equal(sp_taps[:, rest], taps[:, rest])
    assert torch.equal(sp_ref[:, rest], shallow[:, rest])


def test_cache_mode_refusals_match_jax():
    _, tm, split, _, _, _ = family("simple_dit")
    x, t, c = (torch.from_numpy(a) for a in inputs(12))
    for kwargs, match in ((dict(cache_mode="nope"), "unknown cache_mode"),
                          (dict(cache_mode="record", cache_split=3), "out of range"),
                          (dict(cache_mode="reuse", cache_split=split), "requires cache_taps"),
                          (dict(cache_mode="spatial", cache_split=split,
                                cache_taps=torch.zeros(2, 16, 32)), "cache_ref")):
        with pytest.raises(ValueError, match=match):
            tm(x, t, c, **kwargs)


# --- cached trajectories ------------------------------------------------------------

TIMESTEP_PLAN = dict(refresh_every=3, refresh_head=1, refresh_tail=1)


def _both_plans(spatial):
    if spatial is None:
        return jdc.CachePlan(**TIMESTEP_PLAN), tdc.CachePlan(**TIMESTEP_PLAN)
    return (jsc.ComposedPlan(jdc.CachePlan(**TIMESTEP_PLAN), jsc.SpatialPlan(**spatial)),
            tsc.ComposedPlan(tdc.CachePlan(**TIMESTEP_PLAN), tsc.SpatialPlan(**spatial)))


@pytest.mark.parametrize("sampler,steps,spatial", [
    ("ddim", 8, None), ("ddim", 8, dict(keep_fraction=KEEP)),
    ("heun", 4, dict(keep_fraction=0.25, metric="linf"))],
    ids=["ddim-timestep", "ddim-composed", "heun-composed"])
def test_cached_trajectory_matches_jax(sampler, steps, spatial):
    """A cached trajectory with CFG 3.0 against JAX's DiffusionSampler with
    the same plan, from t = 333 (random weights drive a trajectory from
    t = 999 into the clip). 8 DDIM steps refresh at 0, 3, 6, 7 and reuse or
    run the spatial step between; Heun's second call of a step records again
    on a refresh step and reuses the newest taps otherwise."""
    jm, tm, _, _, _, params = family("simple_dit")
    jplan, tplan = _both_plans(spatial)
    jfns = (jdc.resolve_cache_fns(jm, jplan) if spatial is None
            else jsc.resolve_composed_fns(jm, jplan))
    tfns = (tdc.resolve_cache_fns(tm, tplan) if spatial is None
            else tsc.resolve_composed_fns(tm, tplan))
    jsampler, tsampler = (JaxDDIM(), DDIMSampler()) if sampler == "ddim" else (JaxHeun(),
                                                                              HeunSampler())
    x_init = 0.5 * _x((2, RES, RES, CH), 20)
    ctx = _x((2, 5, TEXT), 21)
    uncond = np.zeros_like(ctx)
    engine = JaxSampler(model_fn=lambda p, x, t, c: jm.apply(p, x, t, c),
                        schedule=JaxLinear(timesteps=1000), transform=JaxEps(), sampler=jsampler,
                        guidance_scale=3.0, cache_plan=jplan, cache_fns=jfns)
    ref = np.asarray(engine.generate_samples(
        params, num_samples=2, resolution=RES, diffusion_steps=steps, conditioning=ctx,
        unconditional=uncond, init_samples=jnp.asarray(x_init), start_step=333.0, channels=CH))
    ds = DiffusionSampler(lambda x, t, c: tm(x, t, c), LinearNoiseSchedule(1000),
                          EpsilonPredictionTransform(), tsampler, guidance_scale=3.0,
                          device="cpu", cache_plan=tplan, cache_fns=tfns)
    assert ds.cache_active and ds.spatial_active == (spatial is not None)
    out = ds.generate_samples(diffusion_steps=steps, init_samples=torch.from_numpy(x_init),
                              conditioning=torch.from_numpy(ctx),
                              unconditional=torch.from_numpy(uncond), start_step=333.0,
                              channels=CH).numpy()
    plain = DiffusionSampler(lambda x, t, c: tm(x, t, c), LinearNoiseSchedule(1000),
                             EpsilonPredictionTransform(), tsampler, guidance_scale=3.0,
                             device="cpu").generate_samples(
        diffusion_steps=steps, init_samples=torch.from_numpy(x_init),
        conditioning=torch.from_numpy(ctx), unconditional=torch.from_numpy(uncond),
        start_step=333.0, channels=CH).numpy()
    assert (np.abs(ref) >= 1.0).mean() < 0.5 and np.abs(ref).mean() > 0.05
    np.testing.assert_allclose(out, ref, atol=TRAJ_TOL, rtol=TRAJ_TOL)
    assert np.abs(out - plain).max() > 10 * TRAJ_TOL, "the cache changed nothing"


# --- the inference pipeline ---------------------------------------------------------

@pytest.fixture(scope="module")
def pipe():
    cfg = {"name": "simple_dit", **BASE, "num_layers": 3, "in_channels": 1,
           "output_channels": 1}
    model = build_model(**cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.2 if p.ndim < 2 else
                                                           p[0].numel() ** -0.5))
    params = {k: v.clone() for k, v in model.named_parameters()}
    # v-prediction: x0 = signal x - sigma v stays bounded where eps-prediction
    # divides a random model's eps by the signal rate and clips everything
    config = {"model": cfg, "schedule": {"name": "cosine", "timesteps": 100},
              "predictor": "v_prediction"}
    return DiffusionInferencePipeline.from_config(config, params, device="cpu")


KW = dict(num_samples=2, resolution=8, channels=1, diffusion_steps=6, sampler="ddim", seed=11,
          use_ema=False)
_PLAN = tsc.ComposedPlan(tdc.CachePlan(refresh_every=3, refresh_head=1, refresh_tail=1),
                         tsc.SpatialPlan(keep_fraction=0.5, every=2))


def test_pipeline_sampler_cache_keys_on_the_effective_plan(pipe):
    """resolve_plan first: refresh_every=1 is the uncached sampler, keep 1.0
    or a disabled spatial axis the timestep one; equal plans share a
    sampler, other plans never."""
    base = pipe.get_sampler("ddim", 0.0)
    cache = tdc.CachePlan(refresh_every=3)
    assert pipe.get_sampler("ddim", 0.0, cache_plan=tdc.CachePlan(refresh_every=1)) is base
    a = pipe.get_sampler("ddim", 0.0, cache_plan=cache)
    for spatial in (tsc.SpatialPlan(keep_fraction=1.0), tsc.SpatialPlan(enabled=False)):
        assert pipe.get_sampler("ddim", 0.0, cache_plan=tsc.ComposedPlan(cache, spatial)) is a
    c = pipe.get_sampler("ddim", 0.0, cache_plan=_PLAN)
    assert c is pipe.get_sampler("ddim", 0.0, cache_plan=dataclasses.replace(_PLAN))
    d = pipe.get_sampler("ddim", 0.0, cache_plan=dataclasses.replace(
        _PLAN, spatial=tsc.SpatialPlan(keep_fraction=0.25)))
    assert len({id(s) for s in (base, a, c, d)}) == 4
    assert not base.cache_active and a.cache_active and not a.spatial_active
    assert c.spatial_active and d.spatial_active


def test_pipeline_always_refresh_request_is_bit_equal_to_uncached(pipe):
    plain = pipe.generate_samples(**KW)
    assert (np.abs(plain) >= 1.0).mean() < 0.5
    np.testing.assert_array_equal(
        pipe.generate_samples(**KW, cache_plan=tdc.CachePlan(refresh_every=1)), plain)
    np.testing.assert_array_equal(pipe.generate_samples(**KW, cache_plan=tsc.ComposedPlan(
        tdc.CachePlan(refresh_every=1), tsc.SpatialPlan())), plain)
    assert not np.array_equal(pipe.generate_samples(**KW, cache_plan=_PLAN), plain)


def test_pipeline_counts_each_request_on_the_global_hub(pipe):
    """diffcache/* as JAX's pipeline counts them: codes(6) of _PLAN are
    [2, 0, 1, 2, 0, 2]; the timestep plan's flags [T, F, F, T, F, T]."""
    names = ("requests", "spatial_requests", "refresh_steps", "spatial_steps", "reused_steps")
    read = lambda: {n: global_telemetry().counter(f"diffcache/{n}").value for n in names}
    before = read()
    pipe.generate_samples(**KW, cache_plan=_PLAN)
    pipe.generate_samples(**KW, cache_plan=_PLAN.cache)
    pipe.generate_samples(**KW)
    after = read()
    delta = {n: after[n] - before[n] for n in names}
    jcodes = jsc.ComposedPlan(jdc.CachePlan(refresh_every=3, refresh_head=1, refresh_tail=1),
                              jsc.SpatialPlan(keep_fraction=0.5, every=2)).counts(6)
    assert jcodes == {"refresh": 3, "spatial": 1, "reused": 2}
    assert delta == {"requests": 2, "spatial_requests": 1, "refresh_steps": 3 + 3,
                     "spatial_steps": 1, "reused_steps": 2 + 3}


def test_pipeline_refuses_a_model_without_the_contract():
    config = {"model": {"name": "uvit", "patch_size": 2, "emb_features": 16, "num_layers": 2,
                        "num_heads": 2, "in_channels": 1, "output_channels": 1},
              "schedule": {"name": "cosine", "timesteps": 100}, "predictor": "epsilon"}
    model = build_model(**config["model"], device="cpu")
    pipe = DiffusionInferencePipeline.from_config(config, dict(model.named_parameters()),
                                                  device="cpu")
    assert not tdc.model_supports_cache(pipe.model)
    with pytest.raises(ValueError, match="cache_mode forward contract"):
        pipe.get_sampler("ddim", cache_plan=tdc.DEFAULT_CACHE_PLAN)
