"""The port's serving subsystem (``flaxdiff_tpu_torch/serving``) on the CPU.

Against the JAX package: the JAX `ServingScheduler` and the port's serve
the same requests on a tiny SimpleDiT (emb 32, 4 heads, 8x8x1 in patches of
4; the JAX serving tests' model) with the same seeded numpy weights: mixed
NFE, a padding row, chunked rounds, DDIM and Euler-ancestral, multistep
DPM's state carry across rounds, prompted CFG, and the timestep and
composed cache plans on a 3-layer DiT. torch cannot reproduce threefry,
so the port gets the JAX engine's draws through `noise_factory`, rebuilt
from the engine's key lineage (``flaxdiff_tpu/serving/engine.py:470-472``,
then a split per step). Tolerance: 1e-4 x max(1, max|ref|), the samplers'
trajectory tolerance (f32 matmuls summed in another order on each side).
`build_workload` gives the same list on both sides.

The port alone: a request batched with others, padded and chunked is bit
for bit the same request served alone in the same bucket, and a request
alone in bucket 1 is bit for bit the solo `generate_samples`. Against a
solo call in another bucket the port holds 1e-5 (`SOLO_TOL`): MKL's sgemm
rounds a row differently at another row count M (M = 1 runs a gemv), so
batching moves the last bits. A warm replay builds no program. The
scheduler's mechanics run on a torch-free fake engine (the JAX serving
tests' `FakeEngine`).
"""
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from flaxdiff_tpu.inference import DiffusionInferencePipeline as JaxPipeline
from flaxdiff_tpu.inputs import ConditionalInputConfig as JaxConditional
from flaxdiff_tpu.inputs import DiffusionInputConfig as JaxInputConfig
from flaxdiff_tpu.inputs import HashTextEncoder as JaxHash
from flaxdiff_tpu.models.dit import SimpleDiT as JaxDiT
from flaxdiff_tpu.ops import diffcache as jdc
from flaxdiff_tpu.ops import spatialcache as jsc
from flaxdiff_tpu.serving import PoissonWorkloadSpec as JaxSpec
from flaxdiff_tpu.serving import SampleRequest as JaxRequest
from flaxdiff_tpu.serving import SchedulerConfig as JaxConfig
from flaxdiff_tpu.serving import ServingScheduler as JaxScheduler
from flaxdiff_tpu.serving import build_workload as jax_build_workload
from flaxdiff_tpu.telemetry import Telemetry as JaxTelemetry
from flaxdiff_tpu.utils import RngSeq
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)
from test_torch_unet_variants import flax_leaves

from flaxdiff_tpu_torch import convert
from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
from flaxdiff_tpu_torch.models import SimpleDiT
from flaxdiff_tpu_torch.ops import diffcache as tdc
from flaxdiff_tpu_torch.ops import spatialcache as tsc
from flaxdiff_tpu_torch.samplers import GivenNoise
from flaxdiff_tpu_torch.serving import (DeadlineExceeded, PoissonWorkloadSpec, RequestState,
                                        SampleRequest, SchedulerClosed, SchedulerConfig,
                                        ServingFault, ServingScheduler, build_workload,
                                        bucket_up, nfe_bucket, replay)
from flaxdiff_tpu_torch.serving import scheduler as sched_mod
from flaxdiff_tpu_torch.telemetry import Telemetry

TOL = 1e-4            # against JAX, times max(1, max|ref|)
SOLO_TOL = 1e-5       # against a solo call at another batch size
RES, CH, TEXT, TEXT_LEN = 8, 1, 16, 8
DIT = dict(emb_features=32, num_heads=4, num_layers=1, patch_size=4, output_channels=CH)
DIT3 = dict(DIT, num_layers=3, patch_size=2)
STOCHASTIC = ("euler_ancestral", "ddpm", "simple_ddpm")


def assert_close(out, ref, tol, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, f"{what}: shape {out.shape} vs {ref.shape}"
    err, bound = np.abs(out - ref).max(), tol * max(1.0, np.abs(ref).max())
    assert err <= bound, f"{what}: max error {err:.3g} above {bound:.3g}"


# --- the pipelines --------------------------------------------------------------------

def _config(dit, conditional):
    # v-prediction: a random eps model's x0 divides by signal ~ 0 near t = T
    # and clips every sample; the output projection at a tenth keeps the
    # trajectories inside the clip
    return {"model": {"name": "simple_dit", **dit},
            "schedule": {"name": "cosine", "timesteps": 100}, "predictor": "v_prediction"}


@functools.cache
def pipelines(dit_key: str, conditional: bool):
    """(JAX pipeline, port pipeline) over one seeded numpy tree."""
    dit = {"dit": DIT, "dit3": DIT3}[dit_key]
    enc = JaxHash.create(features=TEXT, max_length=TEXT_LEN) if conditional else None
    ctx = np.zeros((1, TEXT_LEN, TEXT), np.float32) if conditional else None
    jm = JaxDiT(**dit)
    tree = flax_leaves(jm, 41 + len(dit_key) + conditional, np.zeros((1, RES, RES, CH), np.float32),
                       np.zeros((1,), np.float32), ctx)
    tree["final_proj"] = jax.tree_util.tree_map(lambda a: a * 0.1, tree["final_proj"])
    jpipe = JaxPipeline.from_config(_config(dit, conditional), params={"params": tree})
    config = _config(dit, conditional)
    config["model"] = dict(config["model"], in_channels=CH)
    table = None
    if conditional:
        jpipe.input_config = JaxInputConfig(sample_data_key="sample",
                                            sample_data_shape=(RES, RES, CH),
                                            conditions=[JaxConditional(encoder=enc)])
        config["input_config"] = jpipe.input_config.serialize()
        table = np.asarray(enc.model.table)
    tm = SimpleDiT(**dit, in_channels=CH, context_dim=TEXT if conditional else None,
                   device="cpu")
    params = convert.state_dict_from_flax(tm, tree)
    pipe = DiffusionInferencePipeline.from_config(config, params, hash_table=table, device="cpu")
    return jpipe, pipe


def jax_noise(req):
    """The JAX engine's draws for one request, in the port's order: the
    initial noise (`noise_key`), then each step's sampler noise from the
    loop key's split (stochastic samplers only)."""
    rng = RngSeq.create(req.seed)
    rng, noise_key = rng.next_key()
    rng, key = rng.next_key()
    shape = (req.num_samples, req.resolution, req.resolution, req.channels)
    draws = [jax.random.normal(noise_key, shape)]
    for _ in range(req.diffusion_steps):
        key, sub = jax.random.split(key)
        if req.sampler in STOCHASTIC:
            draws.append(jax.random.normal(sub, shape))
    return GivenNoise([np.array(d) for d in draws])


def _fields(req):
    return {k: getattr(req, k) for k in ("num_samples", "resolution", "diffusion_steps",
                                         "sampler", "guidance_scale", "seed", "prompts",
                                         "channels", "use_ema", "cache_plan")}


def serve(sched, reqs, start=True):
    futs = [sched.submit(r) for r in reqs]
    if start:
        sched.start()
    outs = [f.result(timeout=300) for f in futs]
    sched.close()
    return outs


REQ = dict(resolution=RES, channels=CH, use_ema=False)
SCENARIOS = {
    # mixed NFE, a padding row (3 rows in bucket 4), chunks of 2, a stochastic
    # and a deterministic sampler
    "mixed": (("dit", False), dict(round_steps=2, batch_buckets=(4,)),
              [dict(diffusion_steps=3, sampler="euler_ancestral", seed=7),
               dict(diffusion_steps=5, sampler="euler_ancestral", seed=11),
               dict(diffusion_steps=4, sampler="ddim", seed=3)]),
    # multistep DPM's history across chunk boundaries; the 3-step request
    # finishes first, the 5-step one rides on alone
    "multistep": (("dit", False), dict(round_steps=2, batch_buckets=(1, 2)),
                  [dict(diffusion_steps=5, sampler="multistep_dpm", seed=13),
                   dict(diffusion_steps=3, sampler="multistep_dpm", seed=17)]),
    "cfg": (("dit", True), dict(round_steps=2, batch_buckets=(1, 2)),
            [dict(diffusion_steps=3, sampler="ddim", guidance_scale=2.0, seed=21,
                  prompts=["a red flower"]),
             dict(diffusion_steps=3, sampler="ddim", guidance_scale=2.0, seed=22,
                  prompts=["blue sky"])]),
    "cached": (("dit3", False), dict(round_steps=3, batch_buckets=(2,)),
               [dict(diffusion_steps=6, sampler="ddim", seed=31, plan="cache"),
                dict(diffusion_steps=4, sampler="ddim", seed=32, plan="cache")]),
    "composed": (("dit3", False), dict(round_steps=3, batch_buckets=(2,)),
                 [dict(diffusion_steps=6, sampler="ddim", seed=33, plan="composed"),
                  dict(diffusion_steps=6, sampler="euler_ancestral", seed=34,
                       plan="composed")]),
}
PLANS = {"cache": (jdc.CachePlan(refresh_every=2, depth_fraction=0.4),
                   tdc.CachePlan(refresh_every=2, depth_fraction=0.4)),
         "composed": (jsc.ComposedPlan(jdc.CachePlan(refresh_every=3, depth_fraction=0.4),
                                       jsc.SpatialPlan(keep_fraction=0.5)),
                      tsc.ComposedPlan(tdc.CachePlan(refresh_every=3, depth_fraction=0.4),
                                       tsc.SpatialPlan(keep_fraction=0.5)))}


def _requests(kinds, side):
    out = []
    for kw in kinds:
        kw = dict(kw)
        plan = kw.pop("plan", None)
        cls = JaxRequest if side == "jax" else SampleRequest
        if plan is not None:
            kw["cache_plan"] = PLANS[plan][side == "port"]
        out.append(cls(**REQ, **kw))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_matches_jax(name):
    """The JAX scheduler and the port's serve the same requests within TOL,
    the port fed the JAX draws; both count the same rounds."""
    (dit, conditional), cfg, kinds = SCENARIOS[name]
    if name == "composed":
        # the second request's sampler joins another group: keep one group
        kinds = [dict(k, sampler="ddim") for k in kinds]
    jpipe, pipe = pipelines(dit, conditional)
    jtel, tel = JaxTelemetry(enabled=False), Telemetry()
    jreqs, reqs = _requests(kinds, "jax"), _requests(kinds, "port")
    jouts = serve(JaxScheduler(pipeline=jpipe, telemetry=jtel, autostart=False,
                               config=JaxConfig(**cfg)), jreqs)
    outs = serve(ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False,
                                  config=SchedulerConfig(**cfg), noise_factory=jax_noise), reqs)
    for r, o, j in zip(reqs, outs, jouts):
        assert o.rounds == j.rounds
        assert_close(o.samples, np.asarray(j.samples), TOL, f"{name} seed {r.seed}")
    assert (np.abs(np.asarray(jouts[0].samples)) < 1.0).mean() > 0.5, "samples clipped"
    names = ["serving/rounds", "serving/rows_real", "serving/rows_padded",
             "serving/cache_refresh_steps", "serving/cache_reused_steps",
             "serving/spatial_steps"]
    jsnap, snap = jtel.registry.snapshot(), tel.registry.snapshot()
    assert {n: snap.get(n) for n in names} == {n: jsnap.get(n) for n in names}


def test_workload_equals_jax():
    mix = [{"resolution": 8, "diffusion_steps": 4, "sampler": "ddim"},
           {"resolution": 8, "diffusion_steps": 8, "sampler": "euler_ancestral"}]
    for seed in (0, 99):
        ours = build_workload(PoissonWorkloadSpec(n_requests=24, rate_hz=8.0, seed=seed, mix=mix))
        ref = jax_build_workload(JaxSpec(n_requests=24, rate_hz=8.0, seed=seed, mix=mix))
        assert [t for t, _ in ours] == [t for t, _ in ref]
        assert [_fields(r) for _, r in ours] == [_fields(r) for _, r in ref]


# --- the port alone: batched against solo ---------------------------------------------

def _solo(pipe, r):
    return pipe.generate_samples(num_samples=r.num_samples, resolution=r.resolution,
                                 channels=r.channels, diffusion_steps=r.diffusion_steps,
                                 sampler=r.sampler, seed=r.seed, use_ema=False,
                                 guidance_scale=r.guidance_scale, prompts=r.prompts,
                                 cache_plan=r.cache_plan)


def _alone(pipe, r, cfg):
    return serve(ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                                  config=SchedulerConfig(**cfg)), [r])[0].samples


@pytest.mark.parametrize("name", ["mixed", "multistep", "cfg", "composed"])
def test_batched_equals_alone_in_its_bucket_and_solo(name):
    """Each request, batched with the others (padded, chunked, admitted at
    different offsets), is bit for bit the same request served alone in the
    same bucket, and within SOLO_TOL of the solo generate_samples."""
    (dit, conditional), cfg, kinds = SCENARIOS[name]
    _, pipe = pipelines(dit, conditional)
    reqs = _requests(kinds, "port")
    # one bucket, so that every round of a request runs at the same batch
    bucket = dict(cfg, batch_buckets=(max(cfg["batch_buckets"]),))
    outs = serve(ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                                  config=SchedulerConfig(**bucket)), reqs)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o.samples, _alone(pipe, r, bucket))
        assert_close(o.samples, _solo(pipe, r), SOLO_TOL, f"{name} seed {r.seed}")


@pytest.mark.parametrize("name", ["mixed", "cfg", "composed"])
def test_request_alone_in_bucket_one_is_solo_bit_for_bit(name):
    """At the solo batch every row computes what generate_samples computes."""
    (dit, conditional), cfg, kinds = SCENARIOS[name]
    _, pipe = pipelines(dit, conditional)
    r = _requests(kinds, "port")[-1]
    np.testing.assert_array_equal(_alone(pipe, r, dict(cfg, batch_buckets=(1,))),
                                  _solo(pipe, r))


def test_padding_rows_and_dead_steps_leave_the_generator_alone():
    """A padding row and the steps past a row's last draw nothing: the row's
    generator ends where its solo trajectory leaves it."""
    _, pipe = pipelines("dit", False)
    gens = {}

    def factory(req):
        from flaxdiff_tpu_torch.samplers import NoiseSource
        gens[req.seed] = torch.Generator().manual_seed(req.seed)
        return NoiseSource(gens[req.seed])

    reqs = _requests(SCENARIOS["mixed"][2], "port")
    serve(ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                           noise_factory=factory,
                           config=SchedulerConfig(round_steps=4, batch_buckets=(4,))), reqs)
    for r in reqs:
        solo = torch.Generator().manual_seed(r.seed)
        from flaxdiff_tpu_torch.samplers import DiffusionSampler  # noqa: F401
        pipe.get_sampler(r.sampler).generate_samples(
            num_samples=1, resolution=RES, channels=CH, diffusion_steps=r.diffusion_steps,
            generator=solo)
        assert torch.equal(gens[r.seed].get_state(), solo.get_state()), r.sampler


def test_warm_replay_builds_no_program_and_repeats_bits():
    _, pipe = pipelines("dit", False)
    tel = Telemetry()
    sched = ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False,
                             config=SchedulerConfig(round_steps=2, batch_buckets=(1, 2)))
    spec = PoissonWorkloadSpec(n_requests=6, rate_hz=400.0, seed=5, mix=[
        {"resolution": RES, "channels": CH, "diffusion_steps": 3, "sampler": "ddim",
         "use_ema": False},
        {"resolution": RES, "channels": CH, "diffusion_steps": 5, "sampler": "euler_ancestral",
         "use_ema": False}])
    work = build_workload(spec)
    protos = [r for _, r in work[:1]] + [next(r for _, r in work if r.sampler != work[0][1].sampler)]
    warm = sched.prewarm(protos)
    assert warm["programs"] > 0
    sched.start()
    misses = tel.counter("serving/program_cache_misses").value
    runs = []
    for _ in range(2):
        futs = [sched.submit(r) for _, r in work]
        runs.append([f.result(timeout=120) for f in futs])
    sched.close()
    assert tel.counter("serving/program_cache_misses").value == misses
    assert tel.counter("serving/program_cache_hits").value > 0
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.samples, b.samples)
    assert tel.gauge("serving/prewarm_ms").value > 0


def test_a_model_without_the_cache_contract_drops_the_plan_and_counts():
    """The 1-layer DiT cannot split at the plan's depth: the request runs
    uncached, bit for bit the plain one, counted at serving/cache_unsupported."""
    _, pipe = pipelines("dit", False)
    tel = Telemetry()
    kw = dict(REQ, diffusion_steps=3, sampler="ddim", seed=5)
    plain = _alone(pipe, SampleRequest(**kw), dict(round_steps=2, batch_buckets=(1,)))
    out = serve(ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False,
                                 config=SchedulerConfig(round_steps=2, batch_buckets=(1,))),
                [SampleRequest(**kw, cache_plan=tdc.DEFAULT_CACHE_PLAN)])[0]
    np.testing.assert_array_equal(out.samples, plain)
    assert tel.counter("serving/cache_unsupported").value > 0


def test_plan_parallelism_names_its_roadmap_item():
    from flaxdiff_tpu_torch.serving import SamplerProgramEngine
    _, pipe = pipelines("dit", False)
    with pytest.raises(NotImplementedError, match="A12"):
        SamplerProgramEngine(pipe, telemetry=Telemetry()).plan_parallelism()


# --- scheduler mechanics on a fake engine ---------------------------------------------

class FakeEngine:
    """Deterministic torch-free engine: result rows are f(seed); advance
    moves each row min(remaining, round_steps); per-call counters let
    tests assert what compute was (not) spent."""

    def __init__(self, step_delay_s: float = 0.0):
        self.prepared = []
        self.advance_calls = []
        self.finalize_calls = []
        self.step_delay_s = step_delay_s
        self.telemetry = Telemetry()

    def group_key(self, req):
        return (req.resolution, req.sampler, req.num_samples)

    def prepare(self, req, future, submit_t, admit_t):
        st = RequestState(req=req, future=future, submit_t=submit_t,
                          admit_t=admit_t, group=self.group_key(req),
                          x=None, rng=None, state=None, pairs=None,
                          terminal_t=0.0, cond=None, uncond=None)
        self.prepared.append(req)
        return st

    def advance(self, rows, bucket, round_steps):
        self.advance_calls.append((len(rows), bucket, round_steps))
        if self.step_delay_s:
            time.sleep(self.step_delay_s)
        finished = []
        for r in rows:
            r.done += min(r.remaining, round_steps)
            r.rounds += 1
            if r.remaining <= 0:
                finished.append(r)
        return finished, 0.0

    def finalize(self, rows, bucket):
        self.finalize_calls.append((len(rows), bucket))
        out = np.stack([np.full((r.req.num_samples, 2, 2, 1), float(r.req.seed)) for r in rows])
        return out, 0.0


def fake_scheduler(tel=None, **cfg_kwargs):
    eng = FakeEngine()
    tel = tel or Telemetry()
    cfg = SchedulerConfig(**{"round_steps": 4, "batch_buckets": (1, 2, 4), **cfg_kwargs})
    return eng, ServingScheduler(engine=eng, config=cfg, telemetry=tel, autostart=False)


def test_bucket_helpers():
    assert bucket_up(1, (1, 2, 4)) == 1
    assert bucket_up(3, (1, 2, 4)) == 4
    assert bucket_up(9, (1, 2, 4)) == 4      # capped at max bucket
    assert nfe_bucket(1) == 1
    assert nfe_bucket(5) == 8
    assert nfe_bucket(64) == 64


def test_request_validation():
    with pytest.raises(ValueError, match="diffusion_steps"):
        SampleRequest(diffusion_steps=0)
    r = SampleRequest(prompts=["a", "b", "c"])
    assert r.num_samples == 3                # prompts drive the block


def test_scheduler_completes_all_and_routes_results():
    tel = Telemetry()
    eng, sched = fake_scheduler(tel)
    reqs = [SampleRequest(resolution=8, diffusion_steps=3 + (i % 3),
                          sampler=("ddim", "euler")[i % 2], seed=100 + i) for i in range(10)]
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    outs = [f.result(timeout=10) for f in futs]
    sched.close()
    for r, o in zip(reqs, outs):
        assert np.all(o.samples == float(r.seed))
        assert o.samples.shape == (1, 2, 2, 1)
        assert o.rounds >= 1 and o.latency_ms >= o.queue_ms
    snap = tel.registry.snapshot()
    assert snap["serving/requests_in"] == 10 and snap["serving/requests_ok"] == 10
    assert snap.get("serving/shed", 0) == 0 and snap["serving/rows_real"] >= 10


def test_heterogeneous_nfe_exits_early():
    eng, sched = fake_scheduler(round_steps=2)
    short = sched.submit(SampleRequest(resolution=8, diffusion_steps=2, sampler="ddim", seed=1))
    long = sched.submit(SampleRequest(resolution=8, diffusion_steps=8, sampler="ddim", seed=2))
    sched.start()
    r_short, r_long = short.result(timeout=10), long.result(timeout=10)
    sched.close()
    assert r_short.rounds == 1 and r_long.rounds == 4
    assert eng.advance_calls[0][0] == 2


def test_deadline_shed_before_compute():
    eng, sched = fake_scheduler()
    doomed = sched.submit(SampleRequest(resolution=8, diffusion_steps=4, deadline_s=0.0))
    time.sleep(0.01)
    ok = sched.submit(SampleRequest(resolution=8, diffusion_steps=4, seed=5))
    sched.start()
    assert np.all(ok.result(timeout=10).samples == 5.0)
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=10)
    sched.close()
    assert all(r.deadline_s is None for r in eng.prepared)
    assert sched.telemetry.counter("serving/shed").value == 1


def test_queue_full_sheds_at_the_door():
    eng, sched = fake_scheduler(max_queue=1)
    keep = sched.submit(SampleRequest(resolution=8, diffusion_steps=2))
    reject = sched.submit(SampleRequest(resolution=8, diffusion_steps=2))
    with pytest.raises(DeadlineExceeded, match="queue full"):
        reject.result(timeout=1)
    sched.start()
    keep.result(timeout=10)
    sched.close()
    assert sched.telemetry.counter("serving/shed").value == 1


def test_midflight_deadline_shed_at_round_boundary():
    eng = FakeEngine(step_delay_s=0.03)
    tel = Telemetry()
    sched = ServingScheduler(engine=eng, telemetry=tel, autostart=False,
                             config=SchedulerConfig(round_steps=1, batch_buckets=(1, 2)))
    doomed = sched.submit(SampleRequest(resolution=8, diffusion_steps=8, sampler="ddim",
                                        deadline_s=0.05))
    ok = sched.submit(SampleRequest(resolution=8, diffusion_steps=8, sampler="ddim", seed=9))
    sched.start()
    assert np.all(ok.result(timeout=20).samples == 9.0)
    with pytest.raises(DeadlineExceeded, match="mid-flight"):
        doomed.result(timeout=20)
    sched.close()
    snap = tel.registry.snapshot()
    assert snap["serving/shed_midflight"] == 1 and snap["serving/shed"] == 1
    assert any(r.deadline_s is not None for r in eng.prepared)


def test_dispatch_thread_death_fails_all_futures(monkeypatch):
    eng, sched = fake_scheduler()
    futs = [sched.submit(SampleRequest(resolution=8, diffusion_steps=4, seed=i))
            for i in range(3)]
    monkeypatch.setattr(sched, "_pick_group_locked",
                        lambda: (_ for _ in ()).throw(RuntimeError("scheduler bug")))
    sched.start()
    for f in futs:
        with pytest.raises(ServingFault) as ei:
            f.result(timeout=10)
        assert ei.value.kind == "scheduler_died"
    with pytest.raises(SchedulerClosed):
        sched.submit(SampleRequest(resolution=8)).result(timeout=5)
    sched.close(drain=False)


def test_submit_after_close_and_drain():
    eng, sched = fake_scheduler()
    futs = [sched.submit(SampleRequest(resolution=8, diffusion_steps=4, seed=i))
            for i in range(3)]
    sched.start()
    sched.close(drain=True)
    for f in futs:
        assert f.result(timeout=1) is not None
    with pytest.raises(SchedulerClosed):
        sched.submit(SampleRequest(resolution=8)).result(timeout=1)


def test_close_without_drain_cancels():
    eng, sched = fake_scheduler()
    futs = [sched.submit(SampleRequest(resolution=8, diffusion_steps=4)) for _ in range(4)]
    sched.close(drain=False)
    sched.start()
    for f in futs:
        with pytest.raises(SchedulerClosed):
            f.result(timeout=1)


def _count_seams(monkeypatch):
    blocks, gets = [], []
    real_block, real_get = sched_mod._block_until_ready, sched_mod._device_get
    monkeypatch.setattr(sched_mod, "_block_until_ready",
                        lambda x: (blocks.append(1), real_block(x))[1])
    monkeypatch.setattr(sched_mod, "_device_get", lambda x: (gets.append(1), real_get(x))[1])
    return blocks, gets


def test_completion_sync_seams_counted(monkeypatch):
    """One completed batch costs exactly one _block_until_ready and one
    _device_get; the dispatch loop itself never syncs."""
    blocks, gets = _count_seams(monkeypatch)
    eng, sched = fake_scheduler(round_steps=16)
    futs = [sched.submit(SampleRequest(resolution=8, diffusion_steps=4, sampler="ddim", seed=i))
            for i in range(3)]
    sched.start()
    for f in futs:
        f.result(timeout=10)
    sched.close()
    assert len(blocks) == 1 and len(gets) == 1


def test_real_engine_seams_counted(monkeypatch):
    """The same count on the real engine: one batch of three, one round."""
    blocks, gets = _count_seams(monkeypatch)
    _, pipe = pipelines("dit", False)
    reqs = [SampleRequest(**REQ, diffusion_steps=3, sampler="ddim", seed=s) for s in (1, 2, 3)]
    serve(ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                           config=SchedulerConfig(round_steps=4, batch_buckets=(4,))), reqs)
    assert len(blocks) == 1 and len(gets) == 1


def test_backpressure_bounds_inflight(monkeypatch):
    real_block = sched_mod._block_until_ready

    def slow_block(x):
        time.sleep(0.05)
        return real_block(x)

    monkeypatch.setattr(sched_mod, "_block_until_ready", slow_block)
    tel = Telemetry()
    sched = ServingScheduler(engine=FakeEngine(), telemetry=tel, autostart=False,
                             config=SchedulerConfig(round_steps=8, batch_buckets=(1,),
                                                    max_inflight=1))
    futs = [sched.submit(SampleRequest(resolution=8, diffusion_steps=4, seed=i))
            for i in range(6)]
    sched.start()
    for f in futs:
        f.result(timeout=20)
    sched.close()
    assert tel.counter("serving/backpressure_waits").value > 0
    assert tel.registry.snapshot()["serving/requests_ok"] == 6


def test_replay_with_fake_engine():
    eng, sched = fake_scheduler()
    sched.start()
    spec = PoissonWorkloadSpec(n_requests=12, rate_hz=200.0, seed=3,
                               mix=[{"resolution": 8, "diffusion_steps": 4},
                                    {"resolution": 8, "diffusion_steps": 8}])
    summary = replay(sched, build_workload(spec), timeout_s=20)
    sched.close()
    assert summary["completed"] == 12 and summary["shed"] == 0
    assert summary["latency_ms"]["p99"] >= summary["latency_ms"]["p50"]
    assert summary["throughput_rps"] > 0


def test_thread_safe_submit():
    eng, sched = fake_scheduler(max_queue=512)
    sched.start()
    futs, lock = [], threading.Lock()

    def blast(base):
        mine = [sched.submit(SampleRequest(resolution=8, diffusion_steps=4, seed=base + i))
                for i in range(20)]
        with lock:
            futs.extend(mine)

    threads = [threading.Thread(target=blast, args=(1000 * t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    results = [f.result(timeout=20) for f in futs]
    sched.close()
    assert len(results) == 80
    assert {float(r.samples.flat[0]) for r in results} == {float(r.request.seed)
                                                          for r in results}


def test_workload_deterministic():
    spec = PoissonWorkloadSpec(n_requests=16, rate_hz=8.0, seed=99,
                               mix=[{"resolution": 8, "diffusion_steps": 4},
                                    {"resolution": 8, "diffusion_steps": 8}])
    w1, w2 = build_workload(spec), build_workload(spec)
    assert [(t, r.seed, r.diffusion_steps) for t, r in w1] == \
        [(t, r.seed, r.diffusion_steps) for t, r in w2]
    ts = [t for t, _ in w1]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    assert {r.diffusion_steps for _, r in w1} == {4, 8}
