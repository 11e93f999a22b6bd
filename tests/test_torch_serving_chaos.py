"""The port's serving resilience under injected faults, on the CPU (the
JAX package's ``tests/test_serving_chaos.py`` cases, and its request-trace
cases of ``tests/test_reqtrace.py``).

- under injected round / fetch / device faults no future is stranded:
  each resolves with a result, `DeadlineExceeded`, `SchedulerClosed`, or a
  typed `ServingFault`;
- retried completions are bit-identical to fault-free runs (deterministic
  replay from the request's seed);
- a rebuilt engine serves prewarmed traffic without building a program;
  a rebuild that fails (a sticky CUDA error) fails every future typed;
- the healthy path, traced or not, performs the same seam-counted host
  syncs.

Mechanics run on the torch-free `FakeEngine` of `test_torch_serving`; the
bit-identity, rebuild and trace bars on the port's tiny pipeline.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from flaxdiff_tpu_torch import resilience as R
from flaxdiff_tpu_torch.serving import (BrownoutConfig, DeviceLost,
                                  SampleRequest, SchedulerClosed,
                                  SchedulerConfig, ServingFault,
                                  ServingScheduler, classify)
from flaxdiff_tpu_torch.serving import scheduler as sched_mod
from flaxdiff_tpu_torch.telemetry.reqtrace import RequestTracer
from flaxdiff_tpu_torch.telemetry import JsonlExporter, Telemetry, TraceRecorder
from test_torch_serving import REQ, FakeEngine, _solo, pipelines
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.chaos


def _sched(tel=None, engine=None, engine_factory=None, **cfg_kwargs):
    eng = engine or FakeEngine()
    tel = tel or Telemetry(enabled=False)
    cfg_kwargs = {"round_steps": 16, "batch_buckets": (4,),
                  **cfg_kwargs}
    cfg = SchedulerConfig(**cfg_kwargs)
    return eng, ServingScheduler(engine=eng, config=cfg, telemetry=tel,
                                 autostart=False,
                                 engine_factory=engine_factory)


def _reqs(n, nfe=4, base_seed=100):
    return [SampleRequest(resolution=8, diffusion_steps=nfe,
                          sampler="ddim", seed=base_seed + i)
            for i in range(n)]


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------

def test_classify_taxonomy():
    assert classify(DeviceLost("chip gone")) == "device_lost"
    assert classify(R.InjectedFault("io blip")) == "transient"
    assert classify(OSError("reset")) == "transient"
    assert classify(ValueError("bad shape")) == "fatal"
    assert classify(R.InjectedHTTPError(404)) == "fatal"


# ---------------------------------------------------------------------------
# round faults: transient retry, poisoned-row conviction, exhaustion
# ---------------------------------------------------------------------------

def test_transient_round_fault_retries_all():
    """A one-shot round fault convicts nobody: the whole batch
    requeues with bounded attempts and completes bit-identically;
    the trace rows attribute the recovery."""
    tel = Telemetry(recorder=TraceRecorder())
    eng, sched = _sched(tel)
    reqs = _reqs(4)
    plan = R.FaultPlan([R.FaultSpec("serving.round", at=(1,), times=1)],
                       seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in reqs]
        sched.start()
        outs = [f.result(timeout=20) for f in futs]
        sched.close()
    for r, o in zip(reqs, outs):
        assert np.all(o.samples == float(r.seed))
        assert o.attempts == 1          # one failed round, one replay
    snap = tel.registry.snapshot()
    assert snap["serving/round_faults"] == 1
    assert snap["serving/requeued"] == 4
    assert snap.get("serving/quarantined", 0) == 0
    # binary search probed both halves, neither reproduced the fault
    assert snap["serving/probe_rounds"] == 2
    traces = tel.records("request_trace")
    assert len(traces) == 4
    for t in traces:
        assert t["outcome"] == "ok" and t["attempts"] == 1
        kinds = [e["event"] for e in t["recovery"]]
        assert kinds == ["round_fault", "requeued"]


def test_poisoned_request_quarantined_others_complete():
    """A deterministically failing request is convicted by the
    binary-search solo re-run and fails typed; its round-mates are
    innocent and complete."""
    tel = Telemetry(enabled=False)
    eng, sched = _sched(tel)
    reqs = _reqs(4, base_seed=5)        # seeds 5, 6, 7, 8
    plan = R.FaultPlan([R.FaultSpec("serving.round", per_key=True,
                                    match="seed:7:", prob=1.0)], seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in reqs]
        sched.start()
        results = {}
        for r, f in zip(reqs, futs):
            try:
                results[r.seed] = f.result(timeout=20)
            except ServingFault as e:
                results[r.seed] = e
        sched.close()
    assert isinstance(results[7], ServingFault)
    assert results[7].kind == "poisoned"
    for seed in (5, 6, 8):
        assert np.all(results[seed].samples == float(seed))
    snap = tel.registry.snapshot()
    assert snap["serving/quarantined"] == 1
    assert snap["serving/requeued"] == 3


def test_fetch_fault_retries_then_exhausts():
    """Completion-fetch faults requeue the batch; a persistent one
    burns the bounded budget and fails typed — never a hang."""
    tel = Telemetry(enabled=False)
    eng, sched = _sched(tel)
    plan = R.FaultPlan([R.FaultSpec("serving.fetch",
                                    at=tuple(range(1, 50)))], seed=0)
    with plan.installed():
        fut = sched.submit(_reqs(1)[0])
        sched.start()
        with pytest.raises(ServingFault) as ei:
            fut.result(timeout=20)
        sched.close()
    assert ei.value.kind == "retries_exhausted"
    assert ei.value.attempts == 3       # default RetryPolicy budget
    snap = tel.registry.snapshot()
    assert snap["serving/fetch_faults"] == 3
    assert snap["serving/retries_exhausted"] == 1
    assert snap["serving/requeued"] == 2


def test_fetch_fault_transient_recovers():
    tel = Telemetry(enabled=False)
    eng, sched = _sched(tel)
    plan = R.FaultPlan([R.FaultSpec("serving.fetch", at=(1,), times=1)],
                       seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in _reqs(2)]
        sched.start()
        outs = [f.result(timeout=20) for f in futs]
        sched.close()
    assert all(o.attempts == 1 for o in outs)
    snap = tel.registry.snapshot()
    assert snap["serving/fetch_faults"] == 1
    assert snap["serving/requests_ok"] == 2


# ---------------------------------------------------------------------------
# device loss: supervised rebuild
# ---------------------------------------------------------------------------

def test_device_lost_rebuilds_engine_and_requeues():
    tel = Telemetry(enabled=False)
    e1 = FakeEngine()
    rebuilt = []

    def factory():
        e = FakeEngine()
        rebuilt.append(e)
        return e

    eng, sched = _sched(tel, engine=e1, engine_factory=factory)
    plan = R.FaultPlan([R.FaultSpec("serving.device_lost", at=(1,),
                                    times=1, error="flag")], seed=0)
    reqs = _reqs(3)
    with plan.installed():
        futs = [sched.submit(r) for r in reqs]
        sched.start()
        outs = [f.result(timeout=20) for f in futs]
        sched.close()
    assert rebuilt and sched.engine is rebuilt[-1]
    for r, o in zip(reqs, outs):
        assert np.all(o.samples == float(r.seed))
        assert o.attempts == 0          # rebuild requeue is unpenalized
    snap = tel.registry.snapshot()
    assert snap["serving/device_lost"] == 1
    assert snap["serving/supervisor_rebuilds"] == 1
    assert snap["serving/supervisor_state"] == 0      # back to SERVING


def test_device_lost_without_factory_fails_typed():
    tel = Telemetry(enabled=False)
    eng, sched = _sched(tel)            # explicit engine, no factory
    plan = R.FaultPlan([R.FaultSpec("serving.device_lost", at=(1,),
                                    times=1, error="flag")], seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in _reqs(2)]
        sched.start()
        for f in futs:
            with pytest.raises(ServingFault) as ei:
                f.result(timeout=20)
            assert ei.value.kind == "device_lost"
        sched.close()
    assert tel.registry.snapshot().get("serving/supervisor_rebuilds",
                                       0) == 0


# ---------------------------------------------------------------------------
# brownout degradation
# ---------------------------------------------------------------------------

def test_brownout_caps_nfe_under_queue_pressure():
    tel = Telemetry(enabled=False)
    eng, sched = _sched(
        tel, max_queue=10,
        brownout=BrownoutConfig(queue_soft=0.2, queue_heavy=2.0,
                                queue_critical=2.0, nfe_cap=4,
                                force_plan=None))
    reqs = [SampleRequest(resolution=8, diffusion_steps=16,
                          sampler="ddim", seed=200 + i)
            for i in range(8)]
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    outs = [f.result(timeout=20) for f in futs]
    sched.close()
    degraded = [o for o in outs if o.degraded]
    assert degraded, "queue pressure should have degraded admissions"
    for o in degraded:
        assert o.degraded == ("nfe_capped",)
        assert o.request.diffusion_steps == 4       # effective request
    # early submits saw an empty queue and kept their full NFE
    assert any(o.request.diffusion_steps == 16 for o in outs)
    snap = tel.registry.snapshot()
    assert snap["serving/brownout_requests"] == len(degraded)
    assert snap["serving/brownout_nfe_capped"] == len(degraded)


def test_brownout_critical_shrinks_batch_buckets():
    tel = Telemetry(enabled=False)
    eng, sched = _sched(
        tel, max_queue=10, batch_buckets=(1, 2, 4),
        brownout=BrownoutConfig(queue_soft=2.0, queue_heavy=2.0,
                                queue_critical=0.3, nfe_cap=0,
                                force_plan=None))
    futs = [sched.submit(r) for r in _reqs(8)]
    sched.start()
    for f in futs:
        f.result(timeout=20)
    sched.close()
    # the first round ran under tier 3: smallest bucket, not 4
    assert eng.advance_calls[0][1] == 1
    assert tel.registry.snapshot()["serving/brownout_bucket_shrunk"] >= 1


def test_fault_raises_brownout_floor():
    """A round fault keeps the tier at the floor for the cooldown even
    with an empty queue — degrade while provably unhealthy."""
    tel = Telemetry(enabled=False)
    eng, sched = _sched(
        tel, brownout=BrownoutConfig(nfe_cap=4, force_plan=None,
                                     fault_cooldown_s=30.0))
    plan = R.FaultPlan([R.FaultSpec("serving.round", at=(1,), times=1)],
                       seed=0)
    with plan.installed():
        first = sched.submit(SampleRequest(resolution=8,
                                           diffusion_steps=16,
                                           sampler="ddim", seed=1))
        sched.start()
        assert first.result(timeout=20).attempts == 1
        # submitted AFTER the fault: queue empty, but the fault floor
        # holds tier >= 1 -> NFE capped
        later = sched.submit(SampleRequest(resolution=8,
                                           diffusion_steps=16,
                                           sampler="ddim", seed=2))
        out = later.result(timeout=20)
        sched.close()
    assert out.degraded == ("nfe_capped",)


# ---------------------------------------------------------------------------
# close() racing an active supervised rebuild 
# ---------------------------------------------------------------------------

def _rebuild_race(drain):
    """Drive the scheduler into `EngineSupervisor.rebuild()` (factory
    blocked on a gate), call close() from another thread mid-rebuild,
    release the gate, and return (futures, close_thread)."""
    tel = Telemetry(enabled=False)
    gate, entered = threading.Event(), threading.Event()

    def factory():
        entered.set()
        assert gate.wait(20), "close() must not cancel the rebuild gate"
        return FakeEngine()

    eng, sched = _sched(tel, engine=FakeEngine(), engine_factory=factory)
    plan = R.FaultPlan([R.FaultSpec("serving.device_lost", at=(1,),
                                    times=1, error="flag")], seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in _reqs(3)]
        sched.start()
        assert entered.wait(20)         # dispatch thread is mid-rebuild
        closer = threading.Thread(
            target=lambda: sched.close(drain=drain, timeout=30))
        closer.start()
        time.sleep(0.1)                 # close's sweep runs first
        gate.set()                      # rebuild lands, requeue follows
        closer.join(30)
    assert not closer.is_alive(), "close() hung against the rebuild"
    return futs


def test_close_nondraining_races_rebuild_resolves_all():
    """The stranding race: a non-draining close sweeps the queue while
    the rebuild holds the interrupted rows in a local list — the
    post-rebuild requeue must RESOLVE those futures (SchedulerClosed),
    not re-enter them into a queue nothing will ever serve."""
    futs = _rebuild_race(drain=False)
    for f in futs:
        with pytest.raises(SchedulerClosed):
            f.result(timeout=10)        # resolves; never hangs


def test_close_draining_races_rebuild_completes_all():
    """A DRAINING close during the rebuild lets the rebuilt engine
    serve the interrupted requests to completion, unpenalized."""
    futs = _rebuild_race(drain=True)
    outs = [f.result(timeout=10) for f in futs]
    for o in outs:
        assert np.all(o.samples == float(o.request.seed))
        assert o.attempts == 0          # rebuild requeue is unpenalized


# ---------------------------------------------------------------------------
# healthy path: sync parity with supervision active
# ---------------------------------------------------------------------------

def test_healthy_path_sync_parity(monkeypatch):
    """Supervision, brownout, and the armed-but-empty fault plan add
    ZERO host syncs to the healthy path: one completed batch still
    costs exactly one block_until_ready + one device_get (the
    counting-mock contract)."""
    blocks, gets = [], []
    real_block = sched_mod._block_until_ready
    real_get = sched_mod._device_get
    monkeypatch.setattr(sched_mod, "_block_until_ready",
                        lambda x: (blocks.append(1), real_block(x))[1])
    monkeypatch.setattr(sched_mod, "_device_get",
                        lambda x: (gets.append(1), real_get(x))[1])
    tel = Telemetry(enabled=False)
    eng, sched = _sched(tel)
    with R.FaultPlan([], seed=0).installed():     # armed, empty
        futs = [sched.submit(r) for r in _reqs(3)]
        sched.start()
        for f in futs:
            f.result(timeout=20)
        sched.close()
    assert len(blocks) == 1 and len(gets) == 1
    snap = tel.registry.snapshot()
    assert snap.get("serving/round_faults", 0) == 0
    assert snap.get("serving/requeued", 0) == 0


# ---------------------------------------------------------------------------
# real-engine acceptance: retried bit-identity + rebuilt-warm zero builds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pipe():
    return pipelines("dit", False)[1]


def _real_reqs():
    return [SampleRequest(**REQ, diffusion_steps=3, sampler="euler_ancestral", seed=7),
            SampleRequest(**REQ, diffusion_steps=5, sampler="euler_ancestral", seed=11)]


def _fault_free(pipe, reqs, **cfg):
    sched = ServingScheduler(pipeline=pipe, telemetry=Telemetry(), autostart=False,
                             config=SchedulerConfig(**cfg))
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    outs = [f.result(timeout=300) for f in futs]
    sched.close()
    return outs


def _assert_identical(pipe, reqs, outs, **cfg):
    for a, b in zip(_fault_free(pipe, reqs, **cfg), outs):
        np.testing.assert_array_equal(a.samples, b.samples)


def _assert_solo_identical(pipe, reqs, outs):
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o.samples, _solo(pipe, r))


def test_real_retried_results_bit_identical(tiny_pipe):
    """The retry acceptance bar, as the JAX test holds it: a faulted round's
    requests replay from scratch, and the retried completions (served in
    bucket 2) are bit-identical to fault-free solo generate_samples runs."""
    tel = Telemetry()
    cfg = dict(round_steps=2, batch_buckets=(2,))
    sched = ServingScheduler(pipeline=tiny_pipe, telemetry=tel, autostart=False,
                             config=SchedulerConfig(**cfg))
    reqs = _real_reqs()
    plan = R.FaultPlan([R.FaultSpec("serving.round", at=(1,), times=1)], seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in reqs]
        sched.start()
        outs = [f.result(timeout=300) for f in futs]
        sched.close()
    assert all(o.attempts == 1 for o in outs)
    _assert_solo_identical(tiny_pipe, reqs, outs)
    assert tel.registry.snapshot()["serving/round_faults"] == 1


def test_real_rebuilt_engine_serves_prewarmed_zero_builds(tiny_pipe):
    """After device loss the supervisor rebuilds the engine and replays
    prewarm: every program after the fault is built inside the rebuild,
    and results stay bit-identical."""
    tel = Telemetry()
    cfg = dict(round_steps=2, batch_buckets=(2,))
    sched = ServingScheduler(pipeline=tiny_pipe, telemetry=tel, autostart=False,
                             config=SchedulerConfig(**cfg))
    reqs = _real_reqs()
    sched.prewarm(reqs)
    snap0 = tel.registry.snapshot()
    plan = R.FaultPlan([R.FaultSpec("serving.device_lost", at=(1,), times=1, error="flag")],
                       seed=0)
    with plan.installed():
        futs = [sched.submit(r) for r in reqs]
        sched.start()
        outs = [f.result(timeout=300) for f in futs]
        sched.close()
    _assert_identical(tiny_pipe, reqs, outs, **cfg)
    snap = tel.registry.snapshot()
    assert snap["serving/supervisor_rebuilds"] == 1
    rebuild_prewarm = snap["serving/prewarm_programs"] - snap0["serving/prewarm_programs"]
    assert rebuild_prewarm > 0
    assert snap["serving/program_cache_misses"] - snap0["serving/program_cache_misses"] \
        == rebuild_prewarm


class StickyEngine(FakeEngine):
    """Every round raises what torch raises after an illegal address."""

    def advance(self, rows, bucket, round_steps):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_classify_sticky_cuda_errors_and_oom():
    assert classify(RuntimeError("CUDA error: an illegal memory access was encountered")) \
        == "device_lost"
    assert classify(RuntimeError("CUDA error: unspecified launch failure")) == "device_lost"
    assert classify(RuntimeError("CUDA error: device-side assert triggered")) == "device_lost"
    oom = getattr(torch.cuda, "OutOfMemoryError", RuntimeError)
    assert classify(oom("CUDA out of memory. Tried to allocate 2.00 GiB")) == "transient"
    assert classify(RuntimeError("shape mismatch")) == "transient"


def test_failed_rebuild_fails_every_future_typed():
    """A sticky error poisons the context: the rebuild fails too, and every
    pending future resolves with ServingFault(device_lost) instead of the
    scheduler looping; later submits are refused."""
    tel = Telemetry()

    def factory():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    eng, sched = _sched(tel, engine=StickyEngine(), engine_factory=factory, max_queue=64)
    futs = [sched.submit(r) for r in _reqs(6)]
    sched.start()
    for f in futs:
        with pytest.raises(ServingFault) as ei:
            f.result(timeout=20)
        assert ei.value.kind == "device_lost"
    assert sched.closed
    with pytest.raises(SchedulerClosed):
        sched.submit(_reqs(1)[0]).result(timeout=5)
    sched.close(drain=False)
    assert tel.registry.snapshot()["serving/device_lost"] == 1


# ---------------------------------------------------------------------------
# request tracing (the JAX package's tests/test_reqtrace.py)
# ---------------------------------------------------------------------------

def _trace_requests():
    return [SampleRequest(**REQ, diffusion_steps=n, sampler=s, seed=seed)
            for n, s, seed in ((3, "ddim", 1), (5, "ddim", 2), (4, "euler_ancestral", 3))]


def _run(sched, reqs):
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    return [f.result(timeout=300) for f in futs]


def test_traced_replay_reconciles_with_the_histograms(tiny_pipe, tmp_path):
    tel = Telemetry(recorder=TraceRecorder(str(tmp_path / "trace.json")),
                    exporters=[JsonlExporter(str(tmp_path / "telemetry.jsonl"))])
    sched = ServingScheduler(pipeline=tiny_pipe, telemetry=tel, autostart=False,
                             config=SchedulerConfig(round_steps=2, batch_buckets=(2,)))
    outs = _run(sched, _trace_requests())
    sched.close()
    tel.flush()
    recs = [json.loads(line) for line in open(tmp_path / "telemetry.jsonl", encoding="utf-8")]
    traces = [r for r in recs if r.get("type") == "request_trace"]
    assert len(traces) == len(outs)
    for t in traces:
        assert t["queue_ms"] + t["compile_ms"] + t["device_ms"] \
            == pytest.approx(t["latency_ms"], abs=0.51)
        assert t["rounds"] >= 1 and len(t["round_detail"]) == t["rounds"]
        for d in t["round_detail"]:
            assert d["kind"] == "chunk" and "key" in d and "bucket" in d
    for span, hist in (("latency_ms", "serving/latency_ms"), ("queue_ms", "serving/queue_ms"),
                       ("compile_ms", "serving/compile_ms"), ("device_ms", "serving/device_ms")):
        h = tel.registry.histogram(hist)
        assert h.count == len(traces)
        assert sum(t[span] for t in traces) == pytest.approx(h.total, abs=0.51 * len(traces))
    doc = json.load(open(tmp_path / "trace.json", encoding="utf-8"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"req.submit", "req.queue", "req.serve", "serve.round", "serve.finalize"} <= names


def test_tracing_adds_no_host_syncs_and_warm_builds_nothing(tiny_pipe, monkeypatch):
    counts = {"blocks": 0, "gets": 0}
    real_block, real_get = sched_mod._block_until_ready, sched_mod._device_get

    def count_block(x):
        counts["blocks"] += 1
        return real_block(x)

    def count_get(x):
        counts["gets"] += 1
        return real_get(x)

    monkeypatch.setattr(sched_mod, "_block_until_ready", count_block)
    monkeypatch.setattr(sched_mod, "_device_get", count_get)

    def replay(tel):
        sched = ServingScheduler(pipeline=tiny_pipe, telemetry=tel, autostart=False,
                                 config=SchedulerConfig(round_steps=2, batch_buckets=(2,)))
        outs = _run(sched, _trace_requests())
        misses_cold = tel.counter("serving/program_cache_misses").value
        outs_warm = _run(sched, _trace_requests())
        sched.close()
        return outs, outs_warm, tel.counter("serving/program_cache_misses").value - misses_cold

    untraced = replay(Telemetry())
    syncs_untraced = dict(counts)
    counts.update(blocks=0, gets=0)
    traced = replay(Telemetry(recorder=TraceRecorder()))
    assert counts == syncs_untraced
    assert traced[2] == 0 and untraced[2] == 0
    for a, b in zip(untraced[0], traced[0]):
        np.testing.assert_array_equal(a.samples, b.samples)
    for a, b in zip(traced[0], traced[1]):
        np.testing.assert_array_equal(a.samples, b.samples)


def test_shed_requests_close_their_trace():
    tel = Telemetry(recorder=TraceRecorder())
    sched = ServingScheduler(engine=FakeEngine(), telemetry=tel, autostart=False,
                             config=SchedulerConfig(max_queue=1))
    keep = sched.submit(SampleRequest(resolution=8, diffusion_steps=2))
    doomed = sched.submit(SampleRequest(resolution=8, diffusion_steps=2))
    with pytest.raises(Exception):
        doomed.result(timeout=1)
    sched.start()
    keep.result(timeout=10)
    sched.close()
    shed = [r for r in tel.records("request_trace") if r["outcome"].startswith("shed:")]
    assert len(shed) == 1 and shed[0]["outcome"] == "shed:queue_full"


def test_trace_recorder_drop_counter(tmp_path):
    tel = Telemetry(recorder=TraceRecorder(str(tmp_path / "t.json"), max_events=3))
    for i in range(6):
        tel.recorder.instant_at(f"e{i}", 0.0)
    assert tel.recorder.dropped == 4     # 1 metadata + 2 stored, 4 past bound
    assert tel.counter("telemetry/trace_dropped_events").value == 4
    tel.flush()
    doc = json.load(open(tmp_path / "t.json", encoding="utf-8"))
    assert doc["flaxdiff_dropped_events"] == 4


def test_tracer_noop_on_disabled_hub():
    tracer = RequestTracer(Telemetry(enabled=False))
    assert not tracer.enabled
    assert tracer.begin(SampleRequest(resolution=8), 0.0) is None
    tracer.shed(None, "queue_full", 0.0)
    tracer.round([], None, 0.0, 1.0, 1)
    tracer.complete(object(), 0, 0, 0, 0, 0.0)
    assert Telemetry().records() == []


def test_metrics_registry_snapshot_and_series_cap():
    from flaxdiff_tpu_torch.telemetry import MetricsRegistry
    reg = MetricsRegistry(max_series=3)
    reg.counter("a").inc(2)
    reg.gauge("b").set(5)
    h = reg.histogram("c", bounds=(1.0, 10.0))
    for v in (0.5, 2.0, 20.0):
        h.observe(v)
    reg.counter("d").inc()               # past the cap: a no-op instrument
    snap = reg.snapshot()
    assert snap["a"] == 2 and snap["b"] == 5 and snap["c/count"] == 3
    assert snap["c/max"] == 20.0 and "d" not in snap
    assert snap["telemetry/dropped_series"] == 1
    with pytest.raises(TypeError):
        reg.gauge("a")
