"""The port's telemetry (``flaxdiff_tpu_torch/telemetry``, ``profiling.py``,
``trainer/logging.py``, ``trainer/registry.py``, the fit loop's and the
CLI's wiring, the serving engine's program rows) against the JAX package,
on the CPU.

The host-side modules are driven through one scripted sequence with one
fake clock in both packages and must give the same rows, account,
aggregate and incident bundle, key for key and value for value. The model
FLOP count of a tiny UNet and a tiny DiT equals ``traced_model_flops`` of
the same configurations exactly (a trace, no compile). The device profiler's
parser runs on a synthetic Chrome trace whose family sums the test states.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from flaxdiff_tpu.models.dit import SimpleDiT as JaxDiT
from flaxdiff_tpu.models.unet import Unet as JaxUnet
from flaxdiff_tpu.profiling import traced_model_flops
from flaxdiff_tpu.resilience import events as jax_events
from flaxdiff_tpu.resilience.coordination import InMemoryTransport as JaxTransport
from flaxdiff_tpu.telemetry.aggregate import CrossHostAggregator as JaxAggregator
from flaxdiff_tpu.telemetry.flightrec import FlightRecorder as JaxFlightRecorder
from flaxdiff_tpu.telemetry.goodput import GoodputLedger as JaxLedger
from flaxdiff_tpu.telemetry.metrics import MetricsRegistry as JaxRegistry
from flaxdiff_tpu.telemetry.metrics import PrometheusTextfileExporter as JaxProm
from flaxdiff_tpu.telemetry.phases import StepPhaseTimer as JaxTimer
from flaxdiff_tpu.trainer.registry import ModelRegistry as JaxModelRegistry
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu_torch import resilience as R
from flaxdiff_tpu_torch import train
from flaxdiff_tpu_torch.models import SimpleDiT, Unet
from flaxdiff_tpu_torch.profiling import FlopCounter, device_peak_flops, mfu, model_flops
from flaxdiff_tpu_torch.resilience.coordination import InMemoryTransport
from flaxdiff_tpu_torch.telemetry import (AggregationDisabled, CrossHostAggregator,
                                          DeviceProfiler, FlightRecorder, GoodputLedger,
                                          MemoryMonitor, MetricsRegistry,
                                          PrometheusTextfileExporter, StepPhaseTimer, Telemetry,
                                          kernel_family, list_incidents, read_registry)
from flaxdiff_tpu_torch.telemetry import devprof
from flaxdiff_tpu_torch.trainer import JsonlLogger, ModelRegistry, make_logger, save_image_grid
from flaxdiff_tpu_torch.trainer.logging import attach_resilience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    """A clock that advances by a script of increments, one per read."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.25
        return self.t


# -- model FLOPs ----------------------------------------------------------------------

FLOP_CASES = {
    "unet": (JaxUnet, Unet,
             dict(output_channels=3, emb_features=32, feature_depths=(16, 32), num_res_blocks=2,
                  norm_groups=4, attention_configs=(None, {"heads": 2, "dim_head": 8})),
             dict(in_channels=3, context_dim=12), (2, 16, 16, 3), (2, 7, 12)),
    "dit": (JaxDiT, SimpleDiT,
            dict(output_channels=4, patch_size=2, emb_features=64, num_layers=2, num_heads=2,
                 mlp_ratio=4),
            dict(in_channels=4, context_dim=64), (2, 8, 8, 4), (2, 7, 64)),
}


@pytest.mark.parametrize("family", sorted(FLOP_CASES))
def test_model_flops_equal_the_jaxpr_count(family):
    """Matrix products, convolutions and attention's two products at true
    shapes (a padded head dim counts at the model's), the JAX side traced
    with the xla attention backend so no product hides in a kernel."""
    jcls, tcls, cfg, extra, xs, cs = FLOP_CASES[family]
    rng = np.random.default_rng(0)
    x, ctx = (rng.standard_normal(s).astype(np.float32) for s in (xs, cs))
    t = np.array([17.0, 640.0], np.float32)
    if family == "unet":
        jcfg = dict(cfg, attention_configs=(None, dict(cfg["attention_configs"][1],
                                                       backend="xla")))
    else:
        jcfg = dict(cfg, backend="xla")
    jm = jcls(**jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, t, ctx))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    ref = traced_model_flops(lambda p: jm.apply(p, x, t, ctx), params)
    tm = tcls(**cfg, **extra, device="cpu")
    with torch.no_grad():
        mine = model_flops(tm, *(torch.from_numpy(a) for a in (x, t, ctx)))
    assert ref > 0 and mine == ref


def test_flop_counter_counts_backward_and_the_kernels_formulas():
    """The backward's products (a conv's input and kernel gradients), the
    flash autograd function by formula (forward 2, backward 4 products), the
    batch-invariant route by formula; the CPU has no peak, so no MFU."""
    from flaxdiff_tpu_torch.ops import bi_conv2d, bi_linear, dot_product_attention
    conv = torch.nn.Conv2d(3, 6, 3, stride=2, padding=1)
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    with FlopCounter() as c:
        conv(x).sum().backward()
    out_numel = 2 * 6 * 4 * 4
    assert c.total == 2 * out_numel * 27 + 2 * x.numel() * 6 * 9 + 2 * (6 * 27) * 2 * 16
    q = torch.randn(2, 16, 2, 8, requires_grad=True)
    with FlopCounter() as c:
        dot_product_attention(q, q, q).sum().backward()
    assert c.total == 2 * 2 * 2 * 16 * 16 * 8 * 6
    assert model_flops(bi_linear, torch.randn(2, 5, 8), torch.randn(4, 8)) == 2 * 10 * 8 * 4
    assert model_flops(bi_conv2d, torch.randn(2, 8, 8, 3), torch.randn(6, 3, 3, 3), None,
                       (1, 1), ((1, 1), (1, 1))) == 2 * 2 * 64 * 6 * 27
    assert device_peak_flops("cpu") is None and mfu(1e9, 0.1, None) is None


def test_the_kernels_count_into_the_counter_their_call_runs_under():
    """The flash function finds its counter on the dispatch-mode stack of
    the thread that runs it (autograd hands ``backward()``'s stack to the
    thread that runs a CUDA backward): a forward and a backward counted
    under two counters split 2 and 4 products; outside any counter nothing
    is counted and no counter stays live."""
    from flaxdiff_tpu_torch import profiling
    from flaxdiff_tpu_torch.ops import dot_product_attention
    q = torch.randn(2, 16, 2, 8, requires_grad=True)
    with FlopCounter() as fwd:
        out = dot_product_attention(q, q, q)
    with FlopCounter() as bwd:
        out.sum().backward()
    product = 2 * 2 * 2 * 16 * 16 * 8
    assert (fwd.total, bwd.total) == (2 * product, 4 * product)
    assert profiling.live_counters == 0 and profiling.active_counter() is None
    dot_product_attention(q, q, q).sum().backward()
    assert (fwd.total, bwd.total) == (2 * product, 4 * product)


# -- host telemetry under one fake clock -----------------------------------------------

def _drive_timer(timer_cls, registry):
    """Six steps, sampled every 2nd: phases, an observed eval phase, and
    the rows / per-step results / histograms."""
    clock = FakeClock([0.5, 0.125, 0.25, 1.5, 0.75, 0.5] * 6)
    timer = timer_cls(registry=registry, clock=clock, sample_every=2)
    out = []
    for step in range(1, 7):
        timer.begin_step(step)
        if step == 5:
            timer.mark_sampled()
        with timer.phase("host"):
            pass
        with timer.phase("data_wait"):
            pass
        if timer.sampled:
            with timer.phase("device"):
                pass
        if step == 3:
            timer.observe_phase("eval", 2.0)
        res = timer.end_step()
        out.append((res, timer.last_row, timer.sampled))
    return out


def test_phase_timer_matches_jax_under_one_clock():
    jreg, treg = JaxRegistry(), MetricsRegistry()
    assert _drive_timer(StepPhaseTimer, treg) == _drive_timer(JaxTimer, jreg)
    assert treg.snapshot() == jreg.snapshot()


def _drive_ledger(cls, path):
    g = cls(path)
    g.record_productive(3.5)
    g.record_badput("compile", 12.25)
    g.record_badput("data_stall", 0.5)
    g.record_badput("zero", 0.0)
    moved = g.reattribute("compile", 2.0)
    with g.measure_badput("checkpoint_commit", clock=FakeClock([1.0, 0.75])):
        pass
    g.persist()
    again = cls(path)
    again.record_productive(1.0)
    again.record_badput("restart", 0.25)
    again.persist()
    with open(path) as f:
        saved = {k: v for k, v in json.load(f).items() if k != "updated"}
    return moved, g.totals(), g.snapshot(), again.totals(), again.snapshot(), saved


def test_goodput_ledger_matches_jax_across_incarnations(tmp_path):
    mine = _drive_ledger(GoodputLedger, str(tmp_path / "t" / "goodput.json"))
    ref = _drive_ledger(JaxLedger, str(tmp_path / "j" / "goodput.json"))
    assert mine == ref
    assert mine[3]["incarnations"] == 2 and mine[5]["productive_s"] == 6.5


def _aggregate_world(transport_cls, agg_cls, n):
    transports = transport_cls.make_world(n)
    out = [None] * n

    def host(rank):
        agg = agg_cls(transports[rank], timeout=10.0)
        out[rank] = [agg.aggregate({"step_time": 0.5 + rank, "loss": 2.0 - 0.25 * rank,
                                    **({"only0": 7.0} if rank == 0 else {})}),
                     agg.aggregate({"step_time": 1.0 * (rank + 1), "nan": float("nan")})]
        out[rank].append(agg_cls.flatten(out[rank][0]))

    threads = [threading.Thread(target=host, args=(r,)) for r in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    return out


@pytest.mark.parametrize("world", [1, 3])
def test_cross_host_aggregator_matches_jax(world):
    mine = _aggregate_world(InMemoryTransport, CrossHostAggregator, world)
    ref = _aggregate_world(JaxTransport, JaxAggregator, world)
    assert mine == ref and all(m == mine[0] for m in mine)
    assert mine[0][0]["step_time"]["hosts"] == world


def test_aggregator_disables_on_a_peer_tombstone():
    a, b = InMemoryTransport.make_world(2)
    agg = CrossHostAggregator(a, timeout=5.0)
    b.offer_json("telemetry.agg.0", {"__aggregation_disabled__": True})
    with pytest.raises(AggregationDisabled):
        agg.aggregate({"x": 1.0})
    assert agg.disabled and agg.aggregate({"x": 1.0}) is None


def _drive_flightrec(rec_cls, registry, events_mod, directory):
    clock = FakeClock([0.5] * 200)
    rec = rec_cls(directory, registry=registry, window_s=10.0, cooldown_s=1.0,
                  quarantine_spike=3, clock=clock)
    registry.counter("serving/rounds").inc(4)
    for i in range(6):
        rec.record({"type": "request_trace", "trace_id": f"t{i % 2}", "step": i})
        rec.metrics({"serving/rounds": float(i)}, step=i)
    ev = lambda kind, site, step=None: events_mod.ResilienceEvent(
        kind=kind, site=site, detail="d", step=step, time=1000.0)
    rec._on_event(ev("serving_rebuild", "serving.engine", 3))
    rec._on_event(ev("serving_rebuild", "serving.engine"))      # inside the cooldown
    for _ in range(3):
        rec._on_event(ev("quarantine", "serving.quarantine"))
    rec._on_event(ev("replica_lost", "serving.replica_lost", 5))
    bundles = []
    for path in rec.incidents:
        with open(path) as f:
            bundles.append((os.path.basename(path), json.load(f)))
    return bundles


def test_flight_recorder_bundles_match_jax(tmp_path):
    mine = _drive_flightrec(FlightRecorder, MetricsRegistry(), R.events, str(tmp_path / "t"))
    ref = _drive_flightrec(JaxFlightRecorder, JaxRegistry(), jax_events, str(tmp_path / "j"))
    assert mine == ref
    assert [name for name, _ in mine] == ["incident-001-engine_rebuild.json",
                                          "incident-002-quarantine_spike.json",
                                          "incident-003-replica_lost.json"]
    assert mine[0][1]["trace_ids"] == ["t0", "t1"]
    assert len(list_incidents(str(tmp_path / "t"))) == 3


def _fill(registry):
    registry.counter("serving/rounds").inc(3)
    registry.gauge("memory/bytes in-use").set(2.5e9)
    h = registry.histogram("phase/host")
    for v in (0.002, 0.03, 0.4, 7.0):
        h.observe(v)
    registry.gauge("bad").set(float("inf"))
    return {**registry.snapshot(), "9lives": 1.0, "label": "text"}


def test_prometheus_textfile_matches_jax(tmp_path):
    snap = _fill(MetricsRegistry())
    assert snap == _fill(JaxRegistry())
    PrometheusTextfileExporter(str(tmp_path / "t.prom")).export(snap, step=12)
    JaxProm(str(tmp_path / "j.prom")).export(snap, step=12)
    mine = (tmp_path / "t.prom").read_text()
    assert mine == (tmp_path / "j.prom").read_text()
    assert mine.startswith("flaxdiff_step 12\n") and "flaxdiff__9lives 1.0" in mine
    assert not (tmp_path / "t.prom.tmp").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_registry_json_reads_both_ways(tmp_path, writer):
    path = str(tmp_path / "registry.json")
    w_cls, r_cls = (JaxModelRegistry, ModelRegistry) if writer == "jax" \
        else (ModelRegistry, JaxModelRegistry)
    w = w_cls(path)
    w.register_run("a", "/ck/a", 10, {"loss": 0.5, "fid": 30.0},
                   metric_directions={"loss": False, "fid": False}, config={"x": 1})
    w.register_run("b", "/ck/b", 20, {"loss": 0.4, "psnr": 21.0},
                   metric_directions={"psnr": True})
    got = w.register_run("a", "/ck/a", 30, {"loss": 0.3})
    assert got == {"loss": True}
    for reg in (r_cls(path), w_cls(path)):
        assert reg.best_run("loss")["run"] == "a" and reg.best_checkpoint("psnr") == "/ck/b"
        assert reg.best_run("fid") is None      # a's re-registration dropped fid
        assert [r["run"] for r in reg.top_k("loss")] == ["a", "b"]
    assert ModelRegistry(path).push_artifact("a", "/ck/a") is False


# -- device profiles --------------------------------------------------------------------

KERNELS = [("void flash_fwd_wgmma_kernel<bf16, 64>(Params)", 40.0),
           ("flash_bwd_dq_wide_wgmma_kernel", 30.0),
           ("void gn_stats_kernel<float>(...)", 5.0), ("gn_norm_kernel", 7.0),
           ("geglu_bwd_kernel", 6.0), ("ln_mod_fwd_rows_kernel<bf16, 768, 2>", 4.0),
           ("gate_res_bwd_kernel", 3.0), ("bi_gemm_wgmma_kernel<bf16, 128>", 20.0),
           ("bi_conv_narrow_kernel", 11.0),
           ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", 50.0),
           ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", 25.0),
           ("void at::native::vectorized_elementwise_kernel<4, ...>", 9.0),
           ("Memcpy DtoD (Device -> Device)", 2.0)]
FAMILY_US = {"flash": 40.0, "flash_wide": 30.0, "groupnorm": 12.0, "geglu": 6.0, "adaln": 4.0,
             "gate_res": 3.0, "bi_gemm": 20.0, "bi_conv": 11.0, "library_conv": 50.0,
             "library_gemm": 25.0, "other": 11.0}


def _trace(kernels=KERNELS):
    events = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0,
               "dur": 500}]
    ts = 10.0
    for name, dur in kernels:
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
                       "dur": dur})
        ts += dur + 1.0        # a 1 us gap before each next kernel
    return {"traceEvents": events}


def test_devprof_families_row_and_reconciliation(tmp_path):
    summary = devprof.summarize_events(_trace()["traceEvents"])
    assert {f: v["us"] for f, v in summary["families"].items()} == FAMILY_US
    assert summary["device_total_us"] == sum(FAMILY_US.values()) == 212.0
    assert summary["device_events"] == len(KERNELS) and summary["fusion_gap_count"] == 12
    row = devprof.build_row(summary, capture="w/trace.json", steps=2, kind="train_step",
                            key="k", window=1, step=4)
    assert row["status"] == "ok" and row["device_ms_per_step"] == 0.106
    assert sum(v["ms"] for v in row["families"].values()) == pytest.approx(0.212, rel=1e-12)
    fields = devprof.reconcile(row, {"flops_jaxpr": 2.12e8}, peak_flops=1e13,
                               peak_bytes_per_s=1e12)
    assert fields["measured_flops_per_s"] == pytest.approx(2e12)
    assert fields["measured_mfu"] == pytest.approx(0.2)
    assert (fields["roofline_verdict"], fields["roofline_basis"]) == ("memory-bound",
                                                                      "mfu_fraction")
    assert kernel_family("bi_conv_wgmma_kernel<bf16, 64>") == "bi_conv"
    # a window that saw no device activity carries no family times
    empty = devprof.build_row(devprof.summarize_events(_trace([])["traceEvents"]))
    assert empty["status"] == "host_only" and empty["device_events"] == 0
    assert empty["families"] == {}
    # a corrupt capture is reported, not raised
    (tmp_path / "w").mkdir()
    (tmp_path / "w" / "trace.json").write_text('{"traceEvents": [')
    bad = devprof.profile_window_row(str(tmp_path / "w"))
    assert bad["status"] == "skipped_corrupt" and bad["skipped_corrupt"]


def test_device_profiler_window_reconciles_its_program(tmp_path):
    """A window on the CPU: opened on cadence, closed after its steps, its
    trace parsed (no device events: host_only, no retry off CUDA), and the
    registry's program annotated only for an ok row; the same rows come from
    a trace written into a window directory."""
    tel = Telemetry.create(str(tmp_path / "tel"))
    tel.programs.record("train_step", "k", compile_ms=1.0, flops_jaxpr=2.12e8)
    prof = DeviceProfiler(tel.devprof_path, cadence=2, window=2, metrics=tel.registry,
                          cuda=False)
    assert not prof.should_open(1) and prof.should_open(2) and prof.open(2)
    torch.ones(4) @ torch.ones(4)
    assert not prof.should_close(3) and prof.should_close(4)
    row = prof.close(4, kind="train_step", key="k", programs=tel.programs)
    assert row["status"] == "host_only" and row["steps"] == 2
    assert devprof.read_devprof(tel.devprof_path) == [json.loads(devprof.stable_json(row))]
    sub = tmp_path / "cap"
    sub.mkdir()
    (sub / "trace.json").write_text(json.dumps(_trace()))
    ok = devprof.profile_window_row(str(sub), steps=2, kind="train_step", key="k",
                                    programs=tel.programs, window=9)
    assert ok["status"] == "ok" and ok["measured_device_ms_per_step"] == pytest.approx(0.106)
    tel.close()
    merged = read_registry(str(tmp_path / "tel" / "programs.jsonl"))
    assert len(merged) == 1 and merged[0]["devprof_window"] == 9
    assert merged[0]["measured_device_ms_per_step"] == pytest.approx(0.106)


def test_memory_monitor_reads_the_host_only_on_the_cpu(tmp_path):
    mon = MemoryMonitor("cpu")
    stats = mon.sample()
    assert set(stats) == {"memory/host_rss_bytes", "memory/host_rss_peak_bytes",
                          "memory/host_vms_bytes"}
    reg = MetricsRegistry()
    assert mon.record(reg) and "memory/peak_bytes_in_use" not in reg.snapshot()
    missing = MemoryMonitor("cpu", statm_path=str(tmp_path / "nope"))
    assert missing.sample() == {} and missing.disabled


# -- hub, loggers, fit, CLI, serving --------------------------------------------------------

def test_hub_files_and_the_disabled_default(tmp_path):
    assert not Telemetry().enabled and Telemetry().programs is None
    logged = []

    class Sink:
        def log(self, data, step=None):
            logged.append((step, data))

    tel = Telemetry.create(str(tmp_path), transport=InMemoryTransport.make_world(1)[0],
                           prometheus_textfile=str(tmp_path / "m.prom"), logger=Sink())
    tel.counter("a").inc()
    with tel.span("s"):
        pass
    tel.record_step({"step": 1.0, "host": 0.5, "wall": 0.5})
    tel.aggregate({"x": 1.0}, step=1)
    tel.export(step=1)
    tel.close()
    rows = [json.loads(line) for line in (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    assert [r["type"] for r in rows] == ["step_phases", "pod_metrics", "metrics"]
    assert all(r["epoch"] == 1 for r in rows) and rows[1]["pod/x/max"] == 1.0
    assert logged and logged[-1][0] == 1 and "a" in logged[-1][1]
    assert json.load(open(tmp_path / "goodput.json"))["incarnations"] == 1
    assert json.load(open(tmp_path / "trace.json"))["traceEvents"][-1]["name"] == "s"
    assert "flaxdiff_a 1.0" in (tmp_path / "m.prom").read_text()
    # process 1 of a world suffixes its files
    tel1 = Telemetry.create(str(tmp_path), process_index=1)
    assert tel1.devprof_path.endswith("devprof_p1.jsonl")
    tel1.close()


def test_loggers_jsonl_grid_and_resilience_stream(tmp_path):
    log = make_logger(jsonl_path=str(tmp_path / "train_log.jsonl"))
    log.log({"loss": np.float32(0.5), "seq": [1, 2], "big": list(range(100)), "d": {"a": 1}},
            step=3)
    log_images = np.random.default_rng(0).uniform(-1, 1, (5, 4, 4, 3)).astype(np.float32)
    log.log_images("val/samples", log_images, step=3)
    ev_log = R.EventLog()
    detach = attach_resilience(log, ev_log)
    ev_log.record("retry", "data.fetch", "x", step=4)
    detach()
    ev_log.record("retry", "data.fetch", "y", step=5)
    log.finish()
    rows = [json.loads(line) for line in (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert rows[0]["loss"] == 0.5 and rows[0]["seq"] == [1, 2] and "big" not in rows[0]
    png = rows[1]["val/samples"]
    assert png.endswith("val_samples_000003.png") and os.path.getsize(png) > 0
    assert [r.get("resilience_detail") for r in rows[2:]] == ["x"]
    from flaxdiff_tpu_torch.data import decode_png
    with open(save_image_grid(np.zeros((2, 3, 3, 1), np.uint8), str(tmp_path / "g.png")),
              "rb") as f:
        assert f.read(4) == b"\x89PNG"
    assert decode_png(open(png, "rb").read()).shape == (10, 16, 3)
    with pytest.raises(ImportError, match="wandb"):
        make_logger(project="p")
    assert isinstance(make_logger(jsonl_path=str(tmp_path / "x.jsonl")), JsonlLogger)


def _cli(tmp_path, *extra):
    model = dict(emb_features=32, feature_depths=[16, 32],
                 attention_configs=[None, {"heads": 2, "dim_head": 8}], num_res_blocks=1,
                 norm_groups=4)
    return ["--dataset", "synthetic", "--text_encoder", "hash", "--image_size", "16",
            "--batch_size", "4", "--model_config", json.dumps(model), "--dtype", "float32",
            "--optimizer", "adamw", "--lr", "1e-3", "--warmup_steps", "2", "--total_steps", "6",
            "--save_every", "3", "--log_every", "2", "--checkpoint_dir", str(tmp_path / "run"),
            "--device", "cpu", "--seed", "1", *extra]


def test_cli_telemetry_registry_and_diagnose_run(tmp_path):
    """A tiny CPU run with every telemetry flag writes what the JAX CLI
    writes, and scripts/diagnose_run.py reads it; a second run lands in the
    same registry, and from_registry serves the best."""
    tel_dir, prom, reg = tmp_path / "tel", tmp_path / "m.prom", tmp_path / "registry.json"
    flags = ["--telemetry_dir", str(tel_dir), "--telemetry_sample_every", "2",
             "--prometheus_textfile", str(prom), "--registry", str(reg), "--run_name", "tiny"]
    hist = train.main(_cli(tmp_path, *flags))
    gp = hist["goodput"]
    assert gp["productive_s"] > 0 and gp["badput_s"]["compile"] > 0 and len(hist["mfu"]) == 3
    for name in ("telemetry.jsonl", "programs.jsonl"):
        assert all(json.loads(line) for line in (tel_dir / name).read_text().splitlines())
    assert json.load(open(tel_dir / "goodput.json"))["productive_s"] > 0
    assert json.load(open(tel_dir / "trace.json"))["traceEvents"]
    assert "flaxdiff_goodput_fraction" in prom.read_text()
    assert json.loads((tmp_path / "run" / "train_log.jsonl").read_text().splitlines()[0])["step"]
    programs = read_registry(str(tel_dir / "programs.jsonl"))
    assert [p["kind"] for p in programs] == ["train_step"] and programs[0]["flops_jaxpr"] > 0
    res = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "diagnose_run.py"),
                          str(tel_dir), "--json"], capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    doc = json.loads(res.stdout)
    assert doc["goodput"]["productive_s"] > 0 and doc["steps"] == 6 and doc["phase_rows"] == 4
    assert doc["programs"][0]["kind"] == "train_step"
    assert ModelRegistry(str(reg)).best_run("loss")["run"] == "tiny"
    assert ModelRegistry(str(reg)).runs()["tiny"]["step"] == 6
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    pipe = DiffusionInferencePipeline.from_registry(str(reg), device="cpu")
    assert pipe.generate_samples(resolution=16, diffusion_steps=2, sampler="ddim",
                                 prompts=["a"], seed=1).shape == (1, 16, 16, 3)
    with pytest.raises(SystemExit, match="requires --telemetry_dir"):
        train.main(_cli(tmp_path, "--prometheus_textfile", str(prom)))
    with pytest.raises(SystemExit, match="second half"):
        train.main(_cli(tmp_path, "--anomaly_action", "rollback"))


def test_fit_without_a_hub_writes_nothing_and_with_one_books_its_time(tmp_path, monkeypatch):
    """The disabled default: no telemetry file, no FLOP count, no program
    row, MFU not reported; an enabled hub with a profile cadence: one phase
    row per sampled step, programs for the step and its monitored twin, a
    devprof row, goodput summing to the fit's wall."""
    import time as _time
    monkeypatch.chdir(tmp_path)
    run = train.make_run(_cli(tmp_path))
    hist = run.trainer.fit(run.batches(0), total_steps=2)
    assert hist["mfu"] == [None] and os.listdir(tmp_path) == ["run"]
    assert set(hist["goodput"]["badput_s"]) <= {"compile", "data_stall", "checkpoint_commit"}
    run.trainer.checkpointer.close()

    tel = Telemetry.create(str(tmp_path / "tel"))
    run = train.make_run(_cli(tmp_path / "b", "--numerics_cadence", "3"))
    import dataclasses
    trainer = run.trainer
    trainer.telemetry = tel
    trainer.config = dataclasses.replace(trainer.config, profile_cadence=3, profile_steps=2,
                                         telemetry_sample_every=4)
    t0 = _time.perf_counter()
    hist = trainer.fit(run.batches(0), total_steps=6)
    wall = _time.perf_counter() - t0
    tel.close()
    trainer.checkpointer.close()
    gp = hist["goodput"]
    total = gp["productive_s"] + sum(gp["badput_s"].values())
    assert 0.9 * wall <= total <= wall and "profile" in gp["badput_s"]
    rows = [json.loads(line) for line in (tmp_path / "tel" / "telemetry.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows if r["type"] == "step_phases"] == [1, 2, 3, 4, 6]
    assert any(r["type"] == "numerics" for r in rows)
    kinds = [p["kind"] for p in read_registry(str(tmp_path / "tel" / "programs.jsonl"))]
    assert kinds == ["train_step", "train_step_monitored"]
    dev = devprof.read_devprof(str(tmp_path / "tel" / "devprof.jsonl"))
    assert [(r["step"], r["steps"], r["status"]) for r in dev] == [(3, 2, "host_only"),
                                                                   (6, 2, "host_only")]


@pytest.mark.parametrize("first_s", [1.9, 2.1], ids=["warm", "cold"])
def test_fit_reclassifies_a_warm_first_step_by_the_jax_rule(first_s):
    """Under a fake clock that only the step advances (a first step of
    `first_s`, then four of 1 s) each step's busy time is scripted. The JAX
    fit's rule: a first step within ``_COMPILE_RECLASS_RATIO`` x the steady
    median goes back to productive with one ``warm_compile_reclassified``
    event; one above it stays compile badput."""
    from flaxdiff_tpu.trainer.trainer import _COMPILE_RECLASS_RATIO as JAX_RATIO
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import DiffusionTrainer, TrainerConfig, adamw
    from flaxdiff_tpu_torch.trainer import trainer as trainer_module
    assert trainer_module._COMPILE_RECLASS_RATIO == JAX_RATIO
    now = [0.0]
    tel = Telemetry()
    tel.step_timer = lambda **kw: StepPhaseTimer(registry=tel.registry, clock=lambda: now[0],
                                                 **kw)
    model = Unet(output_channels=3, emb_features=16, feature_depths=(8,),
                 attention_configs=(None,), num_res_blocks=1, norm_groups=4, device="cpu")
    trainer = DiffusionTrainer(model, adamw(1e-3), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), TrainerConfig(log_every=5),
                               device="cpu", telemetry=tel)
    durations, step = iter([first_s, 1.0, 1.0, 1.0, 1.0]), trainer.train_step

    def scripted(batch):
        now[0] += next(durations)
        return step(batch)

    trainer.train_step = scripted
    rng = np.random.default_rng(0)
    batches = [{"sample": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)} for _ in range(5)]
    with R.use_event_log(R.EventLog()) as log:
        gp = trainer.fit(iter(batches), total_steps=5)["goodput"]
    warm = first_s <= JAX_RATIO * 1.0
    assert gp["productive_s"] == pytest.approx(4.0 + (first_s if warm else 0.0))
    assert gp["badput_s"].get("compile", 0.0) == pytest.approx(0.0 if warm else first_s)
    assert log.count("warm_compile_reclassified", "train.step") == int(warm)


def test_serving_registers_one_program_per_miss_and_dumps_rebuilds(tmp_path):
    """Under an enabled hub the engine writes one program row per cache
    miss, with the first call's FLOPs; the scheduler polls its profiler each
    round; a device loss's rebuild dumps one incident bundle."""
    from test_torch_serving import REQ, FakeEngine, pipelines
    from flaxdiff_tpu_torch.serving import SampleRequest, SchedulerConfig, ServingScheduler
    polled = []

    class Poll:
        def poll_round(self, n):
            polled.append(n)

    with R.use_event_log(R.EventLog()):
        tel = Telemetry.create(str(tmp_path / "tel"))
        _, pipe = pipelines("dit", False)
        sched = ServingScheduler(pipeline=pipe, telemetry=tel, profiler=Poll(),
                                 config=SchedulerConfig(round_steps=2, batch_buckets=(1, 2)))
        reqs = [SampleRequest(**REQ, diffusion_steps=3, sampler="ddim", seed=s) for s in (1, 2)]
        for f in [sched.submit(r) for r in reqs]:
            f.result(timeout=120)
        sched.close()
        rows = read_registry(str(tmp_path / "tel" / "programs.jsonl"))
        misses = tel.registry.snapshot()["serving/program_cache_misses"]
        assert len(rows) == misses >= 2 and polled and polled == sorted(polled)
        assert all(r["flops_jaxpr"] > 0 and r["compile_ms"] > 0 for r in rows)
        assert {r["kind"] for r in rows} == {"chunk", "terminal"}

        plan = R.FaultPlan([R.FaultSpec("serving.device_lost", at=(1,), times=1,
                                        error="flag")], seed=0)
        eng_sched = ServingScheduler(engine=FakeEngine(), telemetry=tel, autostart=False,
                                     config=SchedulerConfig(round_steps=16, batch_buckets=(4,)),
                                     engine_factory=FakeEngine)
        with plan.installed():
            futs = [eng_sched.submit(SampleRequest(resolution=8, diffusion_steps=4,
                                                   sampler="ddim", seed=s)) for s in (1, 2)]
            eng_sched.start()
            for f in futs:
                f.result(timeout=20)
            eng_sched.close()
        tel.close()
    assert [os.path.basename(p) for p in list_incidents(str(tmp_path / "tel"))] == [
        "incident-001-engine_rebuild.json"]
