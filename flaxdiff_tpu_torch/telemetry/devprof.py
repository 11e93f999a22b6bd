"""Device-time attribution (counterpart of
``flaxdiff_tpu/telemetry/devprof.py``): automated ``torch.profiler``
windows parsed into byte-stable ``devprof.jsonl`` rows.

- **Windows** (``DeviceProfiler``): the trainer opens a profiler window
  every ``TrainerConfig.profile_cadence`` steps, or once when the
  ``profile_trigger`` file appears, and closes it ``profile_steps`` later;
  the serving scheduler polls ``poll_round`` each round. Off-window steps
  cost two int compares: no device work, no host sync. On a CUDA device the
  profiler traces device activity only (a host trace of a training window
  takes seconds to collect).
- **Attribution**: the window's Chrome trace (``trace.json``) becomes one
  row: device ms by kernel family (``kernel_family``: the port's kernels
  by name, the library's GEMMs and convolutions, everything else as
  ``other``), which sum to the window's device total by construction, the
  idle gaps between kernels on a stream, and the largest ``other``
  kernels. CUPTI sometimes delivers no device events: such a window is
  retried once (its row is not written); if the retry sees none too, its
  row says ``device_events: 0`` with no family times. A window never
  carries made-up times and never raises into its owner's loop.
- **Reconciliation** (``reconcile``): the row joined with its program's
  registry row: measured MFU (the registry's model FLOPs over the
  measured device time, against ``profiling.device_peak_flops``) and a
  roofline verdict, written back onto the registry row
  (``ProgramRegistry.annotate``).

``chip_smoke.py`` names kernel families with the same ``kernel_family``.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .programs import read_registry, stable_json

DEVPROF_FILENAME = "devprof.jsonl"

# kernel-name fragments -> family, first match wins (names lowercased): the
# wide flash kernels before flash, the batch-invariant kernels before the
# library's convolutions and GEMMs
FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flash_wide", ("flash_fwd_wide", "flash_bwd_dq_wide", "flash_bwd_dkv_wide")),
    ("flash", ("flash_fwd", "flash_bwd")),
    ("groupnorm", ("gn_stats", "gn_norm", "gn_bwd_stats", "gn_bwd_dx")),
    ("geglu", ("geglu",)),
    ("adaln", ("ln_mod",)),
    ("gate_res", ("gate_res",)),
    ("bi_gemm", ("bi_gemm",)),
    ("bi_conv", ("bi_conv",)),
    ("library_conv", ("conv", "fprop", "dgrad", "wgrad")),
    ("library_gemm", ("gemm", "gemv", "cutlass", "nvjet", "xmma", "cublas")),
)

# trace-event categories of device activity in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# HBM bytes/s of a card, by torch.cuda.get_device_name(): the roofline
# ridge's denominator (NVIDIA's data sheet); FLAXDIFF_PEAK_BYTES_PER_S
# overrides
_PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_PARSE_ERRORS = (OSError, EOFError, ValueError, KeyError, TypeError)


def kernel_family(name: str) -> str:
    low = name.lower()
    for fam, frags in FAMILIES:
        if any(f in low for f in frags):
            return fam
    return "other"


# -- trace loading -------------------------------------------------------------

def load_events(path: str) -> List[Dict[str, Any]]:
    """The ``traceEvents`` of one Chrome trace (gz or plain); raises on a
    truncated or corrupt file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def device_events(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The complete ("X") events of device activity: kernels, copies,
    sets."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def summarize_kernels(kernels: Iterable[Tuple[str, float, Optional[float], Any]]
                      ) -> Dict[str, Any]:
    """The attribution of (name, duration us, start us or None, lane)
    device events. Families sum to ``device_total_us``."""
    fam_us: collections.Counter = collections.Counter()
    fam_cnt: collections.Counter = collections.Counter()
    other: collections.Counter = collections.Counter()
    lanes: Dict[Any, List[Tuple[float, float]]] = collections.defaultdict(list)
    copy_us, copy_cnt, n = 0.0, 0, 0
    for name, dur, ts, lane in kernels:
        n += 1
        fam = kernel_family(name)
        fam_us[fam] += dur
        fam_cnt[fam] += 1
        if fam == "other":
            other[name[:96]] += dur
        low = name.lower()
        if "memcpy" in low or "copy_kernel" in low or "transpose" in low:
            copy_us += dur
            copy_cnt += 1
        if ts is not None:
            lanes[lane].append((float(ts), dur))
    gap_us, gap_cnt = 0.0, 0
    for evs in lanes.values():
        evs.sort()
        for (t0, d0), (t1, _) in zip(evs, evs[1:]):
            gap = t1 - (t0 + d0)
            if gap > 0:
                gap_us += gap
                gap_cnt += 1
    total = float(sum(fam_us.values()))
    return {
        "source": "device" if n else "host_only",
        "device_events": n,
        "lanes": len(lanes),
        "device_total_us": total,
        "families": {f: {"us": fam_us[f], "count": fam_cnt[f]} for f in fam_us},
        "top_other_us": dict(other.most_common(8)),
        "collective_us": 0.0, "collective_count": 0,
        "compute_us": total,
        "layout_copy_us": copy_us, "layout_copy_count": copy_cnt,
        "fusion_gap_us": gap_us, "fusion_gap_count": gap_cnt,
    }


def summarize_events(events) -> Dict[str, Any]:
    """The attribution summary of a parsed Chrome trace (durations in us;
    ``build_row`` converts to ms)."""
    devs = device_events(events)
    summary = summarize_kernels(
        (e.get("name", "?"), float(e.get("dur", 0) or 0), e.get("ts"),
         (e.get("pid"), e.get("tid"))) for e in devs)
    summary["devices"] = sorted({str(e.get("pid")) for e in devs})
    return summary


def find_capture(path: str):
    """(trace path, parsed events or None, skipped corrupt paths): the
    newest trace under `path` with device events, else the newest that
    parses; corrupt files are skipped and reported. Raises FileNotFoundError
    when there is no trace at all."""
    if os.path.isfile(path):
        return path, None, []
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
                  + glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True))
    if not hits:
        raise FileNotFoundError(f"no trace under {path!r}")
    skipped: List[str] = []
    host_only = None
    for hit in reversed(hits):
        try:
            events = load_events(hit)
        except _PARSE_ERRORS:
            skipped.append(hit)
            continue
        if device_events(events):
            return hit, events, skipped
        if host_only is None:
            host_only = (hit, events)
    if host_only is not None:
        return host_only[0], host_only[1], skipped
    return hits[-1], None, [h for h in skipped if h != hits[-1]]


# -- rows ----------------------------------------------------------------------

def build_row(summary: Optional[Dict[str, Any]], *, capture: Optional[str] = None,
              steps: int = 1, kind: Optional[str] = None, key: Optional[str] = None,
              window: Optional[int] = None, step: Optional[int] = None,
              skipped_corrupt=(), extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One ``devprof.jsonl`` row (ms) from a summary; ``summary=None`` means
    no trace parsed (status ``skipped_corrupt``), a summary without device
    events is ``host_only``. Family times stay window totals; ``steps``
    divides into ``device_ms_per_step`` only."""
    steps = max(int(steps or 1), 1)
    s = summary or {}
    total_ms = float(s.get("device_total_us", 0.0)) / 1e3
    if summary is None:
        status = "skipped_corrupt"
    elif s.get("source") == "host_only":
        status = "host_only"
    else:
        status = "ok"
    row: Dict[str, Any] = {
        "type": "devprof",
        "status": status,
        "source": s.get("source"),
        "capture": os.path.basename(capture) if capture else None,
        "kind": str(kind) if kind is not None else None,
        "key": str(key) if key is not None else None,
        "window": int(window) if window is not None else None,
        "step": int(step) if step is not None else None,
        "steps": steps,
        "devices": list(s.get("devices", [])),
        "device_events": int(s.get("device_events", 0)),
        "lanes": int(s.get("lanes", 0)),
        "device_total_ms": total_ms,
        "device_ms_per_step": round(total_ms / steps, 3),
        "families": {f: {"ms": v["us"] / 1e3, "count": int(v["count"])}
                     for f, v in sorted(s.get("families", {}).items())},
        "top_other_ms": {k: v / 1e3 for k, v in sorted(s.get("top_other_us", {}).items())},
        "modules": {},
        "collective_ms": float(s.get("collective_us", 0.0)) / 1e3,
        "collective_count": int(s.get("collective_count", 0)),
        "compute_ms": float(s.get("compute_us", 0.0)) / 1e3,
        "layout_copy_ms": float(s.get("layout_copy_us", 0.0)) / 1e3,
        "layout_copy_count": int(s.get("layout_copy_count", 0)),
        "fusion_gap_ms": float(s.get("fusion_gap_us", 0.0)) / 1e3,
        "fusion_gap_count": int(s.get("fusion_gap_count", 0)),
        "skipped_corrupt": [os.path.basename(p) for p in skipped_corrupt],
    }
    if extra:
        row.update(extra)
    return row


def append_row(path: str, row: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        f.write(stable_json(row) + "\n")


def read_devprof(path: str) -> List[Dict[str, Any]]:
    """The devprof rows of a ``devprof.jsonl`` (a torn last line skipped)."""
    return [r for r in read_registry(path) if r.get("type") == "devprof"]


# -- reconciliation ------------------------------------------------------------

def _env_rate(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def resolved_peak_flops() -> Optional[float]:
    """Peak FLOP/s: FLAXDIFF_PEAK_FLOPS when set, else the card's
    (``profiling.device_peak_flops``), else None."""
    env = _env_rate("FLAXDIFF_PEAK_FLOPS")
    if env is not None:
        return env
    from ..profiling import device_peak_flops
    return device_peak_flops()


def resolved_peak_bytes_per_s() -> Optional[float]:
    """Peak memory bytes/s: FLAXDIFF_PEAK_BYTES_PER_S when set, else the
    card's from the table, else None."""
    env = _env_rate("FLAXDIFF_PEAK_BYTES_PER_S")
    if env is not None:
        return env
    import torch
    if not torch.cuda.is_available():
        return None
    return _PEAK_HBM_BYTES_PER_S.get(torch.cuda.get_device_name())


def reconcile(row: Dict[str, Any], program: Dict[str, Any], *,
              peak_flops: Optional[float] = None, peak_bytes_per_s: Optional[float] = None,
              comm_bound_fraction: float = 0.4) -> Dict[str, Any]:
    """One measured row joined with its program's registry row: the
    achieved FLOP/s of the registry's model FLOPs over the measured device
    ms a step, measured MFU against the peak, and a roofline verdict
    (comm-bound when collectives take `comm_bound_fraction` of the window;
    else by arithmetic intensity where the row has a cost model; else
    compute-bound at or above half of peak, memory-bound below)."""
    steps = max(int(row.get("steps") or 1), 1)
    total_ms = float(row.get("device_total_ms") or 0.0)
    per_step_ms = total_ms / steps
    out: Dict[str, Any] = {"measured_device_ms_per_step": per_step_ms,
                           "measured_flops_per_s": None, "measured_mfu": None}
    pk_f = peak_flops if peak_flops is not None else resolved_peak_flops()
    flops = program.get("flops_jaxpr")
    measured_mfu = None
    if flops and per_step_ms > 0:
        achieved = float(flops) / (per_step_ms / 1e3)
        out["measured_flops_per_s"] = achieved
        if pk_f:
            measured_mfu = achieved / pk_f
            out["measured_mfu"] = measured_mfu
    coll_ms = float(row.get("collective_ms") or 0.0)
    comm_bytes = sum((program.get("comm_bytes_by_axis") or {}).values())
    out["comm_measured_ms"] = coll_ms
    out["comm_predicted_bytes"] = int(comm_bytes)
    out["comm_achieved_bytes_per_s"] = (comm_bytes * steps / (coll_ms / 1e3)
                                        if comm_bytes and coll_ms > 0 else None)
    verdict = basis = None
    if total_ms > 0 and coll_ms / total_ms >= comm_bound_fraction:
        verdict, basis = "comm-bound", "collective_fraction"
    else:
        fc, bc = program.get("flops_cost"), program.get("bytes_cost")
        pk_b = peak_bytes_per_s if peak_bytes_per_s is not None else resolved_peak_bytes_per_s()
        if fc and bc and pk_f and pk_b:
            verdict = "compute-bound" if (fc / bc) >= (pk_f / pk_b) else "memory-bound"
            basis = "intensity_vs_ridge"
        elif measured_mfu is not None:
            verdict = "compute-bound" if measured_mfu >= 0.5 else "memory-bound"
            basis = "mfu_fraction"
    out["roofline_verdict"] = verdict
    out["roofline_basis"] = basis
    return out


# registry fields a window writes back through annotate
_ANNOTATE_FIELDS = ("measured_device_ms_per_step", "measured_flops_per_s", "measured_mfu",
                    "comm_measured_ms", "comm_predicted_bytes", "comm_achieved_bytes_per_s",
                    "roofline_verdict", "roofline_basis")


def profile_window_row(logdir: str, *, steps: int = 1, kind: Optional[str] = None,
                       key: Optional[str] = None, programs=None, window: Optional[int] = None,
                       step: Optional[int] = None, extra: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """The row of one window's trace under `logdir`, reconciled against
    (and annotating) the registry's (kind, key) program where there is one.
    Never raises on a bad trace: a window with only corrupt traces gives a
    ``skipped_corrupt`` row, which is itself evidence."""
    summary, capture, skipped = None, None, []
    try:
        capture, events, skipped = find_capture(logdir)
        if events is None:
            events = load_events(capture)
        summary = summarize_events(events)
    except FileNotFoundError:
        capture = None
    except _PARSE_ERRORS as e:
        skipped.append(f"{capture}: {type(e).__name__}")
        summary = None
    row = build_row(summary, capture=capture, steps=steps, kind=kind, key=key, window=window,
                    step=step, skipped_corrupt=skipped, extra=extra)
    program = None
    if programs is not None and kind is not None and key is not None:
        rows = programs.rows() if hasattr(programs, "rows") else programs
        program = next((r for r in rows
                        if r.get("kind") == str(kind) and r.get("key") == str(key)), None)
    if program is not None and row["status"] == "ok":
        fields = reconcile(row, program)
        row.update(fields)
        if hasattr(programs, "annotate"):
            programs.annotate(kind, key, {**{f: fields.get(f) for f in _ANNOTATE_FIELDS},
                                          "devprof_window": window})
    return row


# -- automated windows ---------------------------------------------------------

class DeviceProfiler:
    """Cadence- or trigger-armed ``torch.profiler`` windows parsed into
    ``devprof.jsonl`` rows.

    The owner drives the window: ``should_open`` / ``should_close`` are two
    int compares (the whole off-window cost); the owner settles the device
    work dispatched in the window before ``close`` (the trainer
    synchronises its last step's event), so this module never waits on the
    card itself except inside the profiler's own stop. ``poll_trigger`` (a
    host stat, at log cadence) arms a one-shot window; ``poll_round`` is the
    serving scheduler's per-round hook. A profiler that fails to start or
    stop records a ``trace_failed`` resilience event and never raises."""

    def __init__(self, path: Optional[str], *, cadence: int = 0, window: int = 5,
                 trigger_path: Optional[str] = None, logdir: Optional[str] = None,
                 metrics=None, cuda: Optional[bool] = None, retries: int = 1):
        import torch
        self.path = path
        self.cadence = max(int(cadence), 0)
        self.window = max(int(window), 1)
        self.trigger_path = trigger_path
        if logdir is None and path:
            logdir = os.path.join(os.path.dirname(os.path.abspath(path)), "devprof_traces")
        self.logdir = logdir
        self._metrics = metrics
        self.cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
        self.retries = max(int(retries), 0)
        self._retries_left = self.retries
        self._armed = False
        self._open_at: Optional[int] = None
        self._open_logdir: Optional[str] = None
        self._prof = None
        self._seq = 0
        self.rows: List[Dict[str, Any]] = []

    def active(self) -> bool:
        return self._open_at is not None

    @property
    def open_step(self) -> Optional[int]:
        return self._open_at

    def should_open(self, step: int) -> bool:
        if self._open_at is not None or self.logdir is None:
            return False
        if self._armed:
            return True
        return self.cadence > 0 and step % self.cadence == 0

    def should_close(self, step: int) -> bool:
        return self._open_at is not None and step - self._open_at >= self.window

    def arm(self) -> None:
        """Open a window at the next ``should_open``."""
        self._armed = True

    def poll_trigger(self) -> bool:
        """One host stat: an existing trigger file arms a one-shot window
        and is consumed."""
        p = self.trigger_path
        if not p or self._armed or self._open_at is not None or not os.path.exists(p):
            return False
        try:
            os.remove(p)
        except OSError:
            pass
        self._armed = True
        return True

    def open(self, step: int) -> bool:
        if self._open_at is not None or self.logdir is None:
            return False
        from torch.profiler import ProfilerActivity, profile
        self._armed = False
        self._seq += 1
        sub = os.path.join(self.logdir, f"window{self._seq:04d}")
        try:
            os.makedirs(sub, exist_ok=True)
            prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                           else [ProfilerActivity.CPU])
            prof.__enter__()
        except Exception as e:  # noqa: BLE001 — degrade, but visibly
            from ..resilience.events import record_event
            record_event("trace_failed", "devprof.start_trace",
                         detail=f"{type(e).__name__}: {e} (logdir={sub})", step=step)
            return False
        self._prof = prof
        self._open_at = int(step)
        self._open_logdir = sub
        return True

    def close(self, at_step: Optional[int] = None, *, kind: Optional[str] = None,
              key: Optional[str] = None, programs=None,
              extra: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        """Stop the profiler, write and parse its trace, append and return
        the row; `at_step` is the step about to run (profiled steps =
        at_step - open step; the nominal window without it). A CUDA window
        that saw no device events re-arms for one retry instead (returns
        None) while retries are left."""
        if self._open_at is None:
            return None
        open_at, sub, prof = self._open_at, self._open_logdir, self._prof
        self._open_at = self._open_logdir = self._prof = None
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(sub, "trace.json"))
        except Exception as e:  # noqa: BLE001 — degrade, but visibly
            from ..resilience.events import record_event
            record_event("trace_failed", "devprof.stop_trace",
                         detail=f"{type(e).__name__}: {e} (logdir={sub})")
        steps = max(int(at_step) - open_at, 1) if at_step is not None else self.window
        try:
            row = profile_window_row(sub, steps=steps, kind=kind, key=key, programs=programs,
                                     window=self._seq, step=open_at, extra=extra)
        except Exception as e:  # noqa: BLE001 — a window never breaks its owner
            row = build_row(None, steps=steps, kind=kind, key=key, window=self._seq,
                            step=open_at, skipped_corrupt=[f"{sub}: {type(e).__name__}"],
                            extra=extra)
        if self.cuda and row["device_events"] == 0 and self._retries_left > 0:
            self._retries_left -= 1
            self._armed = True
            if self._metrics is not None:
                self._metrics.counter("devprof/retries").inc()
            return None
        self._retries_left = self.retries
        if self.path:
            append_row(self.path, row)
        self.rows.append(row)
        if self._metrics is not None:
            self._metrics.counter("devprof/windows").inc()
            if row["status"] != "ok":
                self._metrics.counter("devprof/parse_failures").inc()
            else:
                self._metrics.gauge("devprof/last_device_ms_per_step").set(
                    row["device_ms_per_step"])
                if row.get("measured_mfu") is not None:
                    self._metrics.gauge("devprof/last_measured_mfu").set(row["measured_mfu"])
        return row

    def poll_round(self, round_no: int) -> Optional[Dict[str, Any]]:
        """The serving scheduler's hook, once a dispatch round (host only;
        never touches the program cache): rounds stand in for steps."""
        if self._open_at is not None:
            if round_no - self._open_at >= self.window:
                return self.close(at_step=round_no, extra={"owner": "serving"})
            return None
        if self.should_open(round_no):
            self.open(round_no)
        return None
