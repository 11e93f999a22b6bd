"""Goodput/badput accounting (counterpart of
``flaxdiff_tpu/telemetry/goodput.py``): classify ALL wall-clock time of a
training job into productive training vs. named badput buckets, and
persist the running totals so they accumulate ACROSS job incarnations.

This ledger is how a run accounts for its time: "we trained for 31 h of a 36 h allocation — 2.1 h
compile, 1.6 h checkpoint commits, 0.8 h restarts, 0.5 h data stalls"
is the decomposition elastic-training systems (Pulse, arXiv:2606.19163)
evaluate against, and the prerequisite for every perf item on the
ROADMAP. Buckets the framework itself attributes:

    compile             first-step host+device time of a fit (kernel builds,
                        autotuning, allocator warm-up)
    checkpoint_commit   save dispatch + two-phase commit rounds
    restart             restore-at-start / consensus-restore rounds
    data_stall          host blocked waiting on the input pipeline
    coordination_lost   commit rounds spent discovering a dead peer
    eval                in-loop validation/sampling

The set is open — `record_badput` accepts any bucket name. The
invariant (tested): productive + all badput sums to the attributed
wall-clock of the run within tolerance; `goodput_fraction` is
productive over that total.

Persistence mirrors the resilience `StepLedger` philosophy: a small
JSON file (`goodput.json`, atomic tmp+rename, process 0 only) beside
the run's telemetry so a coordinated restart RESUMES the account
instead of zeroing it — each load bumps `incarnations`, and totals are
reported cumulatively across the job's lives.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

GOODPUT_FILENAME = "goodput.json"


class GoodputLedger:
    """Thread-safe productive/badput time account with cross-incarnation
    persistence. `path=None` keeps an in-memory account (the process-
    global default hub), same API, nothing on disk."""

    def __init__(self, path: Optional[str] = None, process_index: int = 0):
        self.path = path
        self.process_index = process_index
        self._lock = threading.Lock()
        self._productive = 0.0
        self._badput: Dict[str, float] = {}
        # ESTIMATED badput avoided by live recovery (elastic transitions
        # vs. their checkpoint-and-exit counterfactual). A separate
        # account, NOT part of the productive+badput=wall-clock
        # invariant: reclaimed seconds never happened — they are what a
        # restart WOULD have cost — so adding them to either side would
        # corrupt the attribution closure.
        self._reclaimed: Dict[str, float] = {}
        self._prior_productive = 0.0
        self._prior_badput: Dict[str, float] = {}
        self._prior_reclaimed: Dict[str, float] = {}
        self.incarnation = 1
        if path is not None and os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    prior = json.load(f)
                prior_productive = float(prior.get("productive_s", 0.0))
                prior_badput = {
                    str(k): float(v)
                    for k, v in dict(prior.get("badput_s", {})).items()}
                prior_reclaimed = {
                    str(k): float(v)
                    for k, v in dict(prior.get("reclaimed_s", {})).items()}
                incarnation = int(prior.get("incarnations", 0)) + 1
            except (json.JSONDecodeError, ValueError, TypeError, OSError):
                # a torn write from a crashed incarnation: start a fresh
                # account rather than refuse to train. Parsed into
                # locals so a partial parse (productive_s readable,
                # badput_s corrupt) cannot leave prior productive time
                # with zeroed badput — all-or-nothing.
                pass
            else:
                self._prior_productive = prior_productive
                self._prior_badput = prior_badput
                self._prior_reclaimed = prior_reclaimed
                self.incarnation = incarnation

    # -- recording -----------------------------------------------------------
    def record_productive(self, seconds: float) -> None:
        with self._lock:
            self._productive += max(float(seconds), 0.0)

    def record_badput(self, bucket: str, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        if s == 0.0:
            return
        with self._lock:
            self._badput[bucket] = self._badput.get(bucket, 0.0) + s

    def record_reclaimed(self, bucket: str, seconds: float) -> None:
        """Credit an elastic transition's estimated badput savings vs.
        its checkpoint-and-exit counterfactual
        (`ElasticWorldManager.reclaimed_estimate`). Kept OUT of the
        productive/badput closure — see `_reclaimed` above."""
        s = max(float(seconds), 0.0)
        if s == 0.0:
            return
        with self._lock:
            self._reclaimed[bucket] = self._reclaimed.get(bucket, 0.0) + s

    def reattribute(self, bucket: str, seconds: float) -> float:
        """Move up to `seconds` from a badput bucket into productive
        time; returns the amount actually moved. The fit loop's
        compile-badput heuristic attributes the first step of every
        program to `compile` AT THE TIME — a warm persistent
        compilation cache makes that first step an ordinary cheap step,
        which the loop detects only once it has steady-state steps to
        compare against, and then corrects here. Only time recorded by
        THIS incarnation can move (prior incarnations' attribution is
        settled history)."""
        s = max(float(seconds), 0.0)
        with self._lock:
            moved = min(s, self._badput.get(bucket, 0.0))
            if moved <= 0.0:
                return 0.0
            self._badput[bucket] -= moved
            if self._badput[bucket] <= 0.0:
                del self._badput[bucket]
            self._productive += moved
            return moved

    @contextlib.contextmanager
    def measure_badput(self, bucket: str, clock=time.perf_counter):
        t0 = clock()
        try:
            yield
        finally:
            self.record_badput(bucket, clock() - t0)

    # -- queries -------------------------------------------------------------
    def raw_counters(self) -> Tuple[float, Dict[str, float]]:
        """(productive, badput) recorded by THIS incarnation only —
        callers diff two calls for a per-fit delta."""
        with self._lock:
            return self._productive, dict(self._badput)

    def totals(self, cumulative: bool = True) -> Dict[str, object]:
        with self._lock:
            productive = self._productive
            badput = dict(self._badput)
            reclaimed = dict(self._reclaimed)
        if cumulative:
            productive += self._prior_productive
            for k, v in self._prior_badput.items():
                badput[k] = badput.get(k, 0.0) + v
            for k, v in self._prior_reclaimed.items():
                reclaimed[k] = reclaimed.get(k, 0.0) + v
        bad_total = sum(badput.values())
        total = productive + bad_total
        return {
            "incarnations": self.incarnation,
            "productive_s": productive,
            "badput_s": badput,
            "badput_total_s": bad_total,
            "reclaimed_s": reclaimed,
            "reclaimed_total_s": sum(reclaimed.values()),
            "total_s": total,
            "goodput_fraction": (productive / total) if total > 0 else None,
        }

    def snapshot(self) -> Dict[str, float]:
        """Flat metrics view for registry-style exports."""
        t = self.totals()
        out = {"goodput/productive_s": t["productive_s"],
               "goodput/total_s": t["total_s"],
               "goodput/incarnation": float(self.incarnation)}
        if t["goodput_fraction"] is not None:
            out["goodput/fraction"] = t["goodput_fraction"]
        for k, v in t["badput_s"].items():
            out[f"goodput/badput/{k}_s"] = v
        if t["reclaimed_total_s"]:
            out["goodput/reclaimed_s"] = t["reclaimed_total_s"]
            for k, v in t["reclaimed_s"].items():
                out[f"goodput/reclaimed/{k}_s"] = v
        return out

    # -- persistence ---------------------------------------------------------
    def persist(self) -> None:
        """Atomic cumulative write (process 0 only — the account is a
        job-level fact, and hosts' clocks agree to within skew that
        does not matter at goodput granularity)."""
        if self.path is None or self.process_index != 0:
            return
        t = self.totals(cumulative=True)
        payload = {"incarnations": self.incarnation,
                   "productive_s": t["productive_s"],
                   "badput_s": t["badput_s"],
                   "reclaimed_s": t["reclaimed_s"],
                   "updated": time.time()}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".",
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, self.path)
