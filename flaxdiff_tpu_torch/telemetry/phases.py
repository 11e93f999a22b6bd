"""Per-step phase decomposition (counterpart of
``flaxdiff_tpu/telemetry/phases.py``): where did each training step's
wall-clock actually go?

An
aggregate step time cannot distinguish "the input pipeline is starving
the device" from "the device program regressed" from "checkpoint
commits are on the critical path". `StepPhaseTimer` splits every step
into named phases:

    data_wait    host blocked fetching/uploading the next batch
    host         python dispatch of the jitted step (async — cheap)
    device       device execution, closed by synchronising a CUDA event
                 recorded after the step (the port's counterpart of
                 `block_until_ready`), so asynchronous launches cannot hide
                 device time inside a later host phase
    checkpoint   save dispatch + two-phase commit round
    eval         in-loop validation/sampling
    other        everything unattributed (loop bookkeeping, logging)

The invariant — tested — is that the phases of one step sum to that
step's wall-clock exactly (`other` is the closing residual, floored at
zero against clock jitter). Durations feed fixed-bucket histograms
(`phase/<name>`) in a MetricsRegistry and, optionally, the device
phase feeds an `MFUMeter` so utilization is computed against device
time rather than end-to-end step time.

**Sampled mode** (`sample_every > 1`): exact device-phase timing costs
one event synchronize per step — it closes async dispatch, trading
the whole pipeline for attribution. In sampled mode only every N-th
step is a *sampled* step (`timer.sampled`, the loop's cue to close
dispatch); off-sample steps record no device phase and add ZERO host
syncs — and ZERO bookkeeping beyond two dict merges: their phases
accumulate into a pending window, and the sampled step that closes the
window emits ONE row / one set of histogram observations carrying the
WINDOW sums (`timer.last_row`; off-sample steps leave it None). A
sampled step's device close drains everything dispatched since the
previous sample, so its measured device phase covers `steps_covered`
steps of device work: the timer feeds the MFUMeter
`observe(device, steps=steps_covered)` and the per-step invariant
degrades gracefully to WINDOW semantics — the emitted row's phases sum
to the WINDOW's wall-clock exactly (each step's `other` residual is
floored at zero, then summed), while `end_step`'s return value stays
per-step for goodput attribution. With `sample_every == 1` every step
closes its own window and the row IS the step — bit-identical to the
pre-sampling behavior.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from .metrics import MetricsRegistry

PHASES = ("data_wait", "host", "device", "checkpoint", "eval")


class StepPhaseTimer:
    """Accumulates named phase durations inside a begin/end step window.

    Usage::

        timer.begin_step(step)
        with timer.phase("host"):
            loss = train_step(batch)          # async dispatch
        with timer.phase("device"):
            done.synchronize()                # a CUDA event after the step
        phases = timer.end_step()             # {"host": ..., "wall": ...}

    Not thread-safe by design: one timer belongs to one training loop.
    Unknown phase names are accepted (the taxonomy is open) and land in
    their own histogram.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 mfu_meter=None, clock=time.perf_counter,
                 sample_every: int = 1):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self._registry = registry
        self._meter = mfu_meter
        self._clock = clock
        self.sample_every = int(sample_every)
        self._step: Optional[int] = None
        self._t0 = 0.0
        self._acc: Dict[str, float] = {}
        self.last: Optional[Dict[str, float]] = None
        # the row to export for the just-ended step: window sums on a
        # sampled step, None on off-sample steps (nothing to emit — the
        # pending window keeps accumulating)
        self.last_row: Optional[Dict[str, float]] = None
        self._window: Dict[str, float] = {}
        # whether the CURRENT step is a sampled one (the loop's cue to
        # close dispatch with an event synchronize); steps a device phase
        # will cover when it closes — reset on every device observation
        self.sampled = True
        self._steps_since_device = 0

    def begin_step(self, step: int) -> None:
        self._step = int(step)
        self._acc = {}
        self._t0 = self._clock()
        self._steps_since_device += 1
        # step 1 is always sampled: the compile step must be measured
        # exactly or the compile-badput attribution loses its evidence
        self.sampled = (self.sample_every <= 1 or step <= 1
                        or step % self.sample_every == 0)

    def mark_sampled(self) -> None:
        """Force the current step to be a sampled one (the loop closes
        dispatch anyway — log-cadence loss fetch, monitored-twin
        compile — so the device close is free attribution)."""
        self.sampled = True

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self._acc[name] = self._acc.get(name, 0.0) \
                + (self._clock() - t0)

    def observe_phase(self, name: str, seconds: float) -> None:
        """Record an externally-timed phase duration (e.g. an eval pass
        driven outside the step loop) into the same histograms."""
        if self._step is not None:
            self._acc[name] = self._acc.get(name, 0.0) + float(seconds)
        elif self._registry is not None:
            self._registry.histogram(f"phase/{name}").observe(seconds)

    def end_step(self) -> Dict[str, float]:
        """Close the step: returns `{phase: seconds, "other": residual,
        "wall": total, "step": n}` — ALWAYS per-step (the goodput
        account attributes every step's wall-clock). Histogram
        observation and the exportable row are per WINDOW: the step's
        phases merge into a pending window, and only a sampled step
        flushes it — window sums into the `phase/*` histograms and into
        `self.last_row` (None off-sample). Off-sample steps therefore
        cost two dict merges, no registry locks, no row. A second call
        without `begin_step` raises — a skipped begin means the numbers
        would silently belong to the wrong step."""
        if self._step is None:
            raise RuntimeError("end_step without begin_step")
        wall = self._clock() - self._t0
        tracked = sum(self._acc.values())
        out = dict(self._acc)
        out["other"] = max(wall - tracked, 0.0)
        out["wall"] = wall
        out["step"] = float(self._step)
        for name, dt in out.items():
            if name != "step":
                self._window[name] = self._window.get(name, 0.0) + dt
        if self.sampled:
            row = dict(self._window)
            row["step"] = float(self._step)
            if self._registry is not None:
                for name, dt in row.items():
                    if name in ("wall", "step"):
                        continue
                    self._registry.histogram(f"phase/{name}").observe(dt)
                self._registry.histogram("phase/wall").observe(row["wall"])
            self.last_row = row
            self._window = {}
        else:
            self.last_row = None
        if self._meter is not None and out.get("device", 0.0) > 0.0:
            # in sampled mode one device close covers every step since
            # the previous one: feed the meter the covered-step count so
            # mean_step_time / mfu_device keep per-step (window) meaning
            self._meter.observe(out["device"],
                                steps=max(self._steps_since_device, 1))
        if out.get("device", 0.0) > 0.0:
            self._steps_since_device = 0
        self.last = out
        self._step = None
        return out
