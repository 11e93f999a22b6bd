"""Batched sampler scheduler: thread-safe admission, micro-batch
rounds with continuous admission, bounded in-flight dispatch, deadline
shedding, and per-request SLO telemetry (counterpart of
``flaxdiff_tpu/serving/scheduler.py``).

Architecture (docs/SERVING.md):

- **submit()** enqueues a `SampleRequest` and returns a `ServingFuture`
  immediately. Overload is shed at the door (`max_queue`), deadlines
  are shed at dispatch time — both *before* any compute is spent,
  counted at `serving/shed`.
- A single **dispatch loop** drains the queue in rounds. Each round
  serves one compatibility group (least-recently-served for fairness),
  admits queued requests into the group's free capacity, pads the
  batch to a bucket, and advances every row by up to
  `round_steps` of its OWN trajectory through the engine's cached
  program, on the pipeline's device. Rows that complete exit mid-group
  ("continuous admission"):
  a 10-NFE request batched with a 50-NFE one returns after its own
  rounds, and its slot is refilled from the queue.
- Completed rows are handed (still device-resident, dispatch still
  async) to a **completion thread** that performs the only host syncs
  — `_block_until_ready` + `_device_get`, module-level seams so tests
  can count them. On the card the dispatch thread records a CUDA event
  after the terminal program; the completion thread waits on that event
  (a blocking-sync event: it sleeps without the GIL rather than spin)
  and copies the samples out on a side stream, so the copy does not
  queue behind rounds dispatched since. The dispatch
  loop keeps at most `max_inflight` completed batches in flight;
  beyond that it waits (genuine backpressure, counted at
  `serving/backpressure_waits`) instead of racing the device.
- **close(drain=True)** stops admission, finishes queued + active
  work, and joins both threads.

Failure semantics (docs/SERVING.md "Failure semantics",
serving/supervision.py): every round and completion fetch is a fault
barrier — a failing round poisons only its group, suspect requests are
convicted by binary-search solo re-runs (deterministic given seed),
innocent rows requeue with bounded attempts + backoff, device loss
drains and rebuilds the engine (prewarmed) under an
`EngineSupervisor`, and brownout degradation turns quality knobs
before anything is shed. A sticky CUDA error classifies as device loss
too; its context cannot serve again, so when the rebuild itself fails
every pending future fails with a typed `ServingFault` and the scheduler
closes. No future is ever stranded: results, `DeadlineExceeded`,
`SchedulerClosed`, or a typed `ServingFault` — even if a scheduler thread
dies (chaos-tested).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..resilience import faults as _faults
from ..resilience.events import record_event
from ..resilience.retry import RetryPolicy
from ..telemetry.reqtrace import RequestTracer
from .engine import (DEFAULT_BATCH_BUCKETS, RequestState,
                     SamplerProgramEngine, bucket_up, nfe_bucket)
from .request import (DeadlineExceeded, SampleRequest, SampleResult,
                      SchedulerClosed, ServingFuture)
from .supervision import (BrownoutConfig, BrownoutPolicy, DeviceLost,
                          DRAINING, EngineSupervisor, SERVING,
                          ServingFault, classify)

# Millisecond-scale SLO latency buckets (the registry default bounds
# are seconds-scale training phases).
MS_BUCKET_BOUNDS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0, 120000.0,
    300000.0)


# The scheduler's host-sync + clock primitives, module-level so tests
# can monkeypatch counting wrappers: the dispatch loop itself must never
# block on device work.

class _Ready:
    """A completed batch on the card: the samples and the event the
    dispatch thread recorded on its stream right after the work that
    makes them."""

    __slots__ = ("out", "event")

    def __init__(self, out: torch.Tensor, event):
        self.out = out
        self.event = event


def _record_ready(out):
    """What the dispatch thread hands the completion thread: a CUDA
    tensor with its event, anything else (host arrays) as it is."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        event = torch.cuda.Event(blocking=True)
        event.record(torch.cuda.current_stream(out.device))
        return _Ready(out, event)
    return out


def _block_until_ready(x) -> None:
    """Wait (without the GIL) until `x` is computed: its event, or for a
    bare CUDA tensor the current stream."""
    if isinstance(x, _Ready):
        x.event.synchronize()
    elif isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def _device_get(x) -> np.ndarray:
    """The samples as a host array. A card's are copied on a side stream
    into pinned memory after its event: on the dispatch thread's stream
    the copy would wait for every round dispatched since."""
    if isinstance(x, _Ready):
        out = x.out
        side = torch.cuda.Stream(device=out.device)
        side.wait_event(x.event)
        with torch.cuda.stream(side):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(side)
        done.synchronize()
        return np.array(host.numpy())
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _now() -> float:
    return time.perf_counter()


@dataclasses.dataclass
class SchedulerConfig:
    """Knobs for the dispatch loop.

    round_steps: trajectory steps advanced per round (the cached
      program's scan length). 0 = run-to-completion: one round runs a
      group's whole (power-of-two-bucketed) max NFE — lowest overhead,
      but a short request then waits for the longest row in its round.
    batch_buckets: padded batch sizes; max(batch_buckets) caps rows
      per round.
    max_queue: admission cap; submits past it are shed at the door.
    max_inflight: completed batches allowed in flight to the
      completion thread before the dispatch loop backpressures.
    drain_timeout_s: how long close() waits for each thread.
    retry: bounded requeue budget + backoff schedule for
      failed-but-innocent requests (resilience/retry.py); a request's
      `attempts`-th failure requeues with `delays()[attempts-1]` of
      backoff until `max_attempts` is reached, then its future fails
      with `ServingFault(kind="retries_exhausted")`. Jitter is off by
      default so chaos replays are exactly deterministic.
    brownout: degradation thresholds (serving/supervision.py), or
      None to disable degrade-before-shed entirely.
    """
    round_steps: int = 8
    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    max_queue: int = 256
    max_inflight: int = 2
    drain_timeout_s: float = 120.0
    retry: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=2.0, jitter=0.0))
    brownout: Optional[BrownoutConfig] = dataclasses.field(
        default_factory=BrownoutConfig)


@dataclasses.dataclass
class _Pending:
    """One queued request: the effective (possibly brownout-degraded)
    request, its future, submit timestamp, trace accumulator, failed
    attempts so far, original pre-degradation request, earliest
    re-dispatch time (retry backoff), and degradation flags."""
    req: SampleRequest
    fut: ServingFuture
    t_sub: float
    trace: Any = None
    attempts: int = 0
    orig_req: Optional[SampleRequest] = None
    not_before: float = 0.0
    degraded: Tuple[str, ...] = ()


class ServingScheduler:
    """Thread-safe request scheduler over a `SamplerProgramEngine`.

    Pass `autostart=False` to submit requests before the first round
    (tests use this to pin grouping deterministically), then `start()`.
    """

    def __init__(self, pipeline=None, engine=None,
                 config: Optional[SchedulerConfig] = None,
                 telemetry=None, autostart: bool = True,
                 engine_factory=None, noise_factory=None):
        if telemetry is None:
            from ..telemetry import global_telemetry
            telemetry = global_telemetry()
        if engine is None:
            if pipeline is None:
                raise ValueError("need a pipeline or an engine")
            engine = SamplerProgramEngine(pipeline, telemetry=telemetry,
                                          noise_factory=noise_factory)
            if engine_factory is None:
                # device loss tears the whole program cache down with
                # the engine — a fresh engine over the same pipeline is
                # the rebuild unit
                engine_factory = lambda: SamplerProgramEngine(  # noqa: E731
                    pipeline, telemetry=telemetry, noise_factory=noise_factory)
        self.engine = engine
        # None means device loss cannot rebuild: interrupted futures
        # fail with ServingFault(kind="device_lost") instead of hanging
        self.engine_factory = engine_factory
        self.config = config or SchedulerConfig()
        self.telemetry = telemetry
        # request-scoped tracing (telemetry/reqtrace.py): every call is
        # a no-op on a hub without a trace recorder, and a traced run
        # performs the IDENTICAL seam-counted host syncs as an untraced
        # one (counting-mock tested) — tracing is host bookkeeping only
        self.tracer = RequestTracer(telemetry)
        self.supervisor = EngineSupervisor(telemetry)
        self.brownout = (BrownoutPolicy(self.config.brownout, telemetry)
                         if self.config.brownout is not None else None)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: Deque[_Pending] = deque()
        self._active: Dict[tuple, List[RequestState]] = {}
        self._completions: Deque[Tuple[List[RequestState], object, float]] \
            = deque()
        self._last_served: Dict[tuple, int] = {}
        self._round_no = 0
        self._closed = False
        self._draining = False
        self._dispatch_done = False
        self._processing = False     # completion thread mid-batch
        self._prewarm_args = None    # (protos, round_steps, buckets)

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serving-dispatch",
            daemon=True)
        self._completer = threading.Thread(
            target=self._completion_loop, name="serving-complete",
            daemon=True)
        self._started = False
        if autostart:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def prewarm(self, reqs: List[SampleRequest]) -> Dict[str, float]:
        """Startup hook: run the programs the given traffic prototypes
        will hit — every (bucket, NFE, plan) under this scheduler's
        `round_steps`/`batch_buckets` config — BEFORE admission opens,
        so first-call costs never hit user traffic. Call
        before (or after) `start()`, but before submitting; delegates
        to `SamplerProgramEngine.prewarm`. The prototypes are recorded:
        an engine rebuild after device loss replays the same prewarm,
        so rebuilt traffic also finds its programs built."""
        self._prewarm_args = (list(reqs), self.config.round_steps,
                              self.config.batch_buckets)
        return self.engine.prewarm(reqs, self.config.round_steps,
                                   self.config.batch_buckets)

    def start(self) -> "ServingScheduler":
        if not self._started:
            self._started = True
            self._dispatcher.start()
            self._completer.start()
        return self

    def __enter__(self) -> "ServingScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admission; with drain, finish queued + active work
        first. Idempotent."""
        timeout = self.config.drain_timeout_s if timeout is None else timeout
        with self._cv:
            self._closed = True
            self._draining = drain
            if not drain or not self._started:
                # nothing will ever drain an unstarted scheduler —
                # resolve pending futures instead of leaving waiters
                # hanging
                for e in self._queue:
                    e.fut.set_exception(SchedulerClosed("scheduler closed"))
                self._queue.clear()
                for rows in self._active.values():
                    for r in rows:
                        r.future.set_exception(
                            SchedulerClosed("scheduler closed"))
                self._active.clear()
            self._cv.notify_all()
        if self._started:
            self._dispatcher.join(timeout)
        with self._cv:
            self._dispatch_done = True
            self._cv.notify_all()
        if self._started:
            self._completer.join(timeout)

    # -- pool introspection (serving/replica.py) ------------------------------
    # Host-side accessors for the replica/front-door layer: routing
    # reads these on every submit, so they must stay lock-bounded
    # bookkeeping — no device work, no blocking waits.
    @property
    def closed(self) -> bool:
        """True once close() (or a thread-death sweep) stopped
        admission — the replica layer's DEAD signal."""
        return self._closed

    def queue_depth(self) -> int:
        """Queued (not yet dispatched) requests right now."""
        with self._lock:
            return len(self._queue)

    def load(self) -> int:
        """Total requests this scheduler is responsible for: queued +
        active rows + completed batches awaiting the host fetch. The
        front door's least-loaded routing key."""
        with self._lock:
            n = len(self._queue)
            for rows in self._active.values():
                n += len(rows)
            for rows, _, _ in self._completions:
                n += len(rows)
            return n

    def cancel(self, fut: ServingFuture) -> bool:
        """Best-effort cancel of a QUEUED request by its future — the
        front door reaps a hedge loser with this before it costs any
        compute. A request already dispatched (active or in flight to
        the completion thread) is not cancellable; first-set-wins on
        the future makes its late result harmless. Returns True when a
        queued entry was removed."""
        with self._cv:
            hit = False
            kept: Deque = deque()
            for e in self._queue:
                if e.fut is fut and not hit:
                    hit = True
                    self.telemetry.counter("serving/cancelled").inc()
                    self.tracer.shed(e.trace, "cancelled", _now())
                    e.fut.set_exception(
                        SchedulerClosed("cancelled by caller"))
                else:
                    kept.append(e)
            if hit:
                self._queue = kept
                self.telemetry.gauge("serving/queue_depth").set(
                    len(self._queue))
            return hit

    # -- admission ------------------------------------------------------------
    def submit(self, req: SampleRequest,
               trace_ctx=None) -> ServingFuture:
        """Enqueue one request. Never blocks: overload and post-close
        submits come back as exceptions on the returned future.
        Brownout degradation applies here, at the admission door: under
        queue pressure or recent faults the request is downgraded (NFE
        cap, forced cache plan) instead of shed — the effective request
        determines grouping, and the result carries the flags.
        `trace_ctx` (a `RequestTracer.context` dict) joins this hop's
        spans to an upstream trace — the front door passes its minted
        id so one trace spans door -> replica -> serving rounds."""
        fut = ServingFuture()
        tel = self.telemetry
        with self._cv:
            if self._closed:
                fut.set_exception(SchedulerClosed("scheduler closed"))
                return fut
            tel.counter("serving/requests_in").inc()
            t_sub = _now()
            tr = self.tracer.begin(req, t_sub,   # None on disabled hub
                                   parent=trace_ctx)
            if len(self._queue) >= self.config.max_queue:
                tel.counter("serving/shed").inc()
                self.tracer.shed(tr, "queue_full", _now())
                fut.set_exception(DeadlineExceeded(
                    f"queue full ({self.config.max_queue})"))
                return fut
            req_eff, flags = req, ()
            if self.brownout is not None:
                tier = self.brownout.tier(len(self._queue),
                                          self.config.max_queue, t_sub)
                req_eff, flags = self.brownout.apply(req, tier)
                if flags:
                    self.tracer.note(tr, "brownout", t_sub, tier=tier,
                                     flags=list(flags))
            self._queue.append(_Pending(req_eff, fut, t_sub, tr,
                                        orig_req=req, degraded=flags))
            tel.gauge("serving/queue_depth").set(len(self._queue))
            self._cv.notify_all()
        return fut

    # -- dispatch loop --------------------------------------------------------
    def _shed_expired_locked(self) -> None:
        """Drop queued requests whose deadline already passed — before
        any compute is spent on them (held lock)."""
        if not self._queue:
            return
        now = _now()
        kept: Deque = deque()
        for e in self._queue:
            if e.req.deadline_s is not None \
                    and now - e.t_sub > e.req.deadline_s:
                self.telemetry.counter("serving/shed").inc()
                self.tracer.shed(e.trace, "deadline", now)
                e.fut.set_exception(DeadlineExceeded(
                    f"deadline {e.req.deadline_s}s passed while queued"))
            else:
                kept.append(e)
        self._queue = kept
        self.telemetry.gauge("serving/queue_depth").set(len(self._queue))

    def _shed_expired_active(self, rows: List[RequestState],
                             now: float) -> List[RequestState]:
        """Mid-flight deadline check at the round boundary: a request
        whose deadline passed BETWEEN rounds is shed before the next
        round spends more compute on it (its sunk rounds are lost, but
        nobody is waiting for the result anymore). Counted at
        `serving/shed` + `serving/shed_midflight`; the trace row closes
        with `outcome=shed:deadline`."""
        kept: List[RequestState] = []
        for r in rows:
            if r.req.deadline_s is not None \
                    and now - r.submit_t > r.req.deadline_s:
                self.telemetry.counter("serving/shed").inc()
                self.telemetry.counter("serving/shed_midflight").inc()
                self.tracer.shed(r.trace, "deadline", now)
                r.future.set_exception(DeadlineExceeded(
                    f"deadline {r.req.deadline_s}s passed mid-flight "
                    f"after {r.rounds} round(s)"))
            else:
                kept.append(r)
        return kept

    def _pick_group_locked(self) -> Optional[tuple]:
        """Least-recently-served group among those with work (active
        rows or queued requests), queue order breaking ties."""
        candidates: List[tuple] = list(self._active.keys())
        for e in self._queue:
            gk = self.engine.group_key(e.req)
            if gk not in candidates:
                candidates.append(gk)
        if not candidates:
            return None
        return min(candidates,
                   key=lambda g: self._last_served.get(g, -1))

    def _admit_locked(self, gk: tuple, capacity: int,
                      now: float) -> List[RequestState]:
        """Pop up to `capacity` queued requests of group `gk` (FIFO) and
        prepare their device carries. Requeued entries still inside
        their retry backoff window (`not_before`) are skipped."""
        admitted: List[RequestState] = []
        kept: Deque = deque()
        for e in self._queue:
            if len(admitted) < capacity and e.not_before <= now \
                    and self.engine.group_key(e.req) == gk:
                try:
                    st = self.engine.prepare(e.req, e.fut, e.t_sub, now)
                    st.trace = e.trace
                    st.attempts = e.attempts
                    st.orig_req = e.orig_req or e.req
                    st.degraded = e.degraded
                    admitted.append(st)
                except Exception as exc:  # bad request, not a loop error
                    self.tracer.shed(
                        e.trace, f"prepare_error:{type(exc).__name__}",
                        _now())
                    e.fut.set_exception(exc)
            else:
                kept.append(e)
        self._queue = kept
        self.telemetry.gauge("serving/queue_depth").set(len(self._queue))
        return admitted

    # -- fault isolation ------------------------------------------------------
    def _checked_advance(self, rows: List[RequestState], bucket: int,
                         round_steps: int):
        """One engine round behind the serving fault barriers
        (resilience/faults.py): `serving.device_lost` (flag -> raises
        `DeviceLost`) models a dead chip, `serving.round` is polled
        once per row with `key="seed:<seed>:"` so a per-key plan can
        deterministically poison ONE request no matter what it is
        batched with. One dict lookup each with no plan armed."""
        if _faults.check("serving.device_lost"):
            raise DeviceLost("injected fault at serving.device_lost")
        for r in rows:
            _faults.check("serving.round", key=f"seed:{r.req.seed}:")
        return self.engine.advance(rows, bucket, round_steps)

    def _fail_state(self, r: RequestState, fault: ServingFault,
                    outcome: str) -> None:
        """Resolve one in-flight request's future with a typed fault
        and close its trace row with the fault outcome."""
        self.tracer.fail(r, outcome, _now())
        r.future.set_exception(fault)

    def _requeue_locked(self, states: List[RequestState], now: float,
                        cause: Optional[BaseException] = None,
                        penalize: bool = True) -> None:
        """Re-enter failed-but-innocent requests into the queue for a
        replay from scratch (`SampleRequest` carries seed, NFE, and
        cache plan — `prepare` reconstructs the whole carry): bit-exact
        in whatever bucket and position it lands in (the determinism
        contract in `request.py`).
        With `penalize`, the attempt counts against the bounded retry
        budget and the re-dispatch waits out the policy's backoff;
        rebuild interruptions requeue unpenalized (the device fault was
        not theirs). Held lock.

        Close race: a non-draining `close()` sweeps the queue and
        resolves everything it can see, but rows a rebuild (or a
        fetch-fault retry) holds in a local list at that instant are
        invisible to the sweep — requeueing them afterwards would
        strand their futures with the dispatch loop already exiting.
        Resolve them here instead (chaos-tested)."""
        if self._closed and not self._draining:
            for r in states:
                self.tracer.shed(r.trace, "closed", now)
                r.future.set_exception(
                    SchedulerClosed("scheduler closed"))
            return
        retry = self.config.retry
        delays = retry.delays()
        for r in states:
            attempts = r.attempts + (1 if penalize else 0)
            if penalize and attempts >= retry.max_attempts:
                self.telemetry.counter("serving/retries_exhausted").inc()
                self._fail_state(r, ServingFault(
                    f"gave up after {attempts} attempt(s): {cause!r}",
                    kind="retries_exhausted", request=r.orig_req,
                    attempts=attempts, cause=cause),
                    "fault:retries_exhausted")
                continue
            delay = 0.0
            if penalize and delays:
                delay = delays[min(attempts - 1, len(delays) - 1)]
            self.telemetry.counter("serving/requeued").inc()
            self.tracer.note(r.trace, "requeued", now,
                             attempts=attempts,
                             backoff_s=round(delay, 3))
            self._queue.append(_Pending(
                r.orig_req or r.req, r.future, r.submit_t, r.trace,
                attempts=attempts, orig_req=r.orig_req,
                not_before=now + delay, degraded=r.degraded))
        self.telemetry.gauge("serving/queue_depth").set(len(self._queue))

    def _convict(self, rows: List[RequestState], buckets: Tuple[int, ...],
                 round_steps: int):
        """Binary-search eviction after a batch fault: requests are
        deterministic given their seed, so any suspect row can be
        re-run solo from scratch to convict. Probes re-prepare fresh
        carries (the failed round may have poisoned the old ones) and
        run ONE round through the same fault barriers; a subset that
        passes is innocent wholesale, a failing singleton is convicted.
        A transient fault that does not reproduce convicts nobody.
        Returns (guilty, innocent). `DeviceLost` during a probe
        propagates — the caller re-routes to the rebuild path."""

        def probe(subset) -> Optional[BaseException]:
            self.telemetry.counter("serving/probe_rounds").inc()
            try:
                sts = [self.engine.prepare(r.req, ServingFuture(),
                                           r.submit_t, _now())
                       for r in subset]
                self._checked_advance(
                    sts, bucket_up(len(sts), buckets), round_steps)
                return None
            except (KeyboardInterrupt, SystemExit, DeviceLost):
                raise
            except BaseException as e:  # noqa: BLE001 — verdict, not flow
                return e

        def search(subset):
            if probe(subset) is None:
                return [], list(subset)
            if len(subset) == 1:
                return list(subset), []
            mid = len(subset) // 2
            g1, i1 = search(subset[:mid])
            g2, i2 = search(subset[mid:])
            if not g1 and not g2:
                # halves pass solo but the whole failed together:
                # transient — nobody convicted, everyone requeues
                return [], list(subset)
            return g1 + g2, i1 + i2

        if len(rows) == 1:
            return search(list(rows))
        # the full batch ALREADY failed — go straight to the halves; a
        # one-shot transient then passes both and convicts nobody
        mid = len(rows) // 2
        g1, i1 = search(list(rows[:mid]))
        g2, i2 = search(list(rows[mid:]))
        if not g1 and not g2:
            return [], list(rows)
        return g1 + g2, i1 + i2

    def _on_round_failure(self, gk: tuple, rows: List[RequestState],
                          exc: BaseException, buckets: Tuple[int, ...],
                          round_steps: int) -> None:
        """Fault-isolate one failed round: classify, convict or
        rebuild, requeue the innocent. The failing round poisons only
        its own group — other groups' active rows are untouched (except
        under device loss, where every carry references a dead
        device)."""
        kind = classify(exc)
        now = _now()
        self.telemetry.counter("serving/round_faults").inc()
        record_event("serving_fault", "serving.round",
                     detail=f"{kind}: {exc!r} rows={len(rows)}")
        if self.brownout is not None:
            self.brownout.note_fault(now)
        for r in rows:
            self.tracer.note(r.trace, "round_fault", now,
                             fault_kind=kind,
                             error=type(exc).__name__)
        if kind == "device_lost":
            self._supervised_rebuild(exc, rows)
            return
        try:
            guilty, innocent = self._convict(rows, buckets, round_steps)
        except DeviceLost as e2:
            self._supervised_rebuild(e2, rows)
            return
        for r in guilty:
            self.telemetry.counter("serving/quarantined").inc()
            self.tracer.note(r.trace, "quarantined", _now())
            self._fail_state(r, ServingFault(
                f"request convicted by solo re-run after a batch "
                f"fault: {exc!r}", kind="poisoned", request=r.orig_req,
                attempts=r.attempts + 1, cause=exc), "fault:poisoned")
        with self._cv:
            self._requeue_locked(innocent, now, cause=exc)
            self._cv.notify_all()

    def _supervised_rebuild(self, exc: BaseException,
                            rows: List[RequestState]) -> None:
        """Device-level failure: drain in-flight completions, tear down
        the program cache with the dead engine, rebuild on the
        surviving device set, re-run prewarm, and requeue every
        interrupted request (unpenalized — the fault was not theirs).
        Without an `engine_factory` the interrupted futures fail typed
        instead of hanging."""
        tel = self.telemetry
        tel.counter("serving/device_lost").inc()
        record_event("serving_fault", "serving.device_lost",
                     detail=repr(exc))
        if self.brownout is not None:
            self.brownout.note_fault(_now())
        t0 = _now()
        with self._cv:
            interrupted = list(rows)
            for rs in self._active.values():
                interrupted.extend(rs)
            self._active.clear()
            # DRAINING: let the completion thread settle (or fail and
            # requeue) every batch already handed to it before the old
            # engine is torn down
            self.supervisor.set_state(DRAINING)
            while self._completions or self._processing:
                self._cv.wait(0.05)
        for r in interrupted:
            self.tracer.note(r.trace, "rebuild_interrupt", _now())
        if self.engine_factory is None:
            for r in interrupted:
                self._fail_state(r, ServingFault(
                    f"device lost and no engine_factory to rebuild: "
                    f"{exc!r}", kind="device_lost", request=r.orig_req,
                    attempts=r.attempts, cause=exc),
                    "fault:device_lost")
            self.supervisor.set_state(SERVING)
            return
        try:
            self.engine = self.supervisor.rebuild(
                self.engine_factory, exc, prewarm_args=self._prewarm_args)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — the device is gone
            # a sticky CUDA error poisons the context: the rebuild fails
            # the same way, and retrying would loop. Fail every pending
            # future typed; the closed scheduler reads as DEAD to a pool.
            record_event("serving_fault", "serving.device_lost",
                         detail=f"rebuild failed: {e!r}")
            fault = ServingFault(
                f"device lost and the rebuild failed: {e!r}",
                kind="device_lost", cause=e)
            for r in interrupted:
                self._fail_state(r, fault, "fault:device_lost")
            self._fail_all_pending(fault)
            return
        self.tracer.rebuild(t0, _now(), {
            "reason": type(exc).__name__,
            "interrupted": len(interrupted),
            "prewarmed": bool(self._prewarm_args)})
        with self._cv:
            self._requeue_locked(interrupted, _now(), cause=exc,
                                 penalize=False)
            self._cv.notify_all()

    def _fail_all_pending(self, fault: ServingFault) -> None:
        """Last-resort sweep when a scheduler thread dies: every
        queued and in-flight future resolves (first set wins, so a
        result the completion thread is delivering concurrently is
        never clobbered)."""
        with self._cv:
            self._closed = True
            # a completion thread dying mid-batch must not leave the
            # rebuild DRAINING wait spinning on `_processing`
            self._processing = False
            for e in self._queue:
                e.fut.set_exception(fault)
            self._queue.clear()
            for rows in self._active.values():
                for r in rows:
                    self._fail_state(r, fault, f"fault:{fault.kind}")
            self._active.clear()
            for rows, _, _ in self._completions:
                for r in rows:
                    self._fail_state(r, fault, f"fault:{fault.kind}")
            self._completions.clear()
            self._cv.notify_all()

    def _dispatch_loop(self) -> None:
        """Crash guard around the real loop: a dying dispatch thread
        must fail every pending future typed, never strand them
        (regression-tested)."""
        try:
            self._dispatch_rounds()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — last-resort guard
            record_event("serving_fault", "serving.dispatch",
                         detail=f"dispatch thread died: {e!r}")
            self._fail_all_pending(ServingFault(
                f"dispatch thread died: {e!r}", kind="scheduler_died",
                cause=e))

    def _dispatch_rounds(self) -> None:
        tel = self.telemetry
        cfg = self.config
        while True:
            with self._cv:
                while not (self._queue or self._active or self._closed):
                    self._cv.wait()
                if self._closed and not self._draining:
                    break
                self._shed_expired_locked()
                gk = self._pick_group_locked()
                if gk is None:
                    if self._closed and not self._completions \
                            and not self._processing:
                        # a draining close may still see a fetch-fault
                        # requeue from the completion thread — only
                        # exit once nothing in flight can re-enter
                        break
                    self._cv.wait(0.02)
                    continue
                now = _now()
                # brownout tier 3: shrink rounds to the smallest bucket
                # (smaller blast radius + memory footprint) before any
                # shedding happens
                tier = (self.brownout.tier(len(self._queue),
                                           cfg.max_queue, now)
                        if self.brownout is not None else 0)
                buckets = cfg.batch_buckets
                if tier >= 3:
                    buckets = (min(cfg.batch_buckets),)
                max_bucket = max(buckets)
                rows = self._shed_expired_active(
                    self._active.pop(gk, []), now)
                if len(rows) > max_bucket:
                    # bucket shrink mid-group: overflow rows stay
                    # active and ride the group's next round
                    self._active[gk] = rows[max_bucket:]
                    rows = rows[:max_bucket]
                rows += self._admit_locked(gk, max_bucket - len(rows),
                                           now)
                if not rows:
                    # group had only backoff-parked entries (or every
                    # row was shed): wait for the earliest retry
                    self._cv.wait(0.02)
                    continue
                if tier >= 3:
                    tel.counter("serving/brownout_bucket_shrunk").inc()
                self._round_no += 1
                self._last_served[gk] = self._round_no

            bucket = bucket_up(len(rows), buckets)
            round_steps = cfg.round_steps or nfe_bucket(
                max(r.remaining for r in rows))
            tel.gauge("serving/batch_occupancy").set(len(rows) / bucket)
            tel.counter("serving/rows_real").inc(len(rows))
            tel.counter("serving/rows_padded").inc(bucket - len(rows))
            tel.counter("serving/rounds").inc()
            t_disp = _now()
            for r in rows:
                if r.first_dispatch_t is None:
                    r.first_dispatch_t = t_disp

            try:
                finished, _ = self._checked_advance(rows, bucket,
                                                    round_steps)
                if self.tracer.enabled:
                    # host timestamps + host-side dicts only: tracing
                    # must not add a single device sync to the
                    # dispatch loop
                    self.tracer.round(
                        rows,
                        getattr(self.engine, "last_round_info", None),
                        t_disp, _now(), self._round_no)
                live = [r for r in rows if r.remaining > 0]
                if finished:
                    t_fin = _now()
                    out, _ = self.engine.finalize(
                        finished, bucket_up(len(finished), buckets))
                    out = _record_ready(out)
                    if self.tracer.enabled:
                        self.tracer.finalize(
                            finished,
                            getattr(self.engine,
                                    "last_finalize_info", None),
                            t_fin, _now())
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — fault barrier
                # the failing round poisons only its group: convict /
                # requeue / rebuild, then keep serving everyone else
                self._on_round_failure(gk, rows, e, buckets,
                                       round_steps)
                continue
            with self._cv:
                if live:
                    self._active.setdefault(gk, []).extend(live)
                if finished:
                    self._completions.append((finished, out, _now()))
                    self._cv.notify_all()
                    # bounded in-flight dispatch: never race more than
                    # max_inflight completed batches ahead of the
                    # completion thread's host sync
                    while len(self._completions) > cfg.max_inflight:
                        tel.counter("serving/backpressure_waits").inc()
                        self._cv.wait()
        # non-draining close: rows popped mid-round missed close()'s
        # cancel sweep — resolve their futures before exiting
        with self._cv:
            for rows in self._active.values():
                for r in rows:
                    r.future.set_exception(
                        SchedulerClosed("scheduler closed"))
            self._active.clear()
            for e in self._queue:
                e.fut.set_exception(SchedulerClosed("scheduler closed"))
            self._queue.clear()

    # -- completion loop ------------------------------------------------------
    def _completion_loop(self) -> None:
        """Crash guard around the real loop (mirrors the dispatch
        guard): a dying completion thread fails every pending future
        typed and unblocks the dispatch loop's backpressure wait."""
        try:
            self._completion_rounds()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — last-resort guard
            record_event("serving_fault", "serving.complete",
                         detail=f"completion thread died: {e!r}")
            self._fail_all_pending(ServingFault(
                f"completion thread died: {e!r}", kind="scheduler_died",
                cause=e))

    def _completion_rounds(self) -> None:
        tel = self.telemetry

        def hist(name: str):
            return tel.histogram(name, bounds=MS_BUCKET_BOUNDS)

        while True:
            with self._cv:
                while not self._completions and not self._dispatch_done:
                    self._cv.wait()
                if not self._completions and self._dispatch_done:
                    break
                rows, out, _t_disp = self._completions.popleft()
                self._processing = True
                self._cv.notify_all()     # free a backpressure slot
            try:
                # serving.fetch fault barrier: a failed readback is a
                # fault of the FETCH, not of any request — the batch
                # requeues for a replay from scratch
                _faults.check("serving.fetch")
                _block_until_ready(out)
                host = _device_get(out)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — fault barrier
                tel.counter("serving/fetch_faults").inc()
                record_event("serving_fault", "serving.fetch",
                             detail=repr(e))
                now = _now()
                if self.brownout is not None:
                    self.brownout.note_fault(now)
                for r in rows:
                    self.tracer.note(r.trace, "fetch_fault", now,
                                     error=type(e).__name__)
                with self._cv:
                    if self._dispatch_done:
                        # nothing left to serve a requeue — fail typed
                        for r in rows:
                            self._fail_state(r, ServingFault(
                                f"completion fetch failed after "
                                f"dispatch ended: {e!r}",
                                kind="fetch_error", request=r.orig_req,
                                attempts=r.attempts, cause=e),
                                "fault:fetch_error")
                    else:
                        self._requeue_locked(rows, now, cause=e)
                    self._processing = False
                    self._cv.notify_all()
                continue
            t_ready = _now()
            for i, r in enumerate(rows):
                latency_ms = (t_ready - r.submit_t) * 1e3
                queue_ms = ((r.first_dispatch_t or r.submit_t)
                            - r.submit_t) * 1e3
                device_ms = max(0.0, latency_ms - queue_ms - r.compile_ms)
                hist("serving/latency_ms").observe(latency_ms)
                hist("serving/queue_ms").observe(queue_ms)
                hist("serving/compile_ms").observe(r.compile_ms)
                hist("serving/device_ms").observe(device_ms)
                tel.counter("serving/requests_ok").inc()
                # the trace row carries the SAME decomposition the
                # histograms above observed — per-request span sums
                # reconcile with the aggregates by construction
                self.tracer.complete(r, queue_ms, r.compile_ms,
                                     device_ms, latency_ms, t_ready)
                r.future.set_result(SampleResult(
                    samples=host[i], request=r.req, queue_ms=queue_ms,
                    compile_ms=r.compile_ms, device_ms=device_ms,
                    latency_ms=latency_ms, rounds=r.rounds,
                    attempts=r.attempts, degraded=r.degraded))
            with self._cv:
                self._processing = False
                self._cv.notify_all()
