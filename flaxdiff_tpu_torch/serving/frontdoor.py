"""Replicated front door: health-checked routing, replica failover,
hedged retries, and pool-wide admission over a `ReplicaPool`
(counterpart of ``flaxdiff_tpu/serving/frontdoor.py``; docs/SERVING.md
"Front door").

One `FrontDoor.submit()` serves a pool of N independent
`ServingScheduler` + `EngineSupervisor` replicas (serving/replica.py).
The door owns what no single scheduler can:

- **Health-checked routing**: every submit routes to the least-loaded
  replica in the best available health class (HEALTHY before DEGRADED
  before REBUILDING; DEAD never). Health is derived host-side from
  supervisor state, the door-observed fault-rate EWMA, and queue depth.
- **Replica failover**: a request whose replica dies (killed, closed,
  scheduler thread death) or exhausts its local retries is re-routed
  to a surviving replica and replays from scratch — `SampleRequest`
  carries seed/NFE/plan, so the replay is bit-exact (the determinism
  contract, `request.py`). A cross-replica attempt budget bounds the loop; when it runs
  out, or no routable replica remains (ALL replicas dead), the door
  future resolves with `ServingFault(kind="pool_exhausted")` — never
  stranded.
- **Hedged retries**: with a `HedgePolicy`, a request still unresolved
  past the door's observed latency percentile is dispatched a second
  time to a DIFFERENT replica. First set wins on the door's
  `ServingFuture` (its existing semantics ARE the hedge primitive); the
  loser is cancelled if still queued (`ServingScheduler.cancel`) and
  its late result is harmlessly ignored otherwise. Deterministic seeds
  make both arms the same request, bit for bit in any bucket (the
  determinism contract), so a hedge improves latency, not the answer
  (chaos-tested).
- **Pool-level admission + coordinated brownout**: one door-level
  pending bound (`max_pending`, shed with `DeadlineExceeded` like the
  scheduler door), plus a shared `BrownoutPolicy` driven by POOL-WIDE
  pressure (total replica load over total capacity, which shrinks as
  replicas die) — degradation escalates for the whole fleet at once
  instead of per-replica.

Observability (docs/OBSERVABILITY.md "Trace propagation"): the door
mints one trace id per request and PROPAGATES it into the routed
replica's scheduler (`Replica.submit(trace_ctx=...)`), so door-phase
spans (`door.route` / `door.attempt` / `door.failover` / `door.hedge`)
and the replica's `req.queue`/`req.serve` spans share one Chrome lane.
The non-overlapping door phases tile [submit, delivery] at SHARED
timestamps, so their sums reconcile with `frontdoor/latency_ms`
exactly. An online `SloEngine` (telemetry/slo.py) attributes every
terminal outcome to the request's tenant budget and to a per-replica
`replica:<name>` series; burn rates drive `BrownoutPolicy.tier_for`
(over-budget tenants degrade first) and a routing penalty (a replica
burning its delivery objective ranks behind peers in its health class).

The chaos site `serving.replica_lost` (resilience/faults.py) is polled
once per replica per submission with key="replica:<name>:"; a firing
kills that replica mid-traffic — the deterministic lever of the pool
chaos tests and of `chip_smoke.py`'s front-door phase.

Sync-free contract: this file performs NO host synchronization and
never imports torch — routing, failover, and hedging are pure host
bookkeeping. All device work stays inside the replicas' schedulers
behind their sync seams. On one card the replicas share the device
(each with its own scheduler and engine over the pipeline's weights):
what the pool adds there is routing, failover and hedging, not speed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set, Tuple

from ..resilience import faults as _faults
from ..resilience.events import record_event
from ..telemetry.reqtrace import RequestTracer
from ..telemetry.slo import SloConfig, SloEngine
from .replica import DEAD, HEALTH_RANK, Replica
from .request import (DeadlineExceeded, SampleRequest, SampleResult,
                      SchedulerClosed, ServingFuture)
from .scheduler import MS_BUCKET_BOUNDS
from .supervision import BrownoutConfig, BrownoutPolicy, ServingFault


def _now() -> float:
    return time.perf_counter()


def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile, on the host's list."""
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round((q / 100.0) * (len(s) - 1)))))
    return s[k]


# ServingFault kinds that are the REQUEST's own deterministic fault: a
# replay on another replica fails identically, so the door
# relays them instead of failing over.
_TERMINAL_FAULT_KINDS = frozenset({"poisoned"})


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """When to dispatch a second attempt of the same request.

    percentile: hedge a request whose door-side age exceeds this
      percentile of recently observed door latencies.
    after_ms: fixed threshold used until `min_observations` latencies
      have been observed (None = no hedging during warmup).
    min_observations: samples needed before the percentile is trusted.
    deadline_only: hedge only requests that carry a `deadline_s`
      (the "deadline-risk" subset); False hedges any aged request.
    window: observed-latency ring size the percentile is computed over.
    """
    percentile: float = 95.0
    after_ms: Optional[float] = None
    min_observations: int = 8
    deadline_only: bool = False
    window: int = 256


@dataclasses.dataclass
class FrontDoorConfig:
    """Knobs for the routing/failover layer.

    max_pending: door-level admission bound — submits past it are shed
      with `DeadlineExceeded` before any routing work.
    max_attempts: cross-replica attempt budget — TOTAL submissions
      (first route + failovers) per request before
      `ServingFault(kind="pool_exhausted")`.
    poll_interval_s: monitor thread scan cadence (host-side only).
    hedge: `HedgePolicy`, or None to disable hedged retries.
    brownout: pool-wide degradation thresholds applied at the door
      against pool pressure, or None to disable.
    slo: online error-budget engine config (telemetry/slo.py), or None
      to disable per-tenant SLO accounting, burn-rate brownout shaping,
      and the SLO routing penalty.
    """
    max_pending: int = 512
    max_attempts: int = 3
    poll_interval_s: float = 0.005
    drain_timeout_s: float = 120.0
    hedge: Optional[HedgePolicy] = None
    brownout: Optional[BrownoutConfig] = dataclasses.field(
        default_factory=BrownoutConfig)
    slo: Optional[SloConfig] = dataclasses.field(
        default_factory=SloConfig)


class ReplicaPool:
    """Named replicas + the routing policy over them: least-loaded
    within the best available health class."""

    def __init__(self, replicas: Sequence[Replica]):
        if not replicas:
            raise ValueError("need at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas: List[Replica] = list(replicas)

    def get(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    def health(self) -> Dict[str, str]:
        return {r.name: r.health() for r in self.replicas}

    def load(self) -> int:
        return sum(r.load() for r in self.replicas)

    def capacity(self) -> int:
        """Total admission capacity of the LIVE replicas — the brownout
        denominator, which shrinks as replicas die so pool pressure
        rises even at constant offered load."""
        return sum(r.scheduler.config.max_queue for r in self.replicas
                   if r.health() != DEAD)

    def route(self, exclude: Set[str] = frozenset(),
              weigh=None) -> Optional[Replica]:
        """Least-loaded routable replica outside `exclude`, preferring
        healthier classes; None when nothing is routable. `weigh`
        (optional, `callable(Replica) -> orderable`) inserts a penalty
        between the health class and the load — the front door passes
        its SLO engine's per-replica burn hint here, so a replica
        burning its delivery objective ranks behind its peers WITHIN a
        health class but never out-ranks health itself."""
        best: Optional[Tuple[tuple, Replica]] = None
        for r in self.replicas:
            if r.name in exclude:
                continue
            h = r.health()
            if h == DEAD:
                continue
            key = (HEALTH_RANK[h],
                   weigh(r) if weigh is not None else 0,
                   r.load(), r.name)
            if best is None or key < best[0]:
                best = (key, r)
        return best[1] if best else None

    def kill(self, name: str, cause: str = "replica_lost") -> None:
        self.get(name).kill(cause)

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        for r in self.replicas:
            r.close(drain=drain, timeout=timeout)


class _DoorReq:
    """Door-side state for one in-flight request: the door future, the
    live attempt arms (at most primary + one hedge), the cross-replica
    attempt count, and the trace accumulator. Mutated only by the
    monitor thread once submitted."""

    __slots__ = ("req", "req_eff", "fut", "trace", "t_sub", "flags",
                 "attempts", "tried", "arms", "hedged", "rounds",
                 "degraded", "t_open", "seg", "attempt_no")

    def __init__(self, req, req_eff, fut, trace, t_sub, flags):
        self.req = req
        self.req_eff = req_eff
        self.fut = fut
        self.trace = trace
        self.t_sub = t_sub
        self.flags: Tuple[str, ...] = tuple(flags)
        self.attempts = 0           # failovers beyond the first route
        self.tried: Set[str] = set()
        # each arm: {"rep": Replica, "fut": ServingFuture, "role": str,
        #            "t0": route timestamp (the door.hedge span start)}
        self.arms: List[Dict[str, Any]] = []
        self.hedged = False
        self.rounds = 0             # for the tracer's complete() row
        self.degraded: Tuple[str, ...] = ()
        # open door-phase segment: [t_open, <next transition>) is a
        # `door.<seg>` span; segments tile [t_sub, delivery] at shared
        # timestamps so phase sums reconcile with latency exactly
        self.t_open = t_sub
        self.seg = "attempt"
        self.attempt_no = 1


class FrontDoor:
    """One submit() API over a `ReplicaPool`.

    A single monitor thread watches every in-flight door request:
    relays replica results onto the door future (first set wins),
    fails over re-routable faults, triggers hedges, and enforces the
    door-level deadline — so `submit()` itself never blocks and the
    replicas never know they have siblings.
    """

    def __init__(self, pool, config: Optional[FrontDoorConfig] = None,
                 telemetry=None, autostart: bool = True):
        if not isinstance(pool, ReplicaPool):
            pool = ReplicaPool(list(pool))
        self.pool = pool
        self.config = config or FrontDoorConfig()
        if telemetry is None:
            from ..telemetry import global_telemetry
            telemetry = global_telemetry()
        self.telemetry = telemetry
        self.tracer = RequestTracer(telemetry, prefix="door")
        self.brownout = (BrownoutPolicy(self.config.brownout, telemetry)
                         if self.config.brownout is not None else None)
        self.slo = (SloEngine(self.config.slo, telemetry)
                    if self.config.slo is not None else None)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries: List[_DoorReq] = []
        self._closed = False
        hp = self.config.hedge
        self._lat: Deque[float] = deque(maxlen=hp.window if hp else 256)
        self._last_health: Dict[str, str] = {}

        self._monitor = threading.Thread(
            target=self._monitor_loop, name="frontdoor-monitor",
            daemon=True)
        self._started = False
        if autostart:
            self.start()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "FrontDoor":
        if not self._started:
            self._started = True
            self._monitor.start()
        return self

    def __enter__(self) -> "FrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def prewarm(self, reqs: List[SampleRequest]) -> Dict[str, float]:
        """Prewarm EVERY replica with the same traffic prototypes, so
        any routing (or failover) target serves warm from the first
        request. Returns the slowest replica's timing summary."""
        out: Dict[str, float] = {}
        for r in self.pool.replicas:
            out = r.prewarm(reqs) or out
        return out

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admission; with drain, let every in-flight door request
        resolve first (the monitor keeps failing over / relaying until
        the pending set is empty), then close the replicas. Without
        drain, pending door futures resolve with `SchedulerClosed`
        immediately. Idempotent."""
        timeout = (self.config.drain_timeout_s if timeout is None
                   else timeout)
        with self._cv:
            self._closed = True
            if not drain or not self._started:
                self._sweep_locked(SchedulerClosed("front door closed"))
            self._cv.notify_all()
        if self._started:
            self._monitor.join(timeout)
        self.pool.close(drain=drain, timeout=timeout)

    # -- admission ------------------------------------------------------------
    def submit(self, req: SampleRequest) -> ServingFuture:
        """Route one request into the pool. Never blocks; overload,
        post-close submits, and an all-dead pool come back as
        exceptions on the returned future."""
        fut = ServingFuture()
        tel = self.telemetry
        now = _now()
        # chaos lever: one poll per replica per submission — a per_key
        # plan kills a chosen replica at a chosen submission count,
        # deterministically (resilience/faults.py serving.replica_lost)
        for r in self.pool.replicas:
            if r.health() != DEAD and _faults.check(
                    "serving.replica_lost", key=f"replica:{r.name}:"):
                tel.counter("frontdoor/replica_lost").inc()
                r.kill("injected fault at serving.replica_lost")
                if self.brownout is not None:
                    self.brownout.note_fault(now)
        with self._cv:
            if self._closed:
                fut.set_exception(SchedulerClosed("front door closed"))
                return fut
            tel.counter("frontdoor/requests_in").inc()
            tr = self.tracer.begin(req, now)
            if len(self._entries) >= self.config.max_pending:
                tel.counter("frontdoor/shed").inc()
                t_shed = _now()
                self.tracer.shed(tr, "door_full", t_shed)
                self._slo_request(req, now, t_shed, ok=False)
                fut.set_exception(DeadlineExceeded(
                    f"front door queue full "
                    f"({self.config.max_pending})"))
                return fut
            req_eff, flags = req, ()
            if self.brownout is not None:
                tier = self.brownout.tier_for(
                    req.tenant, self.pool.load(), self.pool.capacity(),
                    now, slo=self.slo)
                req_eff, flags = self.brownout.apply(req, tier)
                if flags:
                    self.tracer.note(tr, "brownout", now, tier=tier,
                                     flags=list(flags))
            target = self.pool.route(weigh=self._route_weigh())
            if target is None:
                tel.counter("frontdoor/pool_exhausted").inc()
                record_event("pool_exhausted",
                             "frontdoor.pool_exhausted",
                             detail="no routable replica at admission")
                t_shed = _now()
                self.tracer.shed(tr, "pool_exhausted", t_shed)
                self._slo_request(req, now, t_shed, ok=False)
                fut.set_exception(ServingFault(
                    "no routable replica (pool dead)",
                    kind="pool_exhausted", request=req))
                return fut
            e = _DoorReq(req, req_eff, fut, tr, now, flags)
            self._route_arm(e, target, role="primary", at=now)
            # routing work (admission, brownout, route, hand-off to the
            # replica) is the `door.route` phase; the first attempt
            # segment opens at the SAME timestamp the route span closes
            t_r = _now()
            self.tracer.hop_span(tr, "door.route", now, t_r,
                                 replica=target.name)
            e.t_open = t_r
            self._entries.append(e)
            tel.gauge("frontdoor/pending").set(len(self._entries))
            self._cv.notify_all()
        return fut

    def _route_arm(self, e: _DoorReq, target: Replica, role: str,
                   at: float) -> None:
        # trace propagation: the replica scheduler's tracer ADOPTS the
        # door-minted id/lane (reqtrace.begin parent=), so one trace id
        # spans door -> replica -> serving rounds for this request
        rf = target.submit(e.req_eff,
                           trace_ctx=self.tracer.context(e.trace))
        e.arms.append({"rep": target, "fut": rf, "role": role,
                       "t0": at})
        e.tried.add(target.name)
        self.telemetry.counter("frontdoor/routed").inc()
        self.tracer.note(e.trace, "route", at, replica=target.name,
                         role=role, health=target.health(),
                         load=target.load())

    # -- SLO / span helpers ---------------------------------------------------
    def _close_seg(self, e: _DoorReq, now: float, **args) -> None:
        """Close the open door phase segment at `now` and open the next
        one at the SAME timestamp — shared-timestamp tiling is what
        makes the per-phase sums reconcile with latency_ms exactly."""
        if e.trace is not None:
            self.tracer.hop_span(e.trace, f"door.{e.seg}", e.t_open,
                                 now, attempt=e.attempt_no, **args)
        e.t_open = now

    def _slo_request(self, req: SampleRequest, t_sub: float,
                     now: float, ok: bool) -> None:
        """Terminal tenant-budget outcome for one door request (shed,
        fault, or delivery; delivery attains only within its `slo_ms`)."""
        if self.slo is not None:
            self.slo.observe(req.tenant, (now - t_sub) * 1e3, ok=ok,
                             at_s=now, target_ms=req.slo_ms)

    def _slo_replica(self, rep: Replica, t0: float, now: float,
                     ok: bool, target_ms=None) -> None:
        """Per-replica delivery series (tenant key `replica:<name>`):
        the routing penalty's input, measured from the arm's own
        routing timestamp."""
        if self.slo is not None:
            self.slo.observe(f"replica:{rep.name}", (now - t0) * 1e3,
                             ok=ok, at_s=now, target_ms=target_ms)

    def _route_weigh(self):
        """Routing penalty callable for `ReplicaPool.route` (None when
        the SLO engine is off): a replica burning its own delivery
        objective ranks behind its peers within the same health class."""
        if self.slo is None:
            return None
        return lambda r: self.slo.tier_hint(f"replica:{r.name}")

    # -- monitor --------------------------------------------------------------
    def _monitor_loop(self) -> None:
        """Crash guard (mirrors the scheduler's thread guards): a dying
        monitor fails every pending door future typed rather than
        stranding them."""
        try:
            self._monitor_rounds()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:  # noqa: BLE001 — last-resort guard
            record_event("serving_fault", "frontdoor.monitor",
                         detail=f"monitor thread died: {exc!r}")
            with self._cv:
                self._closed = True
                self._sweep_locked(ServingFault(
                    f"front door monitor died: {exc!r}",
                    kind="scheduler_died", cause=exc))

    def _monitor_rounds(self) -> None:
        while True:
            with self._cv:
                if self._closed and not self._entries:
                    break
                if not self._entries:
                    self._update_health(_now())
                    self._cv.wait(0.1)
                    continue
                entries = list(self._entries)
            now = _now()
            finished = [e for e in entries if self._scan_entry(e, now)]
            with self._cv:
                if finished:
                    for e in finished:
                        try:
                            self._entries.remove(e)
                        except ValueError:
                            record_event(
                                "serving_fault", "frontdoor.monitor",
                                detail="finished entry already removed")
                    self.telemetry.gauge("frontdoor/pending").set(
                        len(self._entries))
                self._update_health(now)
                self.telemetry.gauge("frontdoor/pool_load").set(
                    self.pool.load())
                if self._entries or not self._closed:
                    self._cv.wait(self.config.poll_interval_s)

    def _update_health(self, now: float) -> None:
        """Per-replica health gauges + a JSONL timeline row on every
        transition (the diagnose_run "Front door" section's input)."""
        for r in self.pool.replicas:
            h = r.health()
            if self._last_health.get(r.name) == h:
                continue
            self._last_health[r.name] = h
            self.telemetry.gauge(
                f"frontdoor/replica_health/{r.name}").set(HEALTH_RANK[h])
            self.telemetry.write_record({
                "type": "frontdoor_health", "replica": r.name,
                "health": h, "fault_rate": round(r.fault_rate(), 4),
                "load": r.load(), "t_s": round(now, 4)})

    # one entry per scan; returns True when the entry is finished
    def _scan_entry(self, e: _DoorReq, now: float) -> bool:
        if e.fut.done():
            self._reap_arms(e, now)
            return True
        # door-level deadline: failover must never outlive the
        # request's own budget (each arm's replica clock restarts at
        # routing time, so only the door sees the true age)
        if e.req.deadline_s is not None \
                and now - e.t_sub > e.req.deadline_s:
            self.telemetry.counter("frontdoor/shed").inc()
            self._close_seg(e, now, outcome="deadline")
            self._slo_request(e.req, e.t_sub, now, ok=False)
            self.tracer.shed(e.trace, "deadline", now)
            e.fut.set_exception(DeadlineExceeded(
                f"deadline {e.req.deadline_s}s passed at the front "
                f"door after {e.attempts} failover(s)"))
            self._reap_arms(e, now)
            return True
        for arm in list(e.arms):
            if not arm["fut"].done():
                continue
            try:
                res = arm["fut"].result(timeout=0)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:  # noqa: BLE001 — outcome sort
                if self._arm_failed(e, arm, exc, now):
                    return True
                continue
            self._deliver(e, arm, res, now)
            return True
        if e.fut.done():
            return True
        if not e.arms:
            return self._failover(e, now)
        self._maybe_hedge(e, now)
        return False

    def _reap_arms(self, e: _DoorReq, now: float) -> None:
        """Cancel every still-queued arm of a finished entry; late
        results of uncancellable arms lose first-set-wins harmlessly."""
        for arm in e.arms:
            if arm["role"] == "hedge":
                # the overlapping span: hedge launch -> reap (the entry
                # already resolved elsewhere); excluded from the tiling
                # identity by name
                self.tracer.hop_span(e.trace, "door.hedge", arm["t0"],
                                     now, replica=arm["rep"].name,
                                     outcome="lost")
            if not arm["fut"].done() and arm["rep"].cancel(arm["fut"]):
                self.telemetry.counter("frontdoor/hedge_cancelled").inc()
                self.tracer.note(e.trace, "hedge_cancel", now,
                                 replica=arm["rep"].name,
                                 role=arm["role"])
        e.arms = []

    def _arm_failed(self, e: _DoorReq, arm: Dict[str, Any],
                    exc: BaseException, now: float) -> bool:
        """Sort one failed arm: terminal faults relay to the door
        future, re-routable ones drop the arm (failover happens once
        no arm is left). Returns True when the entry is finished."""
        e.arms.remove(arm)
        rep: Replica = arm["rep"]
        if arm["role"] == "hedge":
            self.tracer.hop_span(e.trace, "door.hedge", arm["t0"],
                                 now, replica=rep.name,
                                 outcome="failed")
        if isinstance(exc, ServingFault) \
                and exc.kind in _TERMINAL_FAULT_KINDS:
            # the request's own deterministic fault — replaying it on
            # another replica reproduces it
            rep.note_outcome(True)   # not the replica's failure
            e.attempts = max(e.attempts, int(exc.attempts or 0))
            self._close_seg(e, now)
            self._slo_request(e.req, e.t_sub, now, ok=False)
            self.tracer.fail(e, f"fault:{exc.kind}", now)
            e.fut.set_exception(exc)
            self._reap_arms(e, now)
            return True
        if isinstance(exc, DeadlineExceeded) \
                and "queue full" not in str(exc):
            # true deadline expiry at the replica: the replica's clock
            # started at routing (>= door submit), so the budget is
            # gone everywhere — relay, don't failover
            self._close_seg(e, now, outcome="deadline")
            self._slo_request(e.req, e.t_sub, now, ok=False)
            self.tracer.shed(e.trace, "deadline", now)
            e.fut.set_exception(exc)
            self._reap_arms(e, now)
            return True
        if isinstance(exc, (ServingFault, DeadlineExceeded,
                            SchedulerClosed)):
            # replica-attributable: local retries exhausted, device
            # lost without rebuild, scheduler/thread death, replica
            # killed, local queue full, hedge-loser cancel
            rep.note_outcome(False)
            self._slo_replica(rep, arm["t0"], now, ok=False,
                              target_ms=e.req.slo_ms)
            if self.brownout is not None:
                self.brownout.note_fault(now)
            self.tracer.note(e.trace, "arm_failed", now,
                             replica=rep.name, role=arm["role"],
                             error=type(exc).__name__,
                             fault_kind=getattr(exc, "kind", None))
            if not e.arms:
                # no live arm left: the attempt segment ends here and
                # the (usually zero-width) failover segment opens
                self._close_seg(e, now, replica=rep.name)
                e.seg = "failover"
                return self._failover(e, now)
            return False
        # anything else (bad-request prepare errors, programming
        # errors) is deterministic for the request — relay as-is
        rep.note_outcome(True)
        self._close_seg(e, now)
        self._slo_request(e.req, e.t_sub, now, ok=False)
        self.tracer.fail(e, f"error:{type(exc).__name__}", now)
        e.fut.set_exception(exc)
        self._reap_arms(e, now)
        return True

    def _failover(self, e: _DoorReq, now: float) -> bool:
        """Re-route a request with no live arm; True when the entry
        finished (pool exhausted). Prefers untried replicas, but a
        previously tried one (e.g. rebuilt since) beats giving up."""
        e.attempts += 1
        fault = None
        if e.attempts >= self.config.max_attempts:
            fault = ServingFault(
                f"cross-replica attempt budget exhausted after "
                f"{e.attempts} submission(s)",
                kind="pool_exhausted", request=e.req,
                attempts=e.attempts)
        else:
            weigh = self._route_weigh()
            target = self.pool.route(exclude=e.tried, weigh=weigh) \
                or self.pool.route(weigh=weigh)
            if target is None:
                fault = ServingFault(
                    f"no routable replica left after {e.attempts} "
                    f"failover(s) (pool dead)", kind="pool_exhausted",
                    request=e.req, attempts=e.attempts)
        if fault is not None:
            self.telemetry.counter("frontdoor/pool_exhausted").inc()
            record_event("pool_exhausted", "frontdoor.pool_exhausted",
                         detail=f"request failed after {e.attempts} "
                                f"attempt(s)")
            self._close_seg(e, now)
            self._slo_request(e.req, e.t_sub, now, ok=False)
            self.tracer.fail(e, "fault:pool_exhausted", now)
            e.fut.set_exception(fault)
            return True
        self.telemetry.counter("frontdoor/failovers").inc()
        self.tracer.note(e.trace, "failover", now,
                         to=target.name, attempts=e.attempts)
        # close the failover segment at the SAME `now` it opened on
        # (zero-width on the common path: arm failure and re-route
        # happen in one monitor scan) and open the next attempt
        self._close_seg(e, now, to=target.name)
        e.seg = "attempt"
        e.attempt_no += 1
        self._route_arm(e, target, role="primary", at=now)
        return False

    def _maybe_hedge(self, e: _DoorReq, now: float) -> None:
        hp = self.config.hedge
        if hp is None or e.hedged or len(e.arms) != 1:
            return
        if hp.deadline_only and e.req.deadline_s is None:
            return
        thr_ms = self._hedge_threshold_ms()
        if thr_ms is None or (now - e.t_sub) * 1e3 < thr_ms:
            return
        cur = {arm["rep"].name for arm in e.arms}
        target = self.pool.route(exclude=cur)
        if target is None:
            return                  # nowhere distinct to hedge to
        e.hedged = True
        self.telemetry.counter("frontdoor/hedges").inc()
        self.tracer.note(e.trace, "hedge", now, to=target.name,
                         after_ms=round((now - e.t_sub) * 1e3, 1),
                         threshold_ms=round(thr_ms, 1))
        self._route_arm(e, target, role="hedge", at=now)

    def _hedge_threshold_ms(self) -> Optional[float]:
        hp = self.config.hedge
        if hp is None:
            return None
        with self._lock:
            lat = list(self._lat)
        if len(lat) >= hp.min_observations:
            return _percentile(lat, hp.percentile)
        return hp.after_ms

    def _deliver(self, e: _DoorReq, arm: Dict[str, Any],
                 res: SampleResult, now: float) -> None:
        rep: Replica = arm["rep"]
        rep.note_outcome(True)
        lat_ms = (now - e.t_sub) * 1e3
        # the caller sees DOOR-scope timings (submit -> result, with
        # routing/queue/failover overhead in queue_ms) — the replica's
        # own decomposition stays on its trace rows; compile/device
        # cost is the replica's measurement either way
        queue_ms = max(0.0, lat_ms - res.compile_ms - res.device_ms)
        device_ms = max(0.0, lat_ms - queue_ms - res.compile_ms)
        merged = tuple(dict.fromkeys(e.flags + tuple(res.degraded)))
        res = dataclasses.replace(res, latency_ms=lat_ms,
                                  queue_ms=queue_ms,
                                  device_ms=device_ms, degraded=merged,
                                  attempts=max(res.attempts,
                                               e.attempts))
        if e.fut.set_result(res):
            tel = self.telemetry
            tel.counter("frontdoor/requests_ok").inc()
            tel.histogram("frontdoor/latency_ms",
                          bounds=MS_BUCKET_BOUNDS).observe(lat_ms)
            # delivery closes the last attempt segment at the SAME
            # `now` that produced lat_ms: route + attempts + failovers
            # now tile [t_sub, now] and sum to lat_ms exactly
            self._close_seg(e, now, replica=rep.name)
            self._slo_request(e.req, e.t_sub, now, ok=True)
            self._slo_replica(rep, arm["t0"], now, ok=True,
                              target_ms=e.req.slo_ms)
            if arm["role"] == "hedge":
                tel.counter("frontdoor/hedge_wins").inc()
                self.tracer.note(e.trace, "hedge_win", now,
                                 replica=rep.name)
                self.tracer.hop_span(e.trace, "door.hedge",
                                     arm["t0"], now, replica=rep.name,
                                     outcome="win")
            with self._lock:
                self._lat.append(lat_ms)
            # door trace row: same three-way identity as the replica
            # rows, with routing/failover/hedge overhead showing up in
            # the door's queue_ms residual
            e.rounds = res.rounds
            e.degraded = tuple(res.degraded)
            self.tracer.complete(e, queue_ms, res.compile_ms,
                                 device_ms, lat_ms, now)
        e.arms.remove(arm)
        self._reap_arms(e, now)

    def _sweep_locked(self, exc: BaseException) -> None:
        """Fail every pending door future (held lock): non-draining
        close and the monitor crash guard. First set wins, so results
        a replica is delivering concurrently are never clobbered."""
        for e in self._entries:
            t = _now()
            self._close_seg(e, t, outcome="swept")
            if isinstance(exc, ServingFault):
                self.tracer.fail(e, f"fault:{exc.kind}", t)
            else:
                self.tracer.shed(e.trace, "closed", t)
            e.fut.set_exception(exc)
            for arm in e.arms:
                arm["rep"].cancel(arm["fut"])
        self._entries.clear()
        self.telemetry.gauge("frontdoor/pending").set(0)


def build_pool(pipelines: Sequence[Any], scheduler_config=None,
               telemetries: Optional[Sequence[Any]] = None,
               health_config=None, autostart: bool = True,
               engine_factories: Optional[Sequence[Any]] = None
               ) -> ReplicaPool:
    """Convenience constructor: one replica per pipeline, named r0..rN,
    each with its own scheduler (and its own telemetry hub when
    `telemetries` is given — per-replica hubs keep program-cache and
    miss counters attributable per replica, which the pool chaos
    bench relies on)."""
    from .scheduler import ServingScheduler
    replicas = []
    for i, pipe in enumerate(pipelines):
        tel = telemetries[i] if telemetries is not None else None
        factory = (engine_factories[i] if engine_factories is not None
                   else None)
        sched = ServingScheduler(
            pipeline=pipe, config=scheduler_config, telemetry=tel,
            autostart=autostart, engine_factory=factory)
        sched.tracer = RequestTracer(sched.telemetry, prefix=f"r{i}")
        replicas.append(Replica(f"r{i}", sched, config=health_config))
    return ReplicaPool(replicas)
