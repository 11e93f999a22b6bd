"""Deterministic fault injection (counterpart of
``flaxdiff_tpu/resilience/faults.py``): a seedable `FaultPlan` arms named
sites to fail at chosen occurrence counts, so chaos runs replay exactly in
pytest on the CPU.

Production code calls `check(SITE)` (or `maybe_stall`) at each fault
barrier. With no plan installed that is one `is None` test on a module
global, so the sites stay in the real code paths rather than in test-only
monkeypatches.

The port's sites (plans may name new ones freely):
    serving.round  ServingScheduler dispatch: polled once per row per
                  round with key="seed:<seed>:" — a per_key spec
                  poisons ONE request deterministically (conviction by
                  binary-search solo re-runs), a site-global `at`
                  models a transient round fault
    serving.fetch  ServingScheduler completion thread, before the
                  blessed host sync — a failed readback requeues the
                  batch for bit-exact replay
    serving.device_lost  ServingScheduler dispatch, before each round
                  (use error="flag"): raises DeviceLost -> the
                  EngineSupervisor drains, rebuilds, prewarms, requeues
    serving.replica_lost  FrontDoor.submit admission: polled once per
                  replica per submission with key="replica:<name>:"
                  (use error="flag", per_key=True, match the target
                  replica) — a firing kills that whole replica
                  (non-draining close); the door marks it DEAD and
                  fails its in-flight requests over to survivors

Usage::

    plan = FaultPlan([FaultSpec("serving.round", at=(1,), error="io")], seed=0)
    with plan.installed():
        ...  # the first round's first row raises InjectedFault
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from .events import record_event

class InjectedFault(OSError):
    """An error raised by the fault-injection framework (subclasses
    OSError so retry classifiers treat it as a transient I/O fault)."""


class InjectedHTTPError(Exception):
    """Stand-in for a non-retryable HTTP failure; carries `.code`."""

    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg or f"injected HTTP {code}")
        self.code = code


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed site.

    at:    1-based occurrence indices at which the site fires (the Nth
           time `check(site)` runs). Deterministic scheduling.
    prob:  per-occurrence firing probability drawn from the plan's
           seeded RNG (deterministic given the seed + call sequence).
    times: max total firings for this spec (0 = unlimited).
    error: "io" -> InjectedFault, "http404"/"http403"/... ->
           InjectedHTTPError(code), "stall" -> no raise; `maybe_stall`
           sleeps `delay` seconds, "flag" -> no raise; `check` returns
           True (caller-interpreted, e.g. serving.device_lost).
    delay: stall duration for error="stall".
    per_key: interpret `at` against a PER-KEY hit counter instead of
           the site-global one — sites that pass `check(site, key=...)`
           (`serving.round` passes "seed:<seed>:") can then model
           "THIS request fails on its first two rounds, then succeeds"
           (`at=(1, 2), per_key=True`), which the global counter never
           could: interleaved rounds of other requests advance it
           unpredictably, so a global `at` models only a flaky device.
           Occurrences without a key never fire a per_key spec.
    match: only consider keys containing this substring (per_key mode;
           empty matches every key) — arm one specific request.
    """
    site: str
    at: Tuple[int, ...] = ()
    prob: float = 0.0
    times: int = 0
    error: str = "io"
    delay: float = 0.0
    per_key: bool = False
    match: str = ""


class FaultPlan:
    """Seedable, deterministic schedule of site failures."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.seed = seed
        self._lock = threading.Lock()
        self._specs: Dict[str, list] = {}
        for spec in specs:
            self._specs.setdefault(spec.site, []).append(spec)
        self._hits: Dict[str, int] = {}
        self._key_hits: Dict[Tuple[str, str], int] = {}
        self._fired: Dict[int, int] = {}    # id(spec) -> firings
        self._rng = np.random.default_rng(seed)

    # -- firing logic --------------------------------------------------------
    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def key_hits(self, site: str, key: str) -> int:
        with self._lock:
            return self._key_hits.get((site, key), 0)

    def _poll(self, site: str,
              key: Optional[str] = None) -> Optional[FaultSpec]:
        """Count one occurrence of `site` (and of `(site, key)` when a
        key is given); return the spec that fires, if any. Thread-safe
        and deterministic given the call sequence — per_key specs are
        additionally deterministic against interleaving, because each
        key carries its own counter."""
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            nk = 0
            if key is not None:
                nk = self._key_hits.get((site, key), 0) + 1
                self._key_hits[(site, key)] = nk
            for spec in self._specs.get(site, ()):
                if spec.times and self._fired.get(id(spec), 0) >= spec.times:
                    continue
                if spec.per_key:
                    if key is None or (spec.match and spec.match not in key):
                        continue
                    fire = nk in spec.at
                else:
                    fire = n in spec.at
                if not fire and spec.prob > 0:
                    fire = bool(self._rng.random() < spec.prob)
                if fire:
                    self._fired[id(spec)] = self._fired.get(id(spec), 0) + 1
                    return spec
        return None

    def check(self, site: str, step: Optional[int] = None,
              key: Optional[str] = None) -> bool:
        """One occurrence of `site`. Raises for error faults; returns
        True for "flag" faults (caller decides what failing means);
        False when nothing fires. `key` identifies the record within
        the site (the row's seed) so `per_key` specs can schedule
        deterministically per record."""
        spec = self._poll(site, key=key)
        if spec is None:
            return False
        record_event("fault_injected", site,
                     detail=f"error={spec.error} hit={self.hits(site)}"
                            + (f" key={key} key_hit="
                               f"{self.key_hits(site, key)}"
                               if key is not None and spec.per_key else ""),
                     step=step)
        if spec.error == "io":
            raise InjectedFault(f"injected fault at {site} "
                                f"(hit {self.hits(site)})")
        if spec.error.startswith("http"):
            raise InjectedHTTPError(int(spec.error[4:] or 500))
        # "stall" polled via check() is a flag too: the sleep belongs in
        # maybe_stall so exception sites never block.
        return True

    def maybe_stall(self, site: str, step: Optional[int] = None,
                    sleep=time.sleep) -> float:
        """One occurrence of a stall site; sleeps and returns the delay
        (0.0 when nothing fires)."""
        spec = self._poll(site)
        if spec is None or spec.error != "stall":
            return 0.0
        record_event("fault_injected", site,
                     detail=f"stall {spec.delay}s", step=step)
        if spec.delay > 0:
            sleep(spec.delay)
        return spec.delay

    # -- installation --------------------------------------------------------
    @contextlib.contextmanager
    def installed(self) -> Iterator["FaultPlan"]:
        prev = install_plan(self)
        try:
            yield self
        finally:
            install_plan(prev)


# Process-global active plan. None (the production default) short-circuits
# every site check to a single `is None` test.
_ACTIVE: Optional[FaultPlan] = None
_active_lock = threading.Lock()


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with None) the active plan; returns previous."""
    global _ACTIVE
    with _active_lock:
        prev, _ACTIVE = _ACTIVE, plan
    return prev


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def check(site: str, step: Optional[int] = None,
          key: Optional[str] = None) -> bool:
    """Module-level site barrier: no-op without an active plan."""
    plan = active_plan()
    return plan.check(site, step=step, key=key) if plan is not None \
        else False


def maybe_stall(site: str, step: Optional[int] = None) -> float:
    plan = active_plan()
    return plan.maybe_stall(site, step=step) if plan is not None else 0.0
