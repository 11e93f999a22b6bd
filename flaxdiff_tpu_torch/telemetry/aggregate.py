"""Cross-host metric aggregation over the resilience `Transport`
(counterpart of ``flaxdiff_tpu/telemetry/aggregate.py``).

Per-host metrics answer "how is MY host doing"; at pod scale the
actionable question is skew — one slow host sets the pace of every
collective. This module gathers each host's scalar metrics dict over
the `Transport` of `resilience/coordination.py` (a world of one
`InMemoryTransport` on a single host; threaded worlds in tests) and
reduces them to min/max/mean/p50/p99 (+ relative spread) per metric, so
process 0 can log pod-wide figures like `pod/step_time/max` and the
skew between stragglers and the median.

The gather is a COLLECTIVE: every host must call `aggregate` the same
number of times at the same points (the trainer calls it at log
cadence, which every host reaches in lockstep — the same
assumption the commit rounds make). A failed round (timeout on a dead
peer, malformed payload, transport error) disables the aggregator, and
the disable is SYMMETRIC: the disabled host keeps publishing a
non-blocking tombstone payload into each subsequent round, so peers
see it on their very next gather, disable too (AggregationDisabled,
which the Telemetry hub degrades to a `telemetry_lost` event), and
never stall more than one timeout total — an asymmetric disable would
otherwise cost every surviving host a full timeout per log cadence.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Payload marker a disabled host publishes instead of metrics; any
# gathered round containing it disables the observer too.
DISABLED_SENTINEL = "__aggregation_disabled__"


class AggregationDisabled(RuntimeError):
    """A peer published a disable tombstone — aggregation is now off
    pod-wide. Not a failure of THIS host; callers should degrade
    (record, stop aggregating), never crash."""


class CrossHostAggregator:
    """Stateless reducer over a Transport's `allgather_json`; local
    state is the round sequence number (it namespaces the gather keys
    so rounds can never cross-read) and the `disabled` latch."""

    def __init__(self, transport, timeout: float = 60.0):
        self.transport = transport
        self.timeout = timeout
        self.disabled = False
        self._seq = 0

    @property
    def process_index(self) -> int:
        return self.transport.process_index

    @property
    def world_size(self) -> int:
        return self.transport.process_count

    def _offer_tombstone(self, name: str) -> None:
        """Best-effort non-blocking disable marker under this round's
        gather key: peers still gathering complete immediately and
        disable too instead of blocking for the full timeout."""
        offer = getattr(self.transport, "offer_json", None)
        if offer is None:
            return      # duck-typed transport without the write half
        try:
            offer(name, {DISABLED_SENTINEL: True})
        except Exception as e:  # noqa: BLE001 — tombstones are advisory
            from ..resilience.events import log
            log.debug("tombstone offer for %s failed: %s", name, e)

    def aggregate(self, metrics: Dict[str, float]
                  ) -> Optional[Dict[str, Dict[str, float]]]:
        """Gather every host's `{name: float}` dict; returns
        `{name: {min, max, mean, p50, p99, spread, hosts}}` computed
        identically on every host, or None when disabled (the tombstone
        for this round is still published so live peers don't block).
        Metrics missing on some hosts are reduced over the hosts that
        reported them. Any transport/reduce failure latches `disabled`
        before re-raising; a peer's tombstone latches it and raises
        AggregationDisabled."""
        seq, self._seq = self._seq, self._seq + 1
        round_key = f"telemetry.agg.{seq}"
        if self.disabled:
            self._offer_tombstone(round_key)
            return None
        try:
            clean = {str(k): float(v) for k, v in metrics.items()
                     if v is not None and np.isfinite(v)}
            gathered: List[Dict[str, float]] = self.transport.allgather_json(
                round_key, clean, self.timeout)
            if any(isinstance(d, dict) and d.get(DISABLED_SENTINEL)
                   for d in gathered):
                raise AggregationDisabled(
                    f"a peer disabled aggregation (round {seq}); "
                    f"disabling on this host too")
            return self._reduce(gathered)
        except Exception:
            # latch BEFORE raising, and unblock anyone still waiting on
            # this round (we may have failed before contributing)
            self.disabled = True
            self._offer_tombstone(round_key)
            raise

    def _reduce(self, gathered: List[Dict[str, float]]
                ) -> Dict[str, Dict[str, float]]:
        names = sorted({k for d in gathered if isinstance(d, dict)
                        for k in d if k != DISABLED_SENTINEL})
        out: Dict[str, Dict[str, float]] = {}
        for name in names:
            vals = np.asarray([d[name] for d in gathered
                               if isinstance(d, dict) and name in d],
                              dtype=np.float64)
            if vals.size == 0:
                continue
            mean = float(vals.mean())
            stats = {
                "min": float(vals.min()),
                "max": float(vals.max()),
                "mean": mean,
                "p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)),
                "hosts": float(vals.size),
            }
            # relative straggler spread: (max - min) / mean — the number
            # to alarm on (0 on a world of one)
            stats["spread"] = ((stats["max"] - stats["min"]) / mean
                               if mean != 0 else 0.0)
            out[name] = stats
        return out

    @staticmethod
    def flatten(stats: Dict[str, Dict[str, float]],
                prefix: str = "pod") -> Dict[str, float]:
        """`{"pod/<metric>/<stat>": value}` for exporter snapshots."""
        return {f"{prefix}/{name}/{stat}": v
                for name, per in stats.items() for stat, v in per.items()}
