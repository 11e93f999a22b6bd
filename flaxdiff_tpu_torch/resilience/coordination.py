"""Coordination transports of the port (counterpart of the transport part of
``flaxdiff_tpu/resilience/coordination.py``): the `Transport` protocol a
world of processes talks over (a barrier with a deadline, small-JSON
gather, broadcast and point reads) and `InMemoryTransport`, a world of N
members in one process (threads in tests; N = 1 for a single-host run),
which the telemetry hub's cross-host aggregator gathers over.

The step ledger, the commit coordinator, the file transport and the
multi-host transport are ROADMAP.md A14's second half.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List


class CoordinationError(RuntimeError):
    """A cross-process coordination step failed."""


class BarrierTimeout(CoordinationError):
    """A barrier (or gather) missed its deadline: some member is dead or
    wedged."""


class Transport:
    """World communication used by the coordinator. Implementations
    provide a timeout-capable barrier plus small-JSON gather/broadcast;
    every operation either completes on ALL members or raises
    BarrierTimeout on the survivors within the deadline."""

    process_index: int = 0
    process_count: int = 1

    def barrier(self, name: str, timeout: float) -> None:
        raise NotImplementedError

    def allgather_json(self, name: str, obj, timeout: float) -> List:
        raise NotImplementedError

    def broadcast_json(self, name: str, obj, timeout: float):
        """Process 0's `obj` to everyone (non-0 callers' obj is ignored)."""
        raise NotImplementedError

    def offer_json(self, name: str, obj) -> None:
        """Non-blocking, best-effort contribution of this host's payload
        under a gather's key — the write half of `allgather_json` without
        the wait. Used to publish tombstones (e.g. "aggregation
        disabled") that unblock peers still gathering; overwrites any
        earlier contribution to the same round."""
        raise NotImplementedError

    # -- point reads/writes (the elastic layer's primitives) ----------------
    # Membership rounds cannot use barrier/allgather: those complete only
    # when EVERY world member participates, and the whole point of a
    # membership round is that some member is dead. The elastic layer
    # instead composes these three: publish a contribution, read one
    # specific member's contribution with a bounded wait (a dead member
    # is a None, not a hang), and read/write shared decision keys.

    def poll_json(self, name: str, rank: int, timeout: float = 0.0):
        """Read `rank`'s `offer_json`/`allgather_json` contribution to
        gather `name`, waiting up to `timeout`; None when that member
        never produced it (dead/parked member — NOT an error)."""
        raise NotImplementedError

    def put_json(self, name: str, obj) -> None:
        """Direct KV write at `name` (overwrites). Unlike offer_json the
        key carries NO rank suffix — any member (or a parked joiner)
        can read it back via get_json without knowing the writer."""
        raise NotImplementedError

    def get_json(self, name: str, timeout: float = 0.0):
        """Read a `put_json` key, waiting up to `timeout`; None when
        absent within the deadline."""
        raise NotImplementedError


class _InMemoryWorld:
    """Shared state behind a set of InMemoryTransports (one per
    simulated host, usually one thread each)."""

    def __init__(self, n: int):
        self.n = n
        self._cond = threading.Condition()
        self._store: Dict[str, object] = {}
        self._arrived: Dict[str, set] = {}
        self._released: set = set()

    def barrier(self, name: str, rank: int, timeout: float) -> None:
        with self._cond:
            self._arrived.setdefault(name, set()).add(rank)
            if len(self._arrived[name]) >= self.n:
                self._released.add(name)
                self._cond.notify_all()
            elif not self._cond.wait_for(
                    lambda: name in self._released, timeout):
                raise BarrierTimeout(
                    f"barrier {name!r}: {len(self._arrived[name])}/{self.n} "
                    f"arrived within {timeout}s")

    def put(self, key: str, value) -> None:
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout: float):
        with self._cond:
            if not self._cond.wait_for(lambda: key in self._store, timeout):
                raise BarrierTimeout(
                    f"key {key!r} not produced within {timeout}s")
            return self._store[key]

    def try_get(self, key: str, timeout: float):
        """`get` that returns None instead of raising on a missing key —
        the membership-round read (a dead member is an answer)."""
        with self._cond:
            if self._cond.wait_for(lambda: key in self._store,
                                   max(timeout, 0.0)):
                return self._store[key]
            return None


class InMemoryTransport(Transport):
    """Single-process transport: a world of N members sharing one
    `_InMemoryWorld` (threads in tests; N=1 for plain single-host runs)."""

    def __init__(self, world: _InMemoryWorld, rank: int):
        self._world = world
        self.process_index = rank
        self.process_count = world.n

    @classmethod
    def make_world(cls, n: int) -> List["InMemoryTransport"]:
        world = _InMemoryWorld(n)
        return [cls(world, i) for i in range(n)]

    def barrier(self, name: str, timeout: float) -> None:
        self._world.barrier(name, self.process_index, timeout)

    def allgather_json(self, name: str, obj, timeout: float) -> List:
        # json round-trip deliberately mirrors the distributed backend:
        # payloads must be serializable there too
        self._world.put(f"ag/{name}/{self.process_index}", json.dumps(obj))
        deadline = time.monotonic() + timeout
        out = []
        for j in range(self.process_count):
            remaining = max(deadline - time.monotonic(), 0.001)
            out.append(json.loads(self._world.get(f"ag/{name}/{j}",
                                                  remaining)))
        return out

    def broadcast_json(self, name: str, obj, timeout: float):
        if self.process_index == 0:
            self._world.put(f"bc/{name}", json.dumps(obj))
            return obj
        return json.loads(self._world.get(f"bc/{name}", timeout))

    def offer_json(self, name: str, obj) -> None:
        self._world.put(f"ag/{name}/{self.process_index}", json.dumps(obj))

    def poll_json(self, name: str, rank: int, timeout: float = 0.0):
        raw = self._world.try_get(f"ag/{name}/{rank}", timeout)
        return None if raw is None else json.loads(raw)

    def put_json(self, name: str, obj) -> None:
        self._world.put(f"kv/{name}", json.dumps(obj))

    def get_json(self, name: str, timeout: float = 0.0):
        raw = self._world.try_get(f"kv/{name}", timeout)
        return None if raw is None else json.loads(raw)
