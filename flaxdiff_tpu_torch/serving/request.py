"""Serving request/result types and the thread-safe result future
(counterpart of ``flaxdiff_tpu/serving/request.py``).

A `SampleRequest` is one unit of admission: a block of `num_samples`
samples sharing one prompt list, seed, sampler, and NFE budget. The
scheduler batches COMPATIBLE requests (same shape/sampler/guidance
family — see `serving.engine.group_key`) into micro-batch rounds; NFE
may differ within a group because the engine masks each row to its own
trajectory length.

Determinism contract: a request's samples follow its own fields (seed
included) and nothing else. Whatever its bucket, its position in it and
its mates, a request is bit for bit the solo
`DiffusionInferencePipeline.generate_samples` call with the same
arguments, on the CPU (`tests/test_torch_serving.py`,
`tests/test_torch_serving_chaos.py`) and on the card (`chip_smoke.py`
phases 15a and 15c): under inference mode the models' Dense and ConvLayer
run batch-invariant kernels (`ops/batch_invariant.py`), and the hand-written
kernels compute each sample apart. So a requeue, a probe round, a failover
or a hedge replays a request exactly. The contract covers those routes;
grouped, dilated and transposed convolutions and UNet3D's temporal
convolution stay on the library and may still move with their batch on the
card (fault C6's rest, ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np


class DeadlineExceeded(Exception):
    """The request was shed before compute: its deadline had already
    passed when the dispatch loop reached it."""


class SchedulerClosed(Exception):
    """Submitted after close(), or cancelled by a non-draining close."""


@dataclasses.dataclass
class SampleRequest:
    """One serving request: `num_samples` samples from one seed.

    `prompts` (optional) must have length `num_samples` when given —
    the same coupling `generate_samples` has. `conditioning` bypasses
    the encoder with a pre-encoded array. `deadline_s` is a relative
    latency budget from submit time; a request that is still queued
    when it expires is shed before any compute is spent on it.

    `cache_plan` is the per-request quality/latency knob: an
    `ops.diffcache.CachePlan` activates the training-free activation
    cache for this request's trajectory, and an
    `ops.spatialcache.ComposedPlan` (or bare `SpatialPlan`) adds the
    token-level spatial axis on top (docs/CACHING.md). None (the
    default) keeps sampling bit-identical to the uncached path. The
    plan is normalized (degenerate axes route to the simpler program)
    and then becomes part of the engine's group/program cache key, so
    requests with different effective plans never share a
    program.

    `tenant` and `slo_ms` are accounting-only fields: the front door's
    SLO engine attributes the outcome (delivered within `slo_ms`?) to
    the tenant's error budget, and burn-rate brownout degrades the
    over-budget tenant first. Neither field is part of the engine group
    key, so they never change batching or programs.
    """
    num_samples: int = 1
    resolution: int = 64
    diffusion_steps: int = 50           # NFE
    sampler: str = "ddim"
    guidance_scale: float = 0.0
    seed: int = 42
    prompts: Optional[List[str]] = None
    conditioning: Optional[Any] = None
    sequence_length: Optional[int] = None
    channels: int = 3
    use_ema: bool = True
    deadline_s: Optional[float] = None
    cache_plan: Optional[Any] = None    # ops.diffcache.CachePlan
    tenant: Optional[str] = None
    slo_ms: Optional[float] = None

    def __post_init__(self):
        if self.diffusion_steps < 1:
            raise ValueError("diffusion_steps must be >= 1")
        if self.prompts is not None:
            self.num_samples = len(self.prompts)
        if self.num_samples < 1:
            raise ValueError("num_samples must be >= 1")


@dataclasses.dataclass
class SampleResult:
    """Samples plus the request's latency decomposition (milliseconds).

    queue_ms   submit -> first dispatch
    compile_ms program trace+compile stalls in rounds this request
               rode (0 on a warm program cache)
    device_ms  residual: latency - queue - compile — dispatch plus
               device execution of every round to result readiness
    latency_ms submit -> samples ready on host
    rounds     scheduler rounds the request participated in
    attempts   failed dispatch attempts that were retried before this
               result (0 on the healthy path) — each retry replayed
               the trajectory from the request's seed, bit-exact (the
               determinism contract above)
    degraded   brownout flags ("nfe_capped", "plan_forced", ...) when
               admission degraded the request instead of shedding it
               (docs/SERVING.md "Failure semantics"); empty otherwise
    """
    samples: np.ndarray
    request: SampleRequest
    queue_ms: float = 0.0
    compile_ms: float = 0.0
    device_ms: float = 0.0
    latency_ms: float = 0.0
    rounds: int = 0
    attempts: int = 0
    degraded: tuple = ()

    def timings(self) -> Dict[str, float]:
        return {"queue_ms": self.queue_ms, "compile_ms": self.compile_ms,
                "device_ms": self.device_ms, "latency_ms": self.latency_ms}


class ServingFuture:
    """Minimal thread-safe future for one request's result.

    First set wins: once resolved (result OR exception) later sets are
    ignored — the failure-isolation sweeps (dispatch-thread death,
    non-draining close, engine rebuild) may race the completion
    thread's delivery, and a delivered result must never be clobbered
    by a later blanket failure."""

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._result: Optional[SampleResult] = None
        self._exception: Optional[BaseException] = None

    def set_result(self, result: SampleResult) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._event.set()
            return True

    def set_exception(self, exc: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._exception = exc
            self._event.set()
            return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> SampleResult:
        if not self._event.wait(timeout):
            raise TimeoutError("serving result not ready")
        if self._exception is not None:
            raise self._exception
        assert self._result is not None
        return self._result
