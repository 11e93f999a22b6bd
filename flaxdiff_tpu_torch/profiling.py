"""Profiling and MFU accounting (counterpart of ``flaxdiff_tpu/profiling.py``).

- ``device_peak_flops``: the card's dense bf16 peak, keyed by
  ``torch.cuda.get_device_name()``; None for any device the table does not
  know (the CPU), and MFU is then not reported.
- ``FlopCounter`` / ``model_flops``: model FLOPs at true shapes, the
  convention of the JAX package's ``jaxpr_flops``: matrix products,
  convolutions (forward and backward) and attention's two products count,
  elementwise work does not. The counter is a dispatch mode over aten's
  products; a product computed in a hand-written kernel (attention in the
  flash autograd function, the served route's bi_linear and bi_conv2d)
  counts by formula (``count_product``), so the kernel hides nothing, and
  the products of its plain CPU version are not counted twice. A counter
  lives on the dispatch-mode stack, which autograd hands to the thread
  that runs a CUDA backward, so a kernel's backward counts into the
  counter its ``backward()`` call ran under; ``live_counters`` lets an op
  skip all of this when no counter exists.
- ``mfu`` and ``MFUMeter``: achieved FLOP/s over the peak.
- ``trace`` (a ``torch.profiler`` capture written as a Chrome trace) and
  ``annotate`` (``record_function``).
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

# Dense (no sparsity) bf16 tensor-core peak, FLOP/s, by the name
# torch.cuda.get_device_name() reports. The H100 SXM (80 GB HBM3) at its
# 700 W limit; a card held below that limit runs slower than this peak.
_PEAK_FLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(device: Any = None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a CUDA device (default: the current one);
    None for a CPU device, with no CUDA, or for a card the table lacks."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return _PEAK_FLOPS_BF16.get(torch.cuda.get_device_name(device))


# -- model FLOPs ------------------------------------------------------------------

def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _mm(args, kwargs, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(args, kwargs, out) -> float:
    return _mm(args[1:], kwargs, out)


def _bmm(args, kwargs, out) -> float:
    a, b = args[0], args[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(args, kwargs, out) -> float:
    return _bmm(args[1:], kwargs, out)


def _conv(args, kwargs, out) -> float:
    """2 x output elements x input channels a group x kernel taps: the
    count ``jaxpr_flops`` makes of a conv_general_dilated (for a transposed
    conv, of its lhs-dilated form)."""
    w, transposed, groups = args[1], bool(args[6]), int(args[8])
    cin = w.shape[0] // groups if transposed else w.shape[1]
    return 2.0 * out.numel() * cin * _numel(w.shape[2:])


def _conv_backward(args, kwargs, out) -> float:
    """The two convolutions JAX's transpose emits, counted at their traced
    shapes: the input's gradient (output = the input's shape, one product a
    group's output channel and tap) and the kernel's (output = the
    kernel's shape, one product a sample and output position)."""
    grad_out, x, w = args[0], args[1], args[2]
    groups, mask = int(args[9]), args[10]
    taps = _numel(w.shape[2:])
    total = 0.0
    if mask[0]:
        total += 2.0 * x.numel() * (grad_out.shape[1] // groups) * taps
    if mask[1]:
        total += 2.0 * w.numel() * grad_out.shape[0] * _numel(grad_out.shape[2:])
    return total


_FORMULAS = {
    torch.ops.aten.mm: _mm,
    torch.ops.aten.addmm: _addmm,
    torch.ops.aten.bmm: _bmm,
    torch.ops.aten.baddbmm: _baddbmm,
    torch.ops.aten.convolution: _conv,
    torch.ops.aten.convolution_backward: _conv_backward,
}

# FlopCounters entered and not yet left, in any thread: an op reads this
# one global and does no other work while it is 0
live_counters = 0
_live_lock = threading.Lock()


def _add_live(n: int) -> None:
    global live_counters
    with _live_lock:
        live_counters += n


class FlopCounter(TorchDispatchMode):
    """Counts model FLOPs of everything run inside it (``total``), on any
    device: aten's matrix products and convolutions by their shapes, and
    the hand-written kernels' products through ``count_product``."""

    def __init__(self):
        super().__init__()
        self.total = 0.0
        self._suspended = 0

    def __enter__(self):
        _add_live(1)
        return super().__enter__()

    def __exit__(self, *exc):
        _add_live(-1)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._suspended:
            formula = _FORMULAS.get(func.overloadpacket)
            if formula is not None:
                self.total += formula(args, kwargs or {}, out)
        return out

    @contextlib.contextmanager
    def suspended(self):
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1


def active_counter() -> Optional[FlopCounter]:
    """The innermost ``FlopCounter`` on this thread's dispatch-mode stack
    (the one autograd's device thread inherits from ``backward()``'s
    caller); None when there is none."""
    if not live_counters:
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, FlopCounter):
            return mode
    return None


@contextlib.contextmanager
def count_product(flops: float):
    """Inside a ``FlopCounter``: add `flops` (an op that computes a product
    in a hand-written kernel, which the dispatch mode cannot see), and count
    none of the aten products run inside the block (the op's plain CPU
    version). A no-op outside a counter; an op on a hot path checks
    ``live_counters`` first and skips the call."""
    counter = active_counter()
    if counter is None:
        yield
        return
    counter.total += flops
    with counter.suspended():
        yield


def attention_flops(q: torch.Tensor, k: torch.Tensor, head_dim: int, backward: bool) -> float:
    """Attention's products as the ``xla`` backend traces them: q k^T and
    p v forward (2 B H Lq Lk D each) and their four transposes backward, at
    the model's head dim."""
    b, lq, h, _ = q.shape
    return 2.0 * b * h * lq * k.shape[1] * head_dim * (4 if backward else 2)


def model_flops(fn: Callable, *args, **kwargs) -> float:
    """Model FLOPs of one call of ``fn(*args, **kwargs)`` (it runs)."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total


def mfu(flops_per_step: float, step_time_s: float,
        peak_flops: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over the peak."""
    if peak_flops is None:
        peak_flops = device_peak_flops()
    if not peak_flops or step_time_s <= 0:
        return None
    return flops_per_step / step_time_s / peak_flops


class MFUMeter:
    """Accumulates step timings and reports throughput and MFU.
    ``observe(dt, steps)`` or ``with meter.step():`` around one synchronous
    step."""

    def __init__(self, flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops if peak_flops is not None else device_peak_flops()
        self.total_time = 0.0
        self.steps = 0

    def observe(self, dt: float, steps: int = 1):
        self.total_time += dt
        self.steps += steps

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.observe(time.perf_counter() - t0)

    def mean_step_time(self) -> Optional[float]:
        return self.total_time / self.steps if self.steps else None

    def mfu(self) -> Optional[float]:
        dt = self.mean_step_time()
        if dt is None or self.flops_per_step is None:
            return None
        return mfu(self.flops_per_step, dt, self.peak_flops)

    def achieved_tflops(self) -> Optional[float]:
        dt = self.mean_step_time()
        if dt is None or self.flops_per_step is None:
            return None
        return self.flops_per_step / dt / 1e12

    def reset(self):
        self.total_time = 0.0
        self.steps = 0


@contextlib.contextmanager
def trace(logdir: str, cuda: Optional[bool] = None):
    """A ``torch.profiler`` capture of the block, written to
    ``logdir/trace.json`` (Chrome trace: perfetto or chrome://tracing).
    Degrades to running the block unprofiled if the profiler cannot start,
    recording a ``trace_failed`` resilience event either way it fails: a
    profile that silently does not exist cannot be diagnosed after the
    run."""
    from torch.profiler import ProfilerActivity, profile

    from .resilience.events import record_event
    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = None
    try:
        os.makedirs(logdir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — degrade, but visibly
        prof = None
        record_event("trace_failed", "profiler.start_trace",
                     detail=f"{type(e).__name__}: {e} (logdir={logdir})")
    try:
        yield
    finally:
        if prof is not None:
            try:
                if cuda:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
            except Exception as e:  # noqa: BLE001 — degrade, but visibly
                record_event("trace_failed", "profiler.stop_trace",
                             detail=f"{type(e).__name__}: {e} (logdir={logdir})")


def annotate(name: str):
    """A named range in profiler timelines (``record_function``)."""
    return torch.profiler.record_function(name)
