"""Memory gauges (counterpart of ``flaxdiff_tpu/telemetry/memory.py``):
the CUDA caching allocator's statistics sampled into the metrics registry,
or, when the caller asked for ``device="cpu"``, the host process's memory.

An out-of-memory error is the one failure the run cannot recover from; the
defence is seeing the watermark climb before the allocation that kills it.
On a CUDA device ``MemoryMonitor`` reports (``torch.cuda.memory_stats``,
``torch.cuda.max_memory_allocated`` and the card's total memory: host-side
reads, no device work):

    memory/bytes_in_use          bytes the allocator has handed out
    memory/peak_bytes_in_use     their peak since the last peak reset
    memory/reserved_bytes        bytes the allocator holds from the card
    memory/bytes_limit           the card's total memory
    memory/utilization           bytes_in_use / bytes_limit
    memory/step_watermark_bytes  max bytes_in_use seen by `sample()`
                                 since the last `record()`
    memory/devices               1

On ``device="cpu"`` it reports the host process instead
(``/proc/self/statm`` times the page size), under keys of its own:

    memory/host_rss_bytes, memory/host_rss_peak_bytes, memory/host_vms_bytes

The two key sets are disjoint on purpose, and a CUDA monitor never falls
back to the host: a reader of ``memory/peak_bytes_in_use`` (the program
registry's ``hbm_peak_bytes``) gets None on the CPU, never a host number
posing as device memory. Where ``/proc`` is missing the host monitor
latches disabled after its first empty sample.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from ..device import DeviceLike, resolve_device

log = logging.getLogger("flaxdiff_tpu_torch.telemetry")

_STATM_PATH = "/proc/self/statm"


class MemoryMonitor:
    """Bounded-cardinality memory gauges of one device (CUDA unless
    ``device="cpu"``)."""

    def __init__(self, device: DeviceLike = None, statm_path: str = _STATM_PATH):
        self.device = resolve_device(device)
        self.disabled = False
        self._watermark = 0.0
        self._statm_path = statm_path
        self._page: Optional[float] = None
        self._host_peak = 0.0
        self._limit: Optional[float] = None

    def _cuda_sample(self) -> Dict[str, float]:
        stats = torch.cuda.memory_stats(self.device)
        in_use = float(stats.get("allocated_bytes.all.current", 0))
        if self._limit is None:
            self._limit = float(torch.cuda.get_device_properties(self.device).total_memory)
        self._watermark = max(self._watermark, in_use)
        return {
            "memory/bytes_in_use": in_use,
            "memory/peak_bytes_in_use": float(torch.cuda.max_memory_allocated(self.device)),
            "memory/reserved_bytes": float(stats.get("reserved_bytes.all.current", 0)),
            "memory/bytes_limit": self._limit,
            "memory/utilization": in_use / self._limit if self._limit else 0.0,
            "memory/step_watermark_bytes": self._watermark,
            "memory/devices": 1.0,
        }

    def _host_sample(self) -> Dict[str, float]:
        try:
            with open(self._statm_path, "r", encoding="ascii") as f:
                parts = f.read().split()
            if self._page is None:
                self._page = float(os.sysconf("SC_PAGE_SIZE"))
            vms = float(parts[0]) * self._page
            rss = float(parts[1]) * self._page
        except (OSError, IndexError, ValueError):
            self.disabled = True
            log.debug("no readable %s; host memory gauges disabled", self._statm_path)
            return {}
        self._host_peak = max(self._host_peak, rss)
        return {"memory/host_rss_bytes": rss, "memory/host_rss_peak_bytes": self._host_peak,
                "memory/host_vms_bytes": vms}

    def sample(self) -> Dict[str, float]:
        """One flat gauge snapshot ({} once disabled)."""
        if self.disabled:
            return {}
        if self.device.type == "cuda":
            return self._cuda_sample()
        return self._host_sample()

    def record(self, registry) -> Dict[str, float]:
        """Sample into `registry`'s gauges and reset the watermark window;
        returns the snapshot."""
        stats = self.sample()
        for name, value in stats.items():
            registry.gauge(name).set(value)
        self._watermark = 0.0
        return stats
