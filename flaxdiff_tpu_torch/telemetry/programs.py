"""Program evidence registry (counterpart of
``flaxdiff_tpu/telemetry/programs.py``): one row per hot program in
``programs.jsonl``, under the key its owner dispatches it by: the train
step and its monitored twin, every serving engine program.

    kind            train_step | train_step_monitored | chunk | terminal | ...
    key             the owner's cache key (stringified; stable across runs
                    of one configuration)
    compile_ms      the first call's wall time. There is no separate compile
                    in the port: the first call pays any kernel build, the
                    allocator's warm-up and the library's algorithm choice
                    (``extra.compile_source`` says so on every row)
    flops_jaxpr     model FLOPs of one call at true shapes
                    (``profiling.FlopCounter``: matrix products, convolutions
                    and attention; ``extra.flops_source`` names the counter).
                    The key keeps the JAX package's name, which
                    ``scripts/diagnose_run.py`` reads
    flops_cost /    None: the port has no compiler cost analysis
    bytes_cost
    hbm_peak_bytes  the CUDA allocator's peak at registration (None on the
                    CPU)
    collectives     None / {}: one device, no collectives
    fingerprint     the device (``hardware_fingerprint``)

Rows are written with sorted keys, fixed separators and floats rounded to
3 digits (``stable_json``), so the same inputs give the same bytes.
``annotate`` appends ``program_update`` rows (the device profiler's measured
fields), which ``read_registry`` merges into their program's row. A hub
without a registry (the disabled default) registers nothing.
"""
from __future__ import annotations

import json
import os
import platform
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

PROGRAMS_FILENAME = "programs.jsonl"

# what compile_ms means in the port, on every row
COMPILE_SOURCE = "first_call_wall_ms (kernel builds, allocator warm-up, library algorithm choice)"
FLOPS_SOURCE = "flaxdiff_tpu_torch.profiling.FlopCounter"


def hardware_fingerprint(device: Any = None) -> Dict[str, Any]:
    """The device's identity: two runs whose fingerprints differ are
    different experiments, not a regression. A CUDA device gives its name,
    compute capability, SM count and memory
    (``torch.cuda.get_device_properties``); the CPU its platform."""
    out: Dict[str, Any] = {"torch": torch.__version__}
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        out.update(platform="gpu", device_kind=props.name,
                   device_count=torch.cuda.device_count(),
                   compute_capability=f"{props.major}.{props.minor}",
                   sm_count=int(props.multi_processor_count),
                   memory_bytes=int(props.total_memory), cuda=torch.version.cuda)
    else:
        out.update(platform="cpu", device_kind=platform.machine() or "cpu", device_count=1)
    return out


def _round_floats(v, ndigits: int = 3):
    if isinstance(v, float):
        return round(v, ndigits)
    if isinstance(v, dict):
        return {k: _round_floats(x, ndigits) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_round_floats(x, ndigits) for x in v]
    return v


def stable_json(row: Dict[str, Any]) -> str:
    """Deterministic one-line encoding: sorted keys, fixed separators,
    floats rounded to 3 digits."""
    return json.dumps(_round_floats(row), sort_keys=True, separators=(",", ":"))


def read_registry(path: str) -> List[Dict[str, Any]]:
    """Rows of a ``programs.jsonl`` (a torn last line is skipped), each
    ``program_update`` merged into its program row (by kind and key) rather
    than returned; an update whose program row is missing is dropped."""
    rows: List[Dict[str, Any]] = []
    index: Dict[Tuple[str, str], Dict[str, Any]] = {}
    if not os.path.exists(path):
        return rows
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("type") == "program_update":
                tgt = index.get((rec.get("kind"), rec.get("key")))
                if tgt is not None:
                    tgt.update({k: v for k, v in rec.items()
                                if k not in ("type", "kind", "key")})
                continue
            if rec.get("type") == "program":
                index[(rec.get("kind"), rec.get("key"))] = rec
            rows.append(rec)
    return rows


class ProgramRegistry:
    """Append-only evidence registry, one row per (kind, key): the first
    registration wins, later ones are cache hits with nothing new."""

    def __init__(self, path: Optional[str] = None, registry=None, device: Any = None):
        self.path = path
        self._metrics = registry
        self._device = device
        self._rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._fingerprint: Optional[Dict[str, Any]] = None

    def fingerprint(self) -> Dict[str, Any]:
        if self._fingerprint is None:
            self._fingerprint = hardware_fingerprint(self._device)
        return self._fingerprint

    def __contains__(self, ident: Tuple[str, str]) -> bool:
        with self._lock:
            return (str(ident[0]), str(ident[1])) in self._rows

    def record(self, kind: str, key: Any, *, compile_ms: Optional[float] = None,
               flops_jaxpr: Optional[float] = None, flops_cost: Optional[float] = None,
               bytes_cost: Optional[float] = None, hbm_peak_bytes: Optional[float] = None,
               collectives: Optional[int] = None,
               comm_bytes_by_axis: Optional[Dict[str, int]] = None,
               extra: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        """Register one program; returns the row, or None when (kind, key)
        is already registered. Every row carries ``compile_source``, and a
        row with FLOPs ``flops_source``."""
        f = lambda v: float(v) if v is not None else None
        row: Dict[str, Any] = {
            "type": "program", "kind": str(kind), "key": str(key),
            "compile_ms": f(compile_ms), "flops_jaxpr": f(flops_jaxpr),
            "flops_cost": f(flops_cost), "bytes_cost": f(bytes_cost),
            "hbm_peak_bytes": f(hbm_peak_bytes),
            "collectives": int(collectives) if collectives is not None else None,
            "comm_bytes_by_axis": {str(k): int(v)
                                   for k, v in sorted((comm_bytes_by_axis or {}).items())},
            "fingerprint": self.fingerprint(),
            "compile_source": COMPILE_SOURCE,
        }
        if flops_jaxpr is not None:
            row["flops_source"] = FLOPS_SOURCE
        if extra:
            row.update(extra)
        ident = (row["kind"], row["key"])
        with self._lock:
            if ident in self._rows:
                return None
            self._rows[ident] = row
            if self.path:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)) or ".", exist_ok=True)
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(stable_json(row) + "\n")
        if self._metrics is not None:
            self._metrics.counter("telemetry/programs_registered").inc()
        return row

    def annotate(self, kind: str, key: Any, fields: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Write measured fields onto a registered program: the row in
        memory is updated and a ``program_update`` row appended (the base
        row's bytes never change). None when (kind, key) was never
        registered."""
        ident = (str(kind), str(key))
        clean = {k: v for k, v in fields.items() if k not in ("type", "kind", "key")}
        with self._lock:
            row = self._rows.get(ident)
            if row is None:
                return None
            row.update(clean)
            if self.path:
                rec: Dict[str, Any] = {"type": "program_update", "kind": ident[0],
                                       "key": ident[1]}
                rec.update(clean)
                with open(self.path, "a", encoding="utf-8") as fh:
                    fh.write(stable_json(rec) + "\n")
        return row

    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rows.values())

    def keys(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._rows)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)


def peak_allocated(device: Any) -> Optional[float]:
    """The CUDA allocator's peak bytes on `device`; None off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return float(torch.cuda.max_memory_allocated(dev))
