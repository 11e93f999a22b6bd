"""Training loggers (counterpart of ``flaxdiff_tpu/trainer/logging.py``):
a small protocol (``log``, ``log_images``, ``finish``) with a JSONL file
logger as the system of record, a fan-out, and a resilience-event stream.

The JAX package layers a wandb adapter on top; wandb is not installed on the
port's machines, so ``make_logger(project=...)`` raises naming it (the run
would otherwise silently log nowhere it asked for). Image grids are PNG,
written with the port's own encoder (``data.encode_png``).
"""
from __future__ import annotations

import json
import math
import numbers
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np


def save_image_grid(images, path: str, pad: int = 2) -> str:
    """Tile [N, H, W, C] (or [N, F, H, W, C]; uint8, or floats in [-1, 1],
    [0, 1] or [0, 255]) into one PNG at `path`."""
    from ..data.codec import encode_png
    from ..utils import to_unit_float
    imgs = np.asarray(images)
    if imgs.ndim == 5:
        imgs = imgs.reshape(-1, *imgs.shape[2:])
    if imgs.dtype != np.uint8:
        imgs = (to_unit_float(imgs) * 255).astype(np.uint8)
    n, h, w, c = imgs.shape
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c), np.uint8)
    for i, im in enumerate(imgs):
        r, col = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h, col * (w + pad):col * (w + pad) + w] = im
    if c == 1:
        grid = grid[..., 0]
    elif c != 3:
        raise ValueError(f"save_image_grid takes 1 or 3 channels, got {c}")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
    return path


# Largest numeric sequence JsonlLogger serializes inline. Above this a
# value is data, not a metric — dropped WITH a counter, never silently.
MAX_INLINE_SEQ = 64


def _coerce_value(v):
    """`(coerced, dropped)`: the JSON-serializable form of one metric
    value (None when the value is not representable as a (small)
    metric) plus the number of entries lost at ANY depth, so sub-dict
    losses feed the `telemetry/dropped_keys` counter too. Scalars
    coerce as before; small numeric sequences (lists/tuples/arrays <=
    MAX_INLINE_SEQ elements) serialize as lists; dicts coerce per-entry
    one level deep (None entries dropped from the sub-dict)."""
    if isinstance(v, (str, bool, type(None))):
        return v, 0
    if isinstance(v, numbers.Integral):
        return int(v), 0                 # covers np.int32/int64
    if isinstance(v, numbers.Real):
        return float(v), 0               # covers np.float32/float64
    if isinstance(v, dict):
        out, dropped = {}, 0
        for k, sub in v.items():
            c, d = _coerce_value(sub)
            dropped += d
            if c is not None or sub is None:
                out[str(k)] = c
        if out:
            return out, dropped
        # nothing survived: the key itself vanishes — count at least 1
        return None, max(dropped, 1)
    if isinstance(v, (list, tuple)) or type(v).__name__ == "ndarray":
        try:
            arr = np.asarray(v)
        except Exception:  # noqa: BLE001 — ragged/object input: drop
            return None, 1
        if arr.dtype.kind in "biuf" and arr.size <= MAX_INLINE_SEQ:
            return arr.tolist(), 0
        return None, 1
    return None, 1


class JsonlLogger:
    """Appends one JSON object per log call — greppable, dependency-free.
    Image grids are written as PNGs under `<dir>/samples/` and referenced
    by path in the stream.

    Values serialize per `_coerce_value`: scalars and SMALL numeric
    sequences/dicts land in the stream; anything else — including
    entries lost INSIDE a surviving sub-dict — increments the
    `telemetry/dropped_keys` counter on the global telemetry hub instead
    of vanishing invisibly."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def log(self, data: Dict[str, Any], step: Optional[int] = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        dropped = 0
        for k, v in data.items():
            c, d = _coerce_value(v)
            dropped += d                 # counts nested losses too
            if c is None and v is not None:
                continue
            rec[k] = c
        if dropped:
            from ..telemetry import global_telemetry
            global_telemetry().counter("telemetry/dropped_keys").inc(dropped)
        self._fh.write(json.dumps(rec) + "\n")

    def log_images(self, key: str, images, step: Optional[int] = None):
        name = key.replace("/", "_") + (f"_{step:06d}" if step is not None
                                        else "")
        png = os.path.join(os.path.dirname(os.path.abspath(self.path)),
                           "samples", name + ".png")
        try:
            save_image_grid(images, png)
            self.log({key: png}, step)
        except Exception as e:  # never let logging kill training
            self.log({key: f"<grid save failed: {e}>"}, step)

    def finish(self):
        self._fh.close()


class MultiLogger:
    """Fan-out to several loggers."""

    def __init__(self, loggers: Sequence[Any]):
        self.loggers = list(loggers)

    def log(self, data, step=None):
        for lg in self.loggers:
            lg.log(data, step=step)

    def log_images(self, key, images, step=None):
        for lg in self.loggers:
            lg.log_images(key, images, step=step)

    def finish(self):
        for lg in self.loggers:
            lg.finish()


def attach_resilience(logger, event_log=None):
    """Stream resilience events into `logger` as structured records
    (kind, site, detail and step). Returns a detach() callable. A raising
    sink is logged by the event log, never raised into a recovery path."""
    from ..resilience import events as _ev
    log_ = event_log if event_log is not None else _ev.global_event_log()

    def push(ev):
        logger.log({"resilience_event": ev.kind, "resilience_site": ev.site,
                    "resilience_detail": ev.detail}, step=ev.step)

    log_.subscribe(push)

    def detach():
        log_.unsubscribe(push)

    return detach


def make_logger(project: Optional[str] = None, jsonl_path: Optional[str] = None,
                **wandb_kwargs):
    """The JSONL logger at `jsonl_path` (``train_log.jsonl`` in the working
    directory without one). A `project` asks for wandb, which the port's
    machines do not have: it raises ImportError naming the package."""
    if project:
        raise ImportError(f"make_logger(project={project!r}) logs to wandb, and the wandb "
                          "package is not installed; log to JSONL (jsonl_path) instead")
    return JsonlLogger(jsonl_path or "train_log.jsonl")
