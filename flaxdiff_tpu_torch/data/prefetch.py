"""Pipelined host-side work and host-to-device copies (counterpart of
``flaxdiff_tpu/data/prefetch.py``): per-batch CPU work (text encoding) runs
in a background thread `depth` batches ahead, and batches reach the card
through pinned buffers and a side stream, so neither serialises with the
device's steps.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Callable, Iterator, Mapping, TypeVar

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def _put_until(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """A blocking put that gives up once `stop` is set."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _unpack(got):
    """A queue item: the value, or raise what the worker raised, or
    StopIteration at the end."""
    if isinstance(got, tuple) and len(got) == 2 and got[0] is _SENTINEL:
        if got[1] is not None:
            raise got[1]
        raise StopIteration
    return got


def prefetch_map(fn: Callable[[T], U], it: Iterator[T], depth: int = 2) -> Iterator[U]:
    """Apply `fn` to the items of `it` in a daemon thread, keeping up to
    `depth` results ready, in order. An exception in `fn` or the source
    re-raises at the consumer's ``next()``; closing or dropping the
    generator stops the worker (flaxdiff_tpu/data/prefetch.py:27)."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                if not _put_until(q, fn(item), stop):
                    return
        except BaseException as e:     # surfaced on the consumer side
            _put_until(q, (_SENTINEL, e), stop)
            return
        _put_until(q, (_SENTINEL, None), stop)

    threading.Thread(target=worker, daemon=True, name="flaxdiff-prefetch").start()
    try:
        while True:
            try:
                item = _unpack(q.get())
            except StopIteration:
                return
            yield item
    finally:
        stop.set()


def _numeric(batch: Mapping) -> dict:
    """The batch's arrays and tensors; captions and other Python values are
    dropped (the train step consumes "sample" and "cond" only)."""
    return {k: v for k, v in batch.items()
            if isinstance(v, torch.Tensor) or (isinstance(v, np.ndarray) and v.dtype.kind in "biuf")}


class prefetch_to_device:
    """Upload host batches to `device` in a background thread, keeping up
    to `depth` batches ready, in order (counterpart of
    ``flaxdiff_tpu/data/prefetch.py:86-224``). Exceptions re-raise at
    ``next()``; ``close()`` stops the worker with a bounded join, so the
    source iterator can go to another consumer.

    On the card each batch is copied into pinned host buffers, then to the
    device with ``non_blocking=True`` on a side stream, and an event is
    recorded after the copy. ``next()`` makes the current stream wait on
    that event and calls ``record_stream`` on each tensor for the stream
    that uses it, so the allocator does not hand its memory back to the copy
    stream early. A pinned buffer is refilled only after its copy's event
    has completed (polled, never a blocking wait). There is no synchronous
    fallback: a CUDA device takes this path or raises. On the CPU a batch is
    a plain ``to(device)``."""

    JOIN_TIMEOUT_S = 5.0

    def __init__(self, it: Iterator[Mapping], device, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:     # the worker thread sets it by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        # ring of pinned buffer sets; slot j % n serves upload j. The queue
        # holds `depth`, the consumer one more, one is being filled
        slots = [[{}, None] for _ in range(depth + 2)] if cuda else []

        def upload(batch, j):
            if not cuda:
                return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}, None
            slot = slots[j % len(slots)]
            event = slot[1]
            while event is not None and not event.query():
                if self._stop.is_set():
                    return None
                time.sleep(1e-4)
            pinned = slot[0]
            for k, v in batch.items():
                v = torch.as_tensor(v)
                buf = pinned.get(k)
                if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                    buf = pinned[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v)
            with torch.cuda.stream(stream):
                out = {k: pinned[k].to(self.device, non_blocking=True) for k in batch}
                slot[1] = torch.cuda.Event()
                slot[1].record(stream)
            return out, slot[1]

        def worker():
            nonlocal stream
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                    stream = torch.cuda.Stream(self.device)
                for j, item in enumerate(it):
                    if self._stop.is_set():
                        return
                    out = upload(_numeric(item), j)
                    if out is None or not _put_until(self._q, out, self._stop):
                        return
            except BaseException as e:
                _put_until(self._q, (_SENTINEL, e), self._stop)
                return
            _put_until(self._q, (_SENTINEL, None), self._stop)

        stream = None
        self._thread = threading.Thread(target=worker, daemon=True, name="flaxdiff-upload")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._done:
            raise StopIteration
        try:
            batch, event = _unpack(self._q.get())
        except BaseException:
            self._done = True
            raise
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def close(self) -> None:
        """Stop the worker and join it (bounded); batches already uploaded
        are dropped. A worker stuck inside the source iterator past
        ``JOIN_TIMEOUT_S`` is left behind (a daemon) with a warning."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._done = True
        self._thread.join(self.JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            warnings.warn(f"the upload worker did not stop within {self.JOIN_TIMEOUT_S} s "
                          "(source iterator wedged?)", RuntimeWarning, stacklevel=2)
