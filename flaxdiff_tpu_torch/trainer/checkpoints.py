"""Step checkpoints of the train state (counterpart of
``flaxdiff_tpu/trainer/checkpoints.py:31-395``), for one process on one card.

A step is a directory ``<dir>/<step>/`` holding ``state.pt`` (the train
state's ``state_dict`` and the caller's extras, one ``torch.save`` file)
and ``meta.json``. It is written whole into a hidden temporary directory
and renamed into place (``os.replace``), ``meta.json`` last, so a step is
either there complete or not at all, as with orbax's commit: a directory
without ``meta.json``, or a temporary one a crash left behind, is never
listed or restored. Files are read back with ``torch.load(weights_only=True)``.

The save is asynchronous like orbax's: ``save`` copies the state into host
buffers (on the card, pinned memory filled by copies queued on the current
stream, so the training loop does not wait for them) and a writer thread
waits for the copies, writes the files and drops the oldest steps beyond
``max_to_keep``. ``wait_until_finished`` joins it; a write error is raised
there or at the next save.

A state sharded over a mesh (``TrainState(mesh=...)``) is saved by every
rank together: ``state_dict`` gathers the shards (a collective, run on all
ranks before any writer thread starts), and global rank 0 alone writes them
in the one-process format above. Restoring reads that file, and the state
keeps each rank's slice, so a checkpoint written under one mesh restores
under another or under none (as the JAX trainer restores onto any mesh).

Not ported: ``torch.distributed.checkpoint`` sharded files, coordinated
commits, the step ledger, retries and verification (ROADMAP.md A14's
second half).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

STATE_FILE, META_FILE = "state.pt", "meta.json"


class Checkpointer:
    """``save(step, state, extra)`` / ``restore(step=None)`` over numbered
    step directories; keeps the newest `max_to_keep` steps. When to save is
    the caller's choice (``DiffusionTrainer.fit``'s `save_every`)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.last_save_result = "none"   # "started" | "skipped_exists"
        self.last_save = {}              # seconds blocked in save(), bytes, seconds writing
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._host: dict[str, torch.Tensor] = {}   # reused host copies of the state's buffers

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        """Every complete step on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name, META_FILE)))

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _host_copy(self, name: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._host[name] = buf
        return buf.copy_(t, non_blocking=t.is_cuda)

    def save(self, step: int, state, extra: Optional[Mapping[str, Any]] = None) -> bool:
        """Start writing `state` (a ``TrainState``) and `extra` (tensors and
        plain values) as `step`; returns whether a save started. A step
        already on disk is not rewritten (after a rollback the re-reached
        step's files hold the earlier state). A sharded state gathers on
        every rank first; only global rank 0 looks at the directory and
        writes, and the other ranks report ``"started"``."""
        self.wait_until_finished()
        sharded = getattr(state, "mesh", None) is not None
        writer = not sharded or dist.get_rank() == 0
        t0 = time.perf_counter()
        payload = state.state_dict() if sharded else None
        if not writer:
            self.last_save_result = "started"
            self.last_save = {"step": step, "blocked_s": time.perf_counter() - t0}
            return True
        if step in self.all_steps():
            self.last_save_result = "skipped_exists"
            return False
        if payload is None:
            payload = state.state_dict()
        for name, t in list(payload.items()):
            if isinstance(t, torch.Tensor):
                payload[name] = self._host_copy(name, t)
        ready = None
        if any(t.is_cuda for t in state.buffers().values() if t is not None):
            ready = torch.cuda.Event()
            ready.record()
        payload = {"state": payload, "extra": dict(extra or {})}
        self._thread = threading.Thread(target=self._write, args=(step, payload, ready),
                                        name="flaxdiff-checkpoint")
        self._thread.start()
        self.last_save_result = "started"
        self.last_save = {"step": step, "blocked_s": time.perf_counter() - t0}
        return True

    def _write(self, step: int, payload: dict, ready: Optional[torch.cuda.Event]) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        try:
            if ready is not None:
                ready.synchronize()
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            path = os.path.join(tmp, STATE_FILE)
            torch.save(payload, path)
            nbytes = os.path.getsize(path)
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump({"step": step, "bytes": nbytes}, f)
            # a step directory without meta.json is a crashed write's
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            os.replace(tmp, self._step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
            self.last_save.update(bytes=nbytes, write_s=time.perf_counter() - t0)
        except BaseException as e:     # raised in the caller's thread
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def wait_until_finished(self) -> None:
        """Join the writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, step: Optional[int] = None) -> tuple[dict, dict]:
        """(state_dict, extra) of `step` (default: the newest), on the CPU."""
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        if step not in self.all_steps():
            raise FileNotFoundError(f"no complete step {step} under {self.directory}")
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        return payload["state"], payload["extra"]

    def close(self) -> None:
        self.wait_until_finished()
        self._host.clear()
