"""A small world of gloo processes for the port's multi-rank CPU tests.

A test module is its own worker: ``spawn(__file__, world, outdir)`` starts
`world` copies of it (``python FILE RANK WORLD PORT OUTDIR``), each of which
joins one gloo process group and runs every case of the module in order
(``run_worker``), writing its results under OUTDIR. One world serves all of
a module's cases. The world has a hard deadline, and any process that fails
takes its siblings down at once, so a broken collective never hangs the
test run. Workers import torch and the port only, and use one torch thread.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict

ROOT = Path(__file__).resolve().parent.parent
WORLD_TIMEOUT = 120.0      # seconds a world may take, start to end


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class World:
    """The running processes; ``wait()`` returns once all exited 0, and
    fails (killing the rest) at the first that did not, or at the
    deadline."""

    def __init__(self, procs, logs, deadline: float):
        self.procs, self.logs, self.deadline = procs, logs, deadline
        self._done = False

    def _tail(self, rank: int) -> str:
        return Path(self.logs[rank]).read_text(errors="replace")[-3000:]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self) -> None:
        if self._done:
            return
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise AssertionError(f"rank {bad[0]} exited {codes[bad[0]]}:\n"
                                         f"{self._tail(bad[0])}")
                if all(c == 0 for c in codes):
                    self._done = True
                    return
                if time.monotonic() > self.deadline:
                    raise AssertionError(f"the world passed its {WORLD_TIMEOUT:.0f} s deadline:\n"
                                         f"{self._tail(0)}")
                time.sleep(0.05)
        finally:
            self.kill()


def spawn(script: str, world: int, outdir: str, timeout: float = WORLD_TIMEOUT,
          env: Dict[str, str] = None, backend: str = "gloo") -> World:
    """Start `world` ranks of `script` writing under `outdir`; with
    ``backend="nccl"`` rank r drives card r."""
    os.makedirs(outdir, exist_ok=True)
    port = free_port()
    base = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    base.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TORCH_WORLD_BACKEND=backend,
                **(env or {}))
    procs, logs = [], []
    for rank in range(world):
        log = os.path.join(outdir, f"rank{rank}.log")
        with open(log, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, script, str(rank), str(world), str(port), outdir],
                stdout=fh, stderr=subprocess.STDOUT, env=base, cwd=str(ROOT)))
        logs.append(log)
    return World(procs, logs, time.monotonic() + timeout)


def run_worker(cases: Dict[str, Callable[[int, int, str], None]]) -> None:
    """A worker's main: join the process group from argv (gloo, or NCCL on
    card `rank`) and run each case ``case(rank, world, outdir)`` in order;
    any exception exits 1."""
    import torch
    import torch.distributed as dist
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4])
    torch.set_num_threads(1)
    backend = os.environ.get("TORCH_WORLD_BACKEND", "gloo")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        for name, case in cases.items():
            case(rank, world, outdir)
            print(f"case {name} done", flush=True)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()
