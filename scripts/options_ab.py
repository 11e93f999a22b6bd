"""Time the training step under train.py's training options on one card.

    PYTHONPATH=. python3 scripts/options_ab.py [--out RESULT.json] [--rounds N]

Builds chip_smoke.py phase 10's trainer through
flaxdiff_tpu_torch.train.make_run (the full-width UNet, the hash encoder,
batch 16 at 128x128) once per variant and times 20 train_steps of each over
4 batches already on the card (phase 5's loop), --rounds rounds in
alternating order: CUDA events around the 20 steps, and the host clock. Each
variant adds one option to the one above it, so the differences of the
medians attribute the step's time:
  bf16         phase 10's configuration: bf16, clip + adamw
  f16          --dtype float16: the loss scale (scaled loss, the verdict,
               the restore of params and optimizer state)
  f16_accum4   + --grad_accum 4 (the accumulator, the update on every
               micro-step, its state kept on the emit step only)
  f16_lamb4    + --optimizer lamb (the per-leaf norms, the trust ratio)
  f16_all      + --loss_ring 16 --gate_counter (phase 12's step)
Then one step of each under torch.profiler: its kernels, their device time
and the host operators with the most self CPU time. Needs CUDA.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from flaxdiff_tpu_torch import train  # noqa: E402

VARIANTS = {
    "bf16": {},
    "f16": {"dtype": "float16"},
    "f16_accum4": {"dtype": "float16", "grad_accum": 4},
    "f16_lamb4": {"dtype": "float16", "grad_accum": 4, "optimizer": "lamb"},
    "f16_all": {"dtype": "float16", "grad_accum": 4, "optimizer": "lamb", "loss_ring": 16,
                "gate_counter": True},
}
STEPS = 20

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--out", help="also write the times here as JSON")
parser.add_argument("--rounds", type=int, default=3)
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("options_ab: no CUDA device")
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
root = tempfile.mkdtemp()
trainers, batches = {}, None
try:
    for name, flags in VARIANTS.items():
        run = train.make_run(cs.with_flags(cs.cli_args(os.path.join(root, name), 10 ** 6, dev),
                                           **flags))
        run.trainer.checkpointer = None
        if batches is None:
            src = run.batches(0)
            batches = [{k: torch.as_tensor(v).to(dev) for k, v in next(src).items()
                        if k in ("sample", "cond")} for _ in range(4)]
            src.close()
        for i in range(3):
            run.trainer.train_step(batches[i % 4])
        trainers[name] = run.trainer
    torch.cuda.synchronize()

    times = {name: {"ms": [], "host_ms": []} for name in VARIANTS}
    order = list(VARIANTS)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            tr = trainers[name]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for i in range(STEPS):
                tr.train_step(batches[i % 4])
            end.record()
            end.synchronize()
            times[name]["host_ms"].append((time.perf_counter() - t0) * 1e3 / STEPS)
            times[name]["ms"].append(start.elapsed_time(end) / STEPS)
            print(f"round {r} {name}: {times[name]['ms'][-1]:.3f} ms per step", flush=True)

    result = {"device": torch.cuda.get_device_name(0), "rounds": args.rounds, "variants": {}}
    for name, tr in trainers.items():
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.train_step(batches[0])
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
        median = float(np.median(times[name]["ms"]))
        result["variants"][name] = {
            "ms": times[name]["ms"], "host_ms": times[name]["host_ms"], "median_ms": median,
            "kernels": len(kernels), "busy_ms": busy,
            "top_self_cpu_ms": {e.key[:80]: e.self_cpu_time_total / 1e3 for e in ops},
            "top_self_cpu_calls": {e.key[:80]: e.count for e in ops}}
        print(f"{name}: median {median:.3f} ms per step, {len(kernels)} kernels, busy "
              f"{busy:.3f} ms", flush=True)
        for e in ops:
            print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms self CPU, {e.count:5d} calls  "
                  f"{e.key[:80]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
finally:
    shutil.rmtree(root, ignore_errors=True)
