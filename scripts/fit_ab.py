"""Time DiffusionTrainer.fit against the plain train_step loop on one card.

    PYTHONPATH=. python3 scripts/fit_ab.py [--out RESULT.json]

Builds chip_smoke.py phase 10's trainer through
flaxdiff_tpu_torch.train.make_run (the full-width UNet, the hash encoder,
batch 16 at 128x128, bf16, the CLI's clip + adamw chain) and times 20 steps
of each variant, --rounds rounds in alternating order (host clock between
CUDA synchronizations, ms per step). Each variant adds one layer to the one
above it, so the differences of the medians attribute fit's time:
  loop         train_step over 4 batches already on the card (phase 5's loop)
  loop_upload  train_step over 4 host batches cycled through prefetch_to_device
               (the upload thread, no fit logic)
  fit_d0       fit over the same host batches at pipeline_depth 0 (adds the
               window fetch and rollback checks, no step events)
  fit_host     the same at pipeline_depth 2 (adds the events that bound the
               steps in flight)
  fit_cli      fit over the CLI's stream (adds the loader and text encoding)
  loop_plain   loop with AdamW at a constant rate and no clip
  encode_only  the CLI's host stream alone, per batch
The checkpointer is off: fit's save is not what is timed. Needs CUDA.
"""
import argparse
import dataclasses
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
from flaxdiff_tpu_torch.data import prefetch_to_device  # noqa: E402
from flaxdiff_tpu_torch.trainer import AdamW  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--out", help="also write the times here as JSON")
parser.add_argument("--rounds", type=int, default=3)
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("fit_ab: no CUDA device")
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
root = tempfile.mkdtemp()
run = train.make_run(cs.cli_args(os.path.join(root, "a"), 10 ** 6, dev))
tr = run.trainer
tr.checkpointer = None       # fit's final save is not what is timed here
print("cores", os.cpu_count(), "torch threads", torch.get_num_threads(), flush=True)
src = run.batches(0)
host = [next(src) for _ in range(4)]
host = [{"sample": b["sample"], "cond": b["cond"]} for b in host]
devb = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()} for b in host]
N = 20


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / N


def loop():
    for i in range(N):
        tr.train_step(devb[i % 4])


def loop_plain():
    tx = tr.state.tx
    tr.state.tx = AdamW(1e-4)
    try:
        loop()
    finally:
        tr.state.tx = tx


def cycle(batches):
    i = 0
    while True:
        yield dict(batches[i % len(batches)])
        i += 1


def loop_upload():
    upload = prefetch_to_device(cycle(host), dev, depth=2)
    try:
        for _ in range(N):
            tr.train_step(next(upload))
    finally:
        upload.close()


def fit_d0():
    cfg = tr.config
    tr.config = dataclasses.replace(cfg, pipeline_depth=0)
    try:
        tr.fit(cycle(host), N)
    finally:
        tr.config = cfg


def fit_host():
    tr.fit(cycle(host), N)


def fit_cli():
    tr.fit(run.batches(0), N)


def encode_only():
    it = run.batches(0)
    for _ in range(N):
        next(it)


variants = {"loop": loop, "loop_upload": loop_upload, "fit_d0": fit_d0, "fit_host": fit_host,
            "fit_cli": fit_cli, "loop_plain": loop_plain, "encode_only": encode_only}
loop()
fit_host()
res = {k: [] for k in variants}
for rnd in range(args.rounds):
    order = list(variants) if rnd % 2 == 0 else list(reversed(variants))
    for k in order:
        res[k].append(timed(variants[k]))
    print(rnd, {k: round(v[-1], 2) for k, v in res.items()}, flush=True)
print(json.dumps({k: {"median": float(np.median(v)), "all": v} for k, v in res.items()}))
if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "ms_per_step": res}, f)
shutil.rmtree(root, ignore_errors=True)
