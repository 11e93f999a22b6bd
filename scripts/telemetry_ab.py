"""Time DiffusionTrainer.fit with and without a telemetry hub on one card.

    PYTHONPATH=. python3 scripts/telemetry_ab.py [--rounds 4] [--out RESULT.json]

Builds chip_smoke.py phase 10's trainer through flaxdiff_tpu_torch.train.make_run
(the full-width UNet, the hash encoder, batch 16 at 128x128, bf16, the CLI's
clip + adamw chain; the checkpointer off) and runs fit for 24 steps in windows of
8 under each variant, --rounds rounds in alternating order:
  plain   the process-global hub (disabled): no sync, no file
  tel1    an enabled hub (Telemetry.create), the device phase closed every step
  tel4    the same, closed every 4th step (the CLI's --telemetry_sample_every 4)
Each fit's first step runs under the FLOP counter when a hub is enabled (and
builds nothing: the first round warms every variant), so the steady cost is
the median of windows 2-3 (host clock, ms per step); the whole fit's wall per
step is printed beside it. Needs CUDA.
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
from flaxdiff_tpu_torch.telemetry import Telemetry  # noqa: E402

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--out", help="also write the times here as JSON")
parser.add_argument("--rounds", type=int, default=4)
args = parser.parse_args()
if not torch.cuda.is_available():
    sys.exit("telemetry_ab: no CUDA device")
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
root = tempfile.mkdtemp()
N, WINDOW = 24, 8
run = train.make_run(cs.with_flags(cs.cli_args(os.path.join(root, "a"), 10 ** 6, dev),
                                   log_every=str(WINDOW)))
tr = run.trainer
tr.checkpointer = None       # fit's final save is not what is timed here
src = run.batches(0)
host = [{k: v for k, v in next(src).items() if k in ("sample", "cond")} for _ in range(4)]
hubs = {"tel1": Telemetry.create(os.path.join(root, "tel1")),
        "tel4": Telemetry.create(os.path.join(root, "tel4"))}


def cycle(batches):
    i = 0
    while True:
        yield dict(batches[i % len(batches)])
        i += 1


def variant(name):
    import dataclasses
    tr.telemetry = hubs.get(name)
    tr.config = dataclasses.replace(tr.config, telemetry_sample_every=4 if name == "tel4" else 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.fit(cycle(host), N)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / N
    windows = [cs.TRAIN_BATCH * 1e3 / ips for ips in hist["imgs_per_sec"]]
    return float(np.median(windows[1:])), wall


names = ("plain", "tel1", "tel4")
for name in names:          # warm-up: every variant once
    variant(name)
res = {k: {"steady": [], "wall": []} for k in names}
for rnd in range(args.rounds):
    for name in (names if rnd % 2 == 0 else tuple(reversed(names))):
        steady, wall = variant(name)
        res[name]["steady"].append(steady)
        res[name]["wall"].append(wall)
    print(rnd, {k: round(v["steady"][-1], 3) for k, v in res.items()}, flush=True)
smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                        capture_output=True, text=True).stdout.strip()
summary = {k: {"steady_median_ms": float(np.median(v["steady"])),
               "wall_median_ms": float(np.median(v["wall"])), **v} for k, v in res.items()}
print(smi)
print(json.dumps(summary))
if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                   "ms_per_step": summary}, f)
for hub in hubs.values():
    hub.close()
shutil.rmtree(root, ignore_errors=True)
