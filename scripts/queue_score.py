#!/usr/bin/env python3
"""Score GroupNorm's four kernels (B4-B7) for the redesign queue.

    python3 scripts/queue_score.py RECORD.json

RECORD is what ``chip_smoke.py --record`` wrote. A kernel's score is the
device time its launches lose to the bound on chip_smoke.py's UNet paths,
summed over the shapes phase 2 measured:

    score = sum over shapes of launches at the shape x (ms - bound ms)

Launches at each shape come from a census: one forward of chip_smoke.py's
UNet on the CPU at 1/8 of the serving resolution, recording the
(rows, channels) of every GroupNorm call; rows scale with the resolution's
square. The serving path runs the forward kernels STEPS + 1 times at batch
SERVE_BATCH, the training path the forward and backward kernels
WARMUP + TIMED times at batch TRAIN_BATCH, all in bf16. A shape the paths
launch at but phase 2 does not measure (and phase 2's f32 cases, which no
path launches) adds nothing. Runs on the CPU in seconds.
"""
import collections
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the paths' configuration)

FORWARD = ("gn_stats", "gn_norm")
BACKWARD = ("gn_bwd_stats", "gn_bwd_dx")
SCALE = 8   # the census runs at RESOLUTION / SCALE


def census() -> collections.Counter:
    """{(rows at RESOLUTION, channels): GroupNorm calls} of one UNet forward."""
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.ops import fused_norm

    seen = collections.Counter()
    stats = fused_norm.groupnorm_stats

    def spy(x, groups):
        seen[(x.shape[1] * SCALE ** 2, x.shape[2])] += 1
        return stats(x, groups)

    fused_norm.groupnorm_stats = spy
    try:
        torch.manual_seed(0)
        model = Unet(**cs.UNET, device="cpu").eval()
        res = cs.RESOLUTION // SCALE
        with torch.no_grad():
            model(torch.randn(1, res, res, 3), torch.full((1,), 500.0),
                  torch.randn(1, cs.TEXT_LEN, cs.TEXT_DIM))
    finally:
        fused_norm.groupnorm_stats = stats
    return seen


def launches_by_shape(per_forward: collections.Counter) -> dict:
    """{kernel: {(batch, rows, channels): launches}} over the two UNet paths."""
    train_div = (cs.RESOLUTION // cs.TRAIN_RES) ** 2
    out = {name: collections.Counter() for name in FORWARD + BACKWARD}
    for (hw, c), n in per_forward.items():
        for name in FORWARD:
            out[name][(cs.SERVE_BATCH, hw, c)] += n * (cs.STEPS + 1)
        for name in FORWARD + BACKWARD:
            out[name][(cs.TRAIN_BATCH, hw // train_div, c)] += n * (cs.WARMUP + cs.TIMED)
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        record = json.load(f)
    per_forward = census()
    counts = launches_by_shape(per_forward)
    print(f"census of one forward ({sum(per_forward.values())} GroupNorm calls): "
          + ", ".join(f"[{hw},{c}] x{n}" for (hw, c), n in sorted(per_forward.items())))
    for kernel in record["kernels"]:
        name = kernel["name"]
        if name not in counts:
            continue
        score = 0.0
        for case in kernel["cases"]:
            if case["dtype"] != "bfloat16":
                continue
            n = counts[name].get(tuple(case["shape"]), 0)
            lost = n * (case["ms"] - case["bound_ms"])
            score += lost
            print(f"  {name} {case['shape']}: {n} launches x ({case['ms']:.4f} - "
                  f"{case['bound_ms']:.4f}) ms = {lost:.2f}")
        unmeasured = sum(n for shape, n in counts[name].items()
                         if list(shape) not in [c["shape"] for c in kernel["cases"]])
        print(f"{name}: score {score:.1f} ({kernel['launches']} launches on the four paths, "
              f"{unmeasured} of them at shapes phase 2 does not measure)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
