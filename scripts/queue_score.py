#!/usr/bin/env python3
"""Score every kernel for the redesign queue from a chip_smoke.py record.

    python3 scripts/queue_score.py RECORD.json

RECORD is what ``chip_smoke.py --record`` wrote. A kernel's score is the
device time its launches lose to the bound on chip_smoke.py's paths, summed
over the shapes phase 2 measured:

    score = sum over shapes of launches at the shape x (ms - bound ms)

Launches at each shape come from a census on the CPU: one forward of each
path's model (the UNet at 1/8 of the serving resolution, token counts scaled
back by the square; DiT-B/2 and the 1280-channel, 4 x 320 transformer block
at full size), recording the shape of every call of the forward kernels'
wrappers (flash, GroupNorm, GEGLU, LayerNorm + modulate, gated residual).
Each path runs its forward kernels once a model call and, when it trains,
each backward kernel once a forward call of its twin:

- the UNet serving path: STEPS + 1 calls at batch SERVE_BATCH, bf16;
- the UNet training path: WARMUP + TIMED steps at TRAIN_BATCH and TRAIN_RES;
- the DiT serving path: STEPS + 1 calls at 2 x DIT_SERVE_BATCH;
- the DiT training path: WARMUP + TIMED steps at DIT_TRAIN_BATCH;
- the 4 x 320 block (the wide flash kernels): one f32 step at batch 2.

A shape the paths launch at but phase 2 does not measure adds nothing, and
the script says how many launches that is. Runs on the CPU in seconds.
"""
import collections
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the paths' configuration)

SCALE = 8   # the UNet census runs at RESOLUTION / SCALE
# forward kernel -> the kernels launched as often at its shapes: forward
# twins on every path, backward kernels on the training paths
TWINS = {"gn_stats": ("gn_norm",), "flash_fwd": (), "flash_fwd_wide": (), "geglu": (),
         "ln_mod": (), "gate_res": ()}
BACKWARD = {"gn_stats": ("gn_bwd_stats", "gn_bwd_dx"),
            "flash_fwd": ("flash_bwd_dq", "flash_bwd_dkv"),
            "flash_fwd_wide": ("flash_bwd_dq_wide", "flash_bwd_dkv_wide"),
            "geglu": ("geglu_bwd",), "ln_mod": ("ln_mod_bwd",), "gate_res": ("gate_res_bwd",)}


def census(model, args, tokens: int = 1) -> collections.Counter:
    """{(kernel, shape without the batch): calls} of one forward of `model`;
    token counts are multiplied by `tokens` (self-attention's keys too, the
    text's 77 keys not)."""
    from flaxdiff_tpu_torch.ops import fused_adaln, fused_norm
    # the module (the package exports the function of the same name)
    fa = importlib.import_module("flaxdiff_tpu_torch.ops.flash_attention")

    def attention(q, k, *_):
        self_attention = k.shape[1] == q.shape[1]
        return (q.shape[1] * tokens, k.shape[1] * (tokens if self_attention else 1),
                q.shape[2], q.shape[3])

    rows = lambda x, *_: (x.shape[1] * tokens, x.shape[2])
    # (module, wrapper) -> (kernel, shape of a call)
    spied = {(fa, "flash_fwd"): ("flash_fwd", attention),
             (fa, "flash_fwd_wide"): ("flash_fwd_wide", attention),
             (fused_norm, "groupnorm_stats"): ("gn_stats", rows),
             (fused_adaln, "geglu_fwd"): ("geglu", rows),
             (fused_adaln, "ln_modulate_fwd"): ("ln_mod",
                                                lambda x, pairs, *_: rows(x) + (len(pairs),)),
             (fused_adaln, "gate_residual_fwd"): ("gate_res", rows)}
    seen, saved = collections.Counter(), {}

    def spy(real, kernel, key):
        def call(*a, **kw):
            seen[(kernel, key(*a))] += 1
            return real(*a, **kw)
        return call

    for (module, attr), (kernel, key) in spied.items():
        saved[(module, attr)] = getattr(module, attr)
        setattr(module, attr, spy(saved[(module, attr)], kernel, key))
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for (module, attr), real in saved.items():
            setattr(module, attr, real)
    return seen


def path_censuses() -> list:
    """(path, batch, calls, trains, dtype, per-call census) for each path."""
    from flaxdiff_tpu_torch.models import SimpleDiT, Unet
    from flaxdiff_tpu_torch.models.attention import TransformerBlock

    torch.manual_seed(0)
    text = torch.randn(1, cs.TEXT_LEN, cs.TEXT_DIM)
    res = cs.RESOLUTION // SCALE
    unet = Unet(**cs.UNET, device="cpu").eval()
    x = torch.randn(1, res, res, 3)
    serve = census(unet, (x, torch.full((1,), 500.0), text), SCALE ** 2)
    train = census(unet, (x, torch.full((1,), 500.0), text),
                   (cs.TRAIN_RES * SCALE // cs.RESOLUTION) ** 2)
    dit = SimpleDiT(**cs.DIT, device="cpu").eval()
    latent = torch.randn(1, cs.DIT_RES, cs.DIT_RES, cs.DIT_CH)
    dit_calls = census(dit, (latent, torch.full((1,), 500.0), text))
    w = cs.UNET3D_LEVEL
    block = TransformerBlock(w["dim"], cs.TEXT_DIM, heads=w["heads"], dim_head=w["dim_head"],
                             device="cpu")
    block_calls = census(block, (torch.randn(1, w["side"], w["side"], w["dim"]), text))
    steps, calls = cs.WARMUP + cs.TIMED, cs.STEPS + 1
    return [("unet_serving", cs.SERVE_BATCH, calls, False, "bfloat16", serve),
            ("unet_training", cs.TRAIN_BATCH, steps, True, "bfloat16", train),
            ("dit_serving", 2 * cs.DIT_SERVE_BATCH, calls, False, "bfloat16", dit_calls),
            ("dit_training", cs.DIT_TRAIN_BATCH, steps, True, "bfloat16", dit_calls),
            ("unet3d_block_320", 2, 1, True, "float32", block_calls)]


def launches_by_shape(paths: list) -> dict:
    """{kernel: {(dtype, (batch, *shape)): launches}} over the paths."""
    out = collections.defaultdict(collections.Counter)
    for _, batch, calls, trains, dtype, seen in paths:
        for (name, shape), n in seen.items():
            for kernel in (name,) + TWINS[name] + (BACKWARD[name] if trains else ()):
                out[kernel][(dtype, (batch,) + shape)] += n * calls
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        record = json.load(f)
    paths = path_censuses()
    for name, batch, calls, trains, dtype, seen in paths:
        print(f"census {name} (batch {batch}, {calls} calls, {dtype}"
              f"{', with backward' if trains else ''}): "
              + ", ".join(f"{k} {list(s)} x{n}" for (k, s), n in sorted(seen.items())))
    counts = launches_by_shape(paths)
    scores = []
    for kernel in record["kernels"]:
        name = kernel["name"]
        score, measured = 0.0, set()
        for case in kernel["cases"]:
            key = (case["dtype"], tuple(case["shape"]))
            n = counts[name].get(key, 0)
            if not n:
                continue
            measured.add(key)
            lost = n * (case["ms"] - case["bound_ms"])
            score += lost
            print(f"  {name} {case['shape']} {case['dtype']}: {n} launches x ({case['ms']:.4f} - "
                  f"{case['bound_ms']:.4f}) ms = {lost:.2f}")
        total = sum(counts[name].values())
        unmeasured = sum(n for key, n in counts[name].items() if key not in measured)
        print(f"{name}: score {score:.1f} ({total} launches on the paths, {unmeasured} of them "
              f"at shapes phase 2 does not measure)")
        scores.append((score, name))
    print("by score: " + ", ".join(f"{name} {score:.1f}" for score, name in sorted(scores,
                                                                                  reverse=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
