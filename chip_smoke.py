#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flaxdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Phases; any failure exits non-zero and prints no result line.
  1. Print the card's name and power limit; build the CUDA kernels from
     flaxdiff_tpu_torch/csrc with nvcc for sm_90a; print each kernel's
     registers, the registers and spills of every wgmma instantiation and,
     where cuobjdump exists, their HGMMA (wgmma) and HMMA (mma.sync) counts.
     Fails if any kernel instantiation spills, if ptxas serialised a wgmma
     (warning C7520), or if one holds no HGMMA or any HMMA.
  2. Hold each of the thirteen kernels against its plain PyTorch version on
     the card: the forward kernels at the serving paths' shapes, the backward
     kernels at the training paths' (bf16, plus one f32 case each with TF32
     off, and a ragged case for the AdaLN kernels); the flash kernels also at
     head dim 256, GroupNorm's forward kernels also at the training paths'
     shapes. Time kernel, plain version and, where one PyTorch call computes
     the same function (torch's scaled_dot_product_attention forward and
     backward, torch.var_mean over the groups, torch.addcmul; a yardstick
     the port never calls), that call, by their device time (CUDA graph
     replays timed by CUDA events), beside the byte/flop bound; the flash
     cases also with their TFLOP/s and share of the bound. GroupNorm's
     forward and backward pairs are also timed beside torch's group_norm and
     native_group_norm_backward (no SiLU, NCHW) at the top-level shapes. The
     statistics kernels' partials must be bit-equal from launch to launch,
     and the attention dispatch at head dim 160 (padded to 256) within the
     flash limits, forward and backward, in bf16.
  3. The full-width UNet at 64x64 in f32, on the card (kernels) and on the
     CPU (plain versions), with the same random weights: a forward, a short
     DDIM + CFG trajectory, and one training step's loss and gradients with
     the same draws; then one transformer block at SD's widest level (1280
     channels, 8 heads of 160, 16x16 tokens, cross to the text): its forward
     and every gradient.
  4. The serving path: DDIM-50 with classifier-free guidance (scale 3.0) at
     256x256, batch 1, bf16, full width. The launch counters, zeroed just
     before, must show every attention, GEGLU and GroupNorm call went through
     the forward kernels.
  5. The training path: DiffusionTrainer.train_step on the full-width UNet
     from the port's own init, batch 16 at 128x128, bf16 over f32 params,
     AdamW 1e-4 and EMA 0.999, on 4 seeded synthetic batches: 3 warm-up and
     20 timed steps. Every loss must be finite, the mean of the last 5 below
     the first, and the launch counters, zeroed just before, must show every
     forward and backward kernel launched once per call per step.
  3b. The full-width DiT-B/2 on the 32x32x4 latent in f32, card against CPU
     with the same random weights: a forward, a short DDIM + CFG trajectory
     and one training step's loss and gradients.
  6. DiT serving: DDIM-50 with CFG 3.0, the linear schedule, batch 4 (8 rows
     a call) of 32x32x4 latents, bf16, with a 77x768 text context; the
     launch counters must show 51 calls of 24 LayerNorm + modulate, 24 gated
     residual and 12 attention launches.
  7. DiT training: DiffusionTrainer.train_step, batch 32, bf16 over f32
     params, AdamW 1e-4, EMA 0.999, 3 warm-up and 20 timed steps, with the
     same checks as phase 5.
The lines before the last are the kernels' JSON record and the card's
name and power limit; the last is {"ok": true, "device": {...}}. With
--record, the full record (every case, the model checks, both paths and
their breakdowns) is also written to PATH as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the serving target of BASELINE.md: the text-conditional UNet of
# bench.py:stage_ddim (full width, random weights from a seed)
ATTN = {"heads": 8, "dim_head": 64, "backend": "auto"}
UNET = dict(output_channels=3, emb_features=512, feature_depths=(64, 128, 256, 512),
            attention_configs=(None, None, ATTN, ATTN), num_res_blocks=2, norm_groups=8,
            in_channels=3, context_dim=768)
TEXT_LEN, TEXT_DIM = 77, 768
STEPS, RESOLUTION, GUIDANCE = 50, 256, 3.0
# launches of one forward of UNET: attention at levels 2 and 3 (self + cross
# on the way down and up, cross-only in the middle), 19 res blocks x 2 norms;
# one backward launches each backward kernel as often
PER_FORWARD = {"flash_fwd": 9, "geglu": 5, "gn_stats": 38, "gn_norm": 38}
PER_BACKWARD = {"flash_bwd_dq": 9, "flash_bwd_dkv": 9, "gn_bwd_stats": 38, "gn_bwd_dx": 38,
                "geglu_bwd": 5}
# the training path: bench.py:build_trainer's configuration
TRAIN_BATCH, TRAIN_RES, TRAIN_LR, WARMUP, TIMED = 16, 128, 1e-4, 3, 20
SERVE_BATCH = 2   # one CFG call of the serving path

# DiT-B/2 (Peebles & Xie 2023, facebookresearch/DiT models.py DiT_B_2): depth
# 12, hidden 768, 12 heads of 64, patch 2, MLP ratio 4, on the 32x32x4 latent
# of a 256x256 image through the SD VAE (random weights, no VAE), with the
# 77x768 text context
DIT = dict(output_channels=4, patch_size=2, emb_features=768, num_layers=12, num_heads=12,
           mlp_ratio=4, in_channels=4, context_dim=TEXT_DIM)
DIT_RES, DIT_CH, DIT_TOKENS, DIT_WIDTH, DIT_HEADS = 32, 4, 256, 768, 12
DIT_SERVE_BATCH, DIT_TRAIN_BATCH = 4, 32   # 8 rows a CFG call
# launches of one DiT forward: two LayerNorm + modulate, two gated residuals
# and one attention a block; one backward launches each backward kernel as often
DIT_PER_FORWARD = {"ln_mod": 24, "gate_res": 24, "flash_fwd": 12}
DIT_PER_BACKWARD = {"ln_mod_bwd": 24, "gate_res_bwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}

# phase 2's cases: the forward kernels at the serving path's shapes (batch
# SERVE_BATCH), the backward kernels at the training path's (batch
# TRAIN_BATCH); bf16 plus one f32 case each (TF32 off)
BF16, F32 = torch.bfloat16, torch.float32
# flash (batch, lq, lk, heads, head dim, dtype): the UNet's self at 64^2 and
# 32^2 tokens and cross to the text (8 heads of 64), the DiT's self over 256
# tokens (12 heads); then head dim 256, where the dispatch pads the 8 heads
# of 160 of an SD-style level of 1280 channels: self and cross at 32^2
# tokens, self at 16^2 in f32
FLASH_FWD_CASES = [(SERVE_BATCH, 4096, 4096, 8, 64, BF16),
                   (SERVE_BATCH, 4096, TEXT_LEN, 8, 64, BF16),
                   (SERVE_BATCH, 1024, 1024, 8, 64, BF16),
                   (SERVE_BATCH, 1024, TEXT_LEN, 8, 64, BF16),
                   (SERVE_BATCH, 1024, 1024, 8, 64, F32),
                   (2 * DIT_SERVE_BATCH, DIT_TOKENS, DIT_TOKENS, DIT_HEADS, 64, BF16),
                   (SERVE_BATCH, 1024, 1024, 8, 256, BF16),
                   (SERVE_BATCH, 1024, TEXT_LEN, 8, 256, BF16),
                   (SERVE_BATCH, 256, 256, 8, 256, F32)]
# flash backward: the UNet's self at 32^2 and 16^2 tokens and cross to the
# text, the DiT's self at its training batch; then head dim 256 at 16^2
# tokens, self and cross, and f32
FLASH_BWD_CASES = [(TRAIN_BATCH, 1024, 1024, 8, 64, BF16),
                   (TRAIN_BATCH, 1024, TEXT_LEN, 8, 64, BF16),
                   (TRAIN_BATCH, 256, 256, 8, 64, BF16), (TRAIN_BATCH, 256, TEXT_LEN, 8, 64, BF16),
                   (2, 1024, 1024, 8, 64, F32),
                   (DIT_TRAIN_BATCH, DIT_TOKENS, DIT_TOKENS, DIT_HEADS, 64, BF16),
                   (TRAIN_BATCH, 256, 256, 8, 256, BF16),
                   (TRAIN_BATCH, 256, TEXT_LEN, 8, 256, BF16), (2, 256, 256, 8, 256, F32)]
# SD's widest UNet level: 1280 channels in 8 heads of 160 at 16x16 tokens
WIDE_LEVEL = dict(dim=1280, heads=8, dim_head=160, side=16)
# GroupNorm (batch, HW, C, dtype), 8 groups: cases at SERVE_BATCH (four
# shapes the UNet's forward at 256^2 normalizes, f32, then the two other
# shapes it normalizes most often) time the forward kernels, cases at
# TRAIN_BATCH (the same at 128^2) the forward and backward kernels. With them
# phase 2 measures 31 (serving) and 28 (training) of the 38 GroupNorm calls
# of a forward (scripts/queue_score.py's census)
GN_CASES = [(SERVE_BATCH, 256 * 256, 64, BF16), (SERVE_BATCH, 64 * 64, 256, BF16),
            (SERVE_BATCH, 32 * 32, 1024, BF16), (SERVE_BATCH, 128 * 128, 128, BF16),
            (SERVE_BATCH, 64 * 64, 256, F32), (SERVE_BATCH, 32 * 32, 512, BF16),
            (SERVE_BATCH, 256 * 256, 128, BF16),
            (TRAIN_BATCH, 128 * 128, 64, BF16), (TRAIN_BATCH, 32 * 32, 256, BF16),
            (TRAIN_BATCH, 16 * 16, 1024, BF16), (TRAIN_BATCH, 32 * 32, 256, F32),
            (TRAIN_BATCH, 16 * 16, 512, BF16), (TRAIN_BATCH, 64 * 64, 128, BF16)]
# GEGLU (batch, rows, 2F, dtype): forward cases at SERVE_BATCH
GEGLU_CASES = [(SERVE_BATCH, 4096, 2048, BF16), (SERVE_BATCH, 1024, 4096, BF16),
               (SERVE_BATCH, 1024, 4096, F32), (TRAIN_BATCH, 1024, 2048, BF16),
               (TRAIN_BATCH, 256, 4096, BF16), (TRAIN_BATCH, 256, 4096, F32)]
# the AdaLN kernels (batch, L, C, dtype, views): DiT-B at its serving batch
# (one CFG call) and its training batch, one f32 case, and a ragged L = 77
_SB, _TB = 2 * DIT_SERVE_BATCH, DIT_TRAIN_BATCH
LN_MOD_CASES = [(_SB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_SB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                (_SB, DIT_TOKENS, DIT_WIDTH, F32, 1), (3, TEXT_LEN, DIT_WIDTH, BF16, 2)]
LN_MOD_BWD_CASES = [(_TB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                    (_SB, DIT_TOKENS, DIT_WIDTH, F32, 2), (3, TEXT_LEN, DIT_WIDTH, BF16, 2)]
GATE_RES_CASES = [(_SB, DIT_TOKENS, DIT_WIDTH, BF16), (_TB, DIT_TOKENS, DIT_WIDTH, BF16),
                  (_SB, DIT_TOKENS, DIT_WIDTH, F32), (3, TEXT_LEN, DIT_WIDTH, BF16)]
GATE_RES_BWD_CASES = [(_TB, DIT_TOKENS, DIT_WIDTH, BF16), (_SB, DIT_TOKENS, DIT_WIDTH, F32),
                      (3, TEXT_LEN, DIT_WIDTH, BF16)]

REPLACES = {
    "flash_fwd": "flaxdiff_tpu/ops/flash_attention.py:78",
    "flash_bwd_dq": "flaxdiff_tpu/ops/flash_attention.py:132",
    "flash_bwd_dkv": "flaxdiff_tpu/ops/flash_attention.py:171",
    "gn_stats": "flaxdiff_tpu/ops/fused_norm.py:58",
    "gn_norm": "flaxdiff_tpu/ops/fused_norm.py:85",
    "gn_bwd_stats": "flaxdiff_tpu/ops/fused_norm.py:112",
    "gn_bwd_dx": "flaxdiff_tpu/ops/fused_norm.py:149",
    "geglu": "flaxdiff_tpu/ops/fused_adaln.py:500",
    "geglu_bwd": "flaxdiff_tpu/ops/fused_adaln.py:506",
    "ln_mod": "flaxdiff_tpu/ops/fused_adaln.py:138",
    "ln_mod_bwd": "flaxdiff_tpu/ops/fused_adaln.py:161",
    "gate_res": "flaxdiff_tpu/ops/fused_adaln.py:380",
    "gate_res_bwd": "flaxdiff_tpu/ops/fused_adaln.py:386",
}
# the __global__ functions each wrapper launches, as the profiler names them
KERNEL_SYMBOLS = {name: (name + "_kernel",) for name in REPLACES}
KERNEL_SYMBOLS.update(flash_fwd=("flash_fwd_wgmma_kernel", "flash_fwd_fma_kernel"),
                      flash_bwd_dq=("flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_fma_kernel"),
                      flash_bwd_dkv=("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_split_wgmma_kernel",
                                     "flash_bwd_dkv_fma_kernel"),
                      ln_mod=("ln_mod_fwd_kernel",), gate_res=("gate_res_fwd_kernel",))
# the 16-bit paths that must run on wgmma (HGMMA in the built library)
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_split_wgmma_kernel")
SOURCES = {
    "flash_fwd": "flaxdiff_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "flaxdiff_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "flaxdiff_tpu_torch/csrc/flash_bwd.cu",
    "gn_stats": "flaxdiff_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_norm": "flaxdiff_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_bwd_stats": "flaxdiff_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_bwd_dx": "flaxdiff_tpu_torch/csrc/groupnorm_silu.cu",
    "geglu": "flaxdiff_tpu_torch/csrc/geglu.cu",
    "geglu_bwd": "flaxdiff_tpu_torch/csrc/geglu.cu",
    "ln_mod": "flaxdiff_tpu_torch/csrc/adaln.cu",
    "ln_mod_bwd": "flaxdiff_tpu_torch/csrc/adaln.cu",
    "gate_res": "flaxdiff_tpu_torch/csrc/adaln.cu",
    "gate_res_bwd": "flaxdiff_tpu_torch/csrc/adaln.cu",
}

# (dense bf16 flop/s, f32 flop/s outside the tensor cores, bytes/s), NVIDIA's
# data sheets; first match on the device name wins
PEAKS = [
    ("H100 PCIe", (756e12, 51e12, 2.0e12)),
    ("H100 NVL", (835e12, 60e12, 3.9e12)),
    ("H200", (989e12, 67e12, 4.8e12)),
    ("H100", (989e12, 67e12, 3.35e12)),
]


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def peaks(name: str):
    for key, value in PEAKS:
        if key in name:
            return value
    log(f"warning: no peak table for {name!r}; using H100 SXM peaks")
    return PEAKS[-1][1]


def time_ms(fn, iters: int) -> float:
    """Mean time of one call from CUDA events around `iters` back-to-back
    calls after warm-up: device time plus any wait for the host's launches.
    Inputs stay in L2 where they fit, as in the model."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@functools.cache
def side_stream() -> torch.cuda.Stream:
    """One stream for every warm-up: each new stream that runs a GEMM gets
    its own cuBLAS workspace, held until the process ends."""
    return torch.cuda.Stream()


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Mean device time of one call: `calls` back-to-back calls captured in
    one CUDA graph, replayed `replays` times between CUDA events. The graph
    runs the calls' kernels with no wait for the host, which dominates a
    loop of ~10 us kernels launched from Python, and it needs no profiler.
    Inputs stay in L2 where they fit, as in the model."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the capture: library handles
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream: an autograd backward runs each op on
    # its forward's stream, so a timed backward's forward is made there too
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    check(ms > 0, "the graph's replays took device time")
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(flops: float, nbytes: float, flop_rate: float, byte_rate: float):
    t_ops, t_bytes = flops / flop_rate, nbytes / byte_rate
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# A bf16 value |x| has an ulp of at most 2^-7 |x|: two results of the same f32
# math that round differently are one such ulp apart. atol covers what the
# kernel and its plain version compute differently before that rounding.
BF16_RTOL = 2.0 ** -7


def compare(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float,
            rms_rel: float) -> dict:
    """The readings that hold out against ref: per element,
    |out - ref| <= atol + rtol |ref| (the least atol that passes at this
    rtol), and as a whole, ||out - ref|| <= rms_rel ||ref||."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return dict(max_abs_err=float(d.max()), atol=atol, rtol=rtol,
                least_atol=float((d - rtol * r).max().clamp_min(0.0)),
                rms_rel=float(d.norm() / r.norm().clamp_min(1e-30)), rms_rel_limit=rms_rel)


def passes(reading: dict) -> bool:
    return (reading["least_atol"] <= reading["atol"]
            and reading["rms_rel"] <= reading["rms_rel_limit"]
            and reading.get("lse_err", 0.0) <= reading.get("lse_atol", 0.0))


def instantiation(mangled: str) -> str:
    """'flash_fwd_wgmma_kernel bf16 D64 NC2' from a wgmma kernel's mangled
    name (template arguments: dtype, head dim and, where the kernel has it,
    consumer warpgroups)."""
    m = re.search("(" + "|".join(WGMMA_KERNELS) + r")I(6__half|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?",
                  mangled)
    if not m:
        return mangled
    dtype = "f16" if m.group(2) == "6__half" else "bf16"
    nc = f" NC{m.group(4)}" if m.group(4) else ""
    return f"{m.group(1)} {dtype} D{m.group(3)}{nc}"


def log_registers(build_log: str) -> dict:
    """Each kernel's most registers over its instantiations, every
    instantiation that spills, and the registers and spills of every wgmma
    instantiation, from nvcc's -Xptxas -v output. Fails if any kernel
    instantiation spills or ptxas serialised any wgmma (C7520: a warpgroup
    arrive on a branch costs every product its overlap)."""
    symbols = [frag for frags in KERNEL_SYMBOLS.values() for frag in frags]
    regs, fn, inst, wgmma, spilled = {}, None, None, {}, []
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = next((k for k in symbols if k in m.group(1)), m.group(1))
            inst = instantiation(m.group(1)) if fn in WGMMA_KERNELS else None
            mangled = m.group(1)
        elif fn and "spill stores" in line:
            if inst:
                wgmma[inst] = line.strip()
            if not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
                log(f"  {fn}: {line.strip()}")
            if " 0 bytes spill stores, 0 bytes spill loads" not in line:
                spilled.append(mangled)
        elif fn and "Used" in line and "registers" in line:
            n = int(re.search(r"Used (\d+) registers", line).group(1))
            regs[fn] = max(regs.get(fn, 0), n)
            if inst:
                wgmma[inst] = f"{n} registers, {wgmma.get(inst, '')}"
    log("  registers: " + ", ".join(f"{k} {v}" for k, v in sorted(regs.items())))
    for inst, text in sorted(wgmma.items()):
        log(f"  {inst}: {text}")
    serialised = [line.strip() for line in build_log.splitlines() if "C7520" in line]
    for line in serialised:
        log(f"  {line}")
    check(len(wgmma) > 0, "the wgmma instantiations are in the build log")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in t for t in wgmma.values()),
          "no wgmma instantiation spills")
    check(not spilled, f"no kernel instantiation spills: {spilled}")
    check(not serialised, "ptxas serialised no wgmma (C7520)")
    return wgmma


def log_hgmma(lib) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync, what WMMA lowers to) instructions in
    each wgmma kernel of the built library, from cuobjdump where the toolkit
    has it: evidence that the 16-bit paths run on wgmma. Every instantiation
    must hold HGMMA and no HMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("  cuobjdump not found: HGMMA count not measured")
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = instantiation(m.group(1)) if any(k in m.group(1) for k in WGMMA_KERNELS) else None
            if fn:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[fn][op] += 1
    for inst, c in sorted(counts.items()):
        log(f"  {inst}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA")
    check(len(counts) > 0, "the wgmma kernels are in the library")
    check(all(c["HGMMA"] > 0 and c["HMMA"] == 0 for c in counts.values()),
          "every wgmma instantiation issues HGMMA and no HMMA")
    return counts


# --- phase 2: kernels against their plain versions --------------------------

def kernel_cases(dev, peak):
    from flaxdiff_tpu_torch.ops import (flash_bwd_dkv, flash_bwd_dq, flash_fwd, geglu_bwd,
                                        geglu_fwd, groupnorm_bwd_dx, groupnorm_bwd_stats)
    from flaxdiff_tpu_torch.ops.flash_attention import (flash_bwd_dkv_plain, flash_bwd_dq_plain,
                                                        flash_delta, flash_fwd_plain)
    from flaxdiff_tpu_torch.ops.fused_adaln import geglu_bwd_plain, geglu_plain
    from flaxdiff_tpu_torch.ops.fused_norm import (groupnorm_bwd_dx_plain, groupnorm_bwd_finalize,
                                                   groupnorm_bwd_stats_plain, groupnorm_finalize,
                                                   groupnorm_normalize, groupnorm_normalize_plain,
                                                   groupnorm_stats, groupnorm_stats_plain,
                                                   rows_per_block)
    bf16_rate, f32_rate, byte_rate = peak
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype: torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    cases, yardsticks = [], []

    def record(name, shape, dtype, readings, call, plain, flops, nbytes, library=None):
        """Print the readings (one per output) and check them, then time
        kernel, plain version and library call by device time (CUDA graph
        replays)."""
        rate = f32_rate if dtype == torch.float32 else bf16_rate
        b_ms, b_by = bound_ms(flops, nbytes, rate, byte_rate)
        dname = str(dtype).replace("torch.", "")
        for out_name, reading in readings.items():
            lse = (f", lse err {reading['lse_err']:.3g} (atol {reading['lse_atol']:g})"
                   if "lse_err" in reading else "")
            log(f"  {name} {out_name} {shape} {dname}: max err {reading['max_abs_err']:.3g}, "
                f"least atol {reading['least_atol']:.3g} (atol {reading['atol']:.3g} at rtol "
                f"{reading['rtol']:g}), rms rel {reading['rms_rel']:.3g} "
                f"(limit {reading['rms_rel_limit']}){lse}")
            check(passes(reading), f"{name} {out_name} {shape} {dname}: {reading}")
        ms = graph_ms(call, 20)
        plain_ms = graph_ms(plain, 3, replays=3)
        library_ms = graph_ms(library, 20) if library is not None else None
        case = dict(name=name, shape=list(shape), dtype=dname, outputs=readings,
                    max_abs_err=max(r["max_abs_err"] for r in readings.values()), ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        rate_note = ""
        if name.startswith("flash"):
            case.update(tflops=flops / ms / 1e9, bound_share=b_ms / ms)
            rate_note = f", {case['tflops']:.1f} TFLOP/s, {case['bound_share']:.1%} of bound"
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
            + (f", library {library_ms:.4f} ms" if library_ms is not None else "") + rate_note)
        cases.append(case)

    for b, lq, lk, heads, d, dtype in FLASH_FWD_CASES:
        q, k, v = (randn(b, n, heads, d, dtype=dtype) for n in (lq, lk, lk))
        out, lse = flash_fwd(q, k, v)
        ref, ref_lse = flash_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        # bf16: p is rounded to bf16 against a running (kernel) or final
        # (plain) row max, which atol covers (up to 1.7e-3 on an H100 for
        # 77 keys); |out| has a std of only sqrt(e / Lk) (0.026 at 4096
        # keys), so the RMS limit and lse (f32, the same unrounded sums on
        # both sides) catch a dropped key tile
        if dtype == torch.bfloat16:
            reading = compare(out, ref, atol=4e-3, rtol=BF16_RTOL, rms_rel=1e-2)
        else:
            reading = compare(out, ref, atol=1e-5, rtol=1e-5, rms_rel=1e-5)
        reading.update(lse_err=max_err(lse, ref_lse), lse_atol=1e-4)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        esz = q.element_size()
        bh = b * heads
        record("flash_fwd", (b, lq, lk, heads, d), dtype, {"out": reading},
               lambda: flash_fwd(q, k, v), lambda: flash_fwd_plain(q, k, v),
               4.0 * bh * lq * lk * d, bh * (esz * d * (2 * lq + 2 * lk) + 4 * lq),
               library=sdpa)
        del q, k, v, out, ref

    for b, lq, lk, heads, d, dtype in FLASH_BWD_CASES:
        q, k, v = (randn(b, n, heads, d, dtype=dtype) for n in (lq, lk, lk))
        do = randn(b, lq, heads, d, dtype=dtype)
        out, lse = flash_fwd(q, k, v)
        delta = flash_delta(out, do)
        dq, (dk, dv) = flash_bwd_dq(q, k, v, do, lse, delta), flash_bwd_dkv(q, k, v, do, lse, delta)
        dq_ref = flash_bwd_dq_plain(q, k, v, do, lse, delta)
        dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        # bf16: p and ds are rounded to bf16 on both sides from f32 values
        # summed in another order; a rounding that flips moves a gradient by
        # about one ulp of ds times |k|, which atol (relative to the largest
        # gradient) covers, up to 1.4e-3 of it on an H100; rtol is one
        # output ulp. The RMS error read <= 1.2e-4; a dropped 64-row tile
        # of 1024 moves it by ~6%. f32: summation order only
        limits = ((4e-3, BF16_RTOL, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5, 1e-5))
        read = lambda o, r: compare(o, r, atol=limits[0] * float(r.float().abs().max()),
                                    rtol=limits[1], rms_rel=limits[2])
        qg, kg, vg = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        with torch.cuda.stream(side_stream()):   # the graph's capture stream: see graph_ms
            side_stream().wait_stream(torch.cuda.current_stream())
            sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
        torch.cuda.current_stream().wait_stream(side_stream())
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do.transpose(1, 2),
                                               retain_graph=True)
        esz, bh, qkvo = q.element_size(), b * heads, (2 * lq + 2 * lk) * d
        shape = (b, lq, lk, heads, d)
        record("flash_bwd_dq", shape, dtype, {"dq": read(dq, dq_ref)},
               lambda: flash_bwd_dq(q, k, v, do, lse, delta),
               lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta),
               3 * 2.0 * bh * lq * lk * d, bh * (esz * (qkvo + lq * d) + 8 * lq),
               library=sdpa_bwd)
        # the function's 4 products; at d = 256 the 16-bit kernel computes
        # the two score products in both of its warpgroups (6 in all)
        record("flash_bwd_dkv", shape, dtype, {"dk": read(dk, dk_ref), "dv": read(dv, dv_ref)},
               lambda: flash_bwd_dkv(q, k, v, do, lse, delta),
               lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta),
               4 * 2.0 * bh * lq * lk * d, bh * (esz * (qkvo + 2 * lk * d) + 8 * lq),
               library=sdpa_bwd)
        pair = cases[-2]["ms"] + cases[-1]["ms"]
        log(f"    dq + dkv {pair:.4f} ms against SDPA's backward {cases[-1]['library_ms']:.4f} ms "
            f"({pair / cases[-1]['library_ms']:.2f}x)")
        del q, k, v, do, out, dq, dk, dv, dq_ref, dk_ref, dv_ref, qg, kg, vg, sdpa_out
    dispatch_check(randn)

    for b, hw, c, dtype in GN_CASES:
        x = randn(b, hw, c, dtype=dtype) * 2.0 + 0.5
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = randn(c, dtype=torch.float32) * 0.1
        rows = rows_per_block(b, hw, c)
        nblk = -(-hw // rows)
        esz, n = x.element_size(), b * hw * c
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
        ref_part = groupnorm_stats_plain(x, 8, rows)
        mean, rstd = groupnorm_finalize(ref_part, hw, c, 1e-6)
        part = groupnorm_stats(x, 8)
        again = groupnorm_stats(x, 8)
        torch.cuda.synchronize()
        check(torch.equal(part, again), f"gn_stats {(b, hw, c)}: partials bit-equal run to run")
        # f32 sums of up to 8192 elements a group and block, in another order
        # and shifted by the block's first row; the sums are ~2000-4000 and
        # the moments ~16000-33000, so one missed row moves them by 0.1% or
        # more
        reading = compare(part, ref_part, atol=1e-3, rtol=1e-5, rms_rel=1e-5)
        grouped = x.view(b, hw, 8, c // 8)
        record("gn_stats", (b, hw, c), dtype, {"partials": reading},
               lambda: groupnorm_stats(x, 8), lambda: groupnorm_stats_plain(x, 8, rows),
               3.0 * n, esz * n + 4 * b * nblk * 2 * 8,
               library=lambda: torch.var_mean(grouped, dim=(1, 3), correction=0))
        out = groupnorm_normalize(x, mean, rstd, scale, bias, True)
        ref = groupnorm_normalize_plain(x, mean, rstd, scale, bias, True)
        torch.cuda.synchronize()
        # the same f32 math up to FMA contraction and expf against torch's
        # sigmoid: a few f32 ulps, then at most one bf16 rounding apart
        reading = compare(out, ref, atol=1e-5, rtol=rtol, rms_rel=1e-3)
        record("gn_norm", (b, hw, c), dtype, {"out": reading},
               lambda: groupnorm_normalize(x, mean, rstd, scale, bias, True),
               lambda: groupnorm_normalize_plain(x, mean, rstd, scale, bias, True),
               8.0 * n, 2 * esz * n + 8 * c + 8 * b * 8)
        del out, ref
        if (hw, c, dtype) == (256 * 256, 64, BF16):
            yardsticks.append(gn_yardstick(b, hw, c, dtype, cases[-2]["ms"] + cases[-1]["ms"],
                                           randn, backward=False))
        if b != TRAIN_BATCH:
            continue
        g = randn(b, hw, c, dtype=dtype)
        gs, cs = groupnorm_bwd_stats(x, g, mean, rstd, scale, bias, True)
        gs_ref, cs_ref = groupnorm_bwd_stats_plain(x, g, mean, rstd, scale, bias, True, rows)
        torch.cuda.synchronize()
        # f32 sums of up to 1024 rows a channel and block, in another order:
        # up to 1.4e-7 of the largest sum per element and 1.8e-7 RMS on an
        # H100
        read = lambda o, r: compare(o, r, atol=1e-6 * float(r.abs().max()), rtol=1e-5,
                                    rms_rel=1e-6)
        record("gn_bwd_stats", (b, hw, c), dtype,
               {"group_sums": read(gs, gs_ref), "channel_sums": read(cs, cs_ref)},
               lambda: groupnorm_bwd_stats(x, g, mean, rstd, scale, bias, True),
               lambda: groupnorm_bwd_stats_plain(x, g, mean, rstd, scale, bias, True, rows),
               16.0 * n, 2 * esz * n + 8 * b * 8 + 8 * c + 4 * b * nblk * 2 * (8 + c))
        s, _, _ = groupnorm_bwd_finalize(gs_ref, cs_ref, hw)
        dx = groupnorm_bwd_dx(x, g, mean, rstd, scale, bias, s, True)
        dx_ref = groupnorm_bwd_dx_plain(x, g, mean, rstd, scale, bias, s, True)
        torch.cuda.synchronize()
        # the same f32 math, at most one output rounding apart
        record("gn_bwd_dx", (b, hw, c), dtype,
               {"dx": compare(dx, dx_ref, atol=1e-5, rtol=rtol, rms_rel=1e-3)},
               lambda: groupnorm_bwd_dx(x, g, mean, rstd, scale, bias, s, True),
               lambda: groupnorm_bwd_dx_plain(x, g, mean, rstd, scale, bias, s, True),
               20.0 * n, 3 * esz * n + 16 * b * 8 + 8 * c)
        del x, g, dx, dx_ref
        if (hw, c, dtype) == (128 * 128, 64, BF16):
            yardsticks.append(gn_yardstick(b, hw, c, dtype, cases[-2]["ms"] + cases[-1]["ms"],
                                           randn, backward=True))

    for b, rows, f2, dtype in GEGLU_CASES:
        proj = randn(b, rows, f2, dtype=dtype) * 2.0
        esz, n = proj.element_size(), b * rows * f2 // 2
        # the same f32 math, tanhf against torch's tanh: a few f32 ulps, then
        # at most one bf16 rounding apart
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
        if b == SERVE_BATCH:
            out, ref = geglu_fwd(proj), geglu_plain(proj)
            torch.cuda.synchronize()
            record("geglu", (b, rows, f2), dtype,
                   {"out": compare(out, ref, atol=1e-5, rtol=rtol, rms_rel=1e-3)},
                   lambda: geglu_fwd(proj), lambda: geglu_plain(proj), 12.0 * n, esz * 3 * n)
            del proj, out, ref
            continue
        dout = randn(b, rows, f2 // 2, dtype=dtype)
        out, ref = geglu_bwd(proj, dout), geglu_bwd_plain(proj, dout)
        torch.cuda.synchronize()
        # as the forward; dgate's tanh' term reads up to 5.4e-6 from torch's
        # in f32, so atol is relative to the largest element (~50 here)
        record("geglu_bwd", (b, rows, f2), dtype,
               {"dproj": compare(out, ref, atol=1e-6 * float(ref.float().abs().max()), rtol=rtol,
                                 rms_rel=1e-3)},
               lambda: geglu_bwd(proj, dout), lambda: geglu_bwd_plain(proj, dout),
               24.0 * n, esz * 5 * n)
        del proj, dout, out, ref
    adaln_cases(randn, gen, record)
    return cases, yardsticks


def dispatch_check(randn) -> None:
    """The attention dispatch at WIDE_LEVEL's head dim (160, padded to 256),
    cross-attention to the text in bf16: forward and dq, dk, dv against the
    plain versions at the true head dim, under the flash bf16 limits, with
    one launch of each flash kernel."""
    from flaxdiff_tpu_torch.ops import dot_product_attention, launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.ops.flash_attention import (flash_bwd_dkv_plain, flash_bwd_dq_plain,
                                                        flash_delta, flash_fwd_plain)
    b, heads, d, lq = SERVE_BATCH, WIDE_LEVEL["heads"], WIDE_LEVEL["dim_head"], WIDE_LEVEL["side"] ** 2
    q = randn(b, lq, heads, d, dtype=BF16).requires_grad_()
    k, v = (randn(b, TEXT_LEN, heads, d, dtype=BF16).requires_grad_() for _ in range(2))
    do = randn(b, lq, heads, d, dtype=BF16)
    reset_launch_counts()
    out = dot_product_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    counts = launch_counts()
    check([counts[name] for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [1, 1, 1],
          f"the dispatch at head dim {d} launched each flash kernel once: {counts}")
    with torch.no_grad():
        # the plain backward from the delta of the kernel's own output, as
        # phase 2 feeds both sides one lse and delta (the zero columns add
        # nothing to it): the limits hold the backward kernels, not the two
        # forwards' different bf16 roundings of out
        ref, lse = flash_fwd_plain(q, k, v)
        delta = flash_delta(out, do)
        refs = (flash_bwd_dq_plain(q, k, v, do, lse, delta),
                *flash_bwd_dkv_plain(q, k, v, do, lse, delta))
    readings = {"out": compare(out, ref, atol=4e-3, rtol=BF16_RTOL, rms_rel=1e-2)}
    for name, grad, grad_ref in zip(("dq", "dk", "dv"), grads, refs):
        readings[name] = compare(grad, grad_ref, atol=4e-3 * float(grad_ref.float().abs().max()),
                                 rtol=BF16_RTOL, rms_rel=1e-3)
    for name, r in readings.items():
        log(f"  dispatch head dim {d} ({b}, {lq}, {TEXT_LEN}, {heads}) bf16 {name}: least atol "
            f"{r['least_atol']:.3g} (atol {r['atol']:.3g}), rms rel {r['rms_rel']:.3g}")
        check(passes(r), f"dispatch at head dim {d}, {name}: {r}")


def gn_yardstick(b, hw, c, dtype, pair_ms, randn, backward: bool):
    """torch's own GroupNorm, forward (F.group_norm) or backward
    (aten.native_group_norm_backward: dx, dscale and dbias), with no SiLU,
    on a contiguous NCHW tensor of the same size, timed beside the
    gn_stats + gn_norm or gn_bwd_stats + gn_bwd_dx pair. A yardstick only:
    it computes less than the pair, and the port never calls it."""
    side = math.isqrt(hw)
    x = randn(b, c, side, side, dtype=dtype)
    w = randn(c, dtype=dtype).abs() + 0.5
    if backward:
        g = randn(b, c, side, side, dtype=dtype)
        _, mean, rstd = torch.ops.aten.native_group_norm(x, w, torch.zeros_like(w), b, c, hw, 8,
                                                         1e-6)
        call, what = (lambda: torch.ops.aten.native_group_norm_backward(
            g, x, mean, rstd, w, b, c, hw, 8, [True, True, True])), "aten.native_group_norm_backward"
        pair = "gn_bwd_stats + gn_bwd_dx"
    else:
        call, what = (lambda: torch.nn.functional.group_norm(x, 8, w, w, 1e-6)), "F.group_norm"
        pair = "gn_stats + gn_norm"
    ms = graph_ms(call, 20)
    log(f"  yardstick: {what} (no SiLU, NCHW) [{b},{c},{side},{side}] {str(dtype)[6:]} "
        f"{ms:.4f} ms; {pair} at [{b},{hw},{c}] {pair_ms:.4f} ms")
    return dict(call=what, note="no SiLU, NCHW", shape=[b, c, side, side], dtype=str(dtype)[6:],
                ms=ms, pair=pair, pair_ms=pair_ms)


def adaln_cases(randn, gen, record):
    """B10-B13 against their plain versions at the DiT's shapes. Modulators
    and gates are [B, 1, C] chunks of a packed [B, 1, 6C] projection, as the
    DiT passes them."""
    from flaxdiff_tpu_torch.ops import (gate_residual_bwd, gate_residual_fwd, ln_modulate_bwd,
                                        ln_modulate_fwd)
    from flaxdiff_tpu_torch.ops.fused_adaln import (ADALN_ROWS, gate_residual_bwd_plain,
                                                    gate_residual_plain, ln_modulate_bwd_plain,
                                                    ln_modulate_plain)

    def tokens(b, l, c, dtype):
        return randn(b, l, c, dtype=dtype) * 2.0 + 0.5

    def chunks(b, c, dtype, n):
        return (randn(b, 1, 6 * c, dtype=dtype) * 0.5).chunk(6, dim=-1)[:n]

    # views: the same f32 math after row sums taken in another order, a few
    # f32 ulps of the largest view (read <= 3.4e-8 of it, RMS <= 7.3e-8 on an
    # H100); mean and rstd likewise (0; 7.3e-8)
    f32_read = lambda o, r: compare(o, r, atol=1e-6 * float(r.abs().max()), rtol=1e-5,
                                    rms_rel=1e-6)
    for b, l, c, dtype, nv in LN_MOD_CASES:
        x = tokens(b, l, c, dtype)
        mods = chunks(b, c, dtype, 2 * nv)
        pairs = tuple(zip(mods[0::2], mods[1::2]))
        views, mean, rstd = ln_modulate_fwd(x, pairs, 1e-5)
        ref_views, ref_mean, ref_rstd = ln_modulate_plain(x, pairs, 1e-5)
        torch.cuda.synchronize()
        readings = {f"view{i}": f32_read(o, r) for i, (o, r) in enumerate(zip(views, ref_views))}
        readings.update(mean=f32_read(mean, ref_mean), rstd=f32_read(rstd, ref_rstd))
        esz, n = x.element_size(), b * l * c
        record("ln_mod", (b, l, c, nv), dtype, readings,
               lambda: ln_modulate_fwd(x, pairs, 1e-5), lambda: ln_modulate_plain(x, pairs, 1e-5),
               (5.0 + 3.0 * nv) * n, esz * n + esz * 2 * nv * b * c + 4 * nv * n + 8 * b * l)
        del x, views, ref_views

    for b, l, c, dtype, nv in LN_MOD_BWD_CASES:
        x = tokens(b, l, c, dtype)
        scales = chunks(b, c, dtype, nv)
        gs = [randn(b, l, c, dtype=torch.float32) for _ in range(nv)]
        _, mean, rstd = ln_modulate_plain(x, [(s, s) for s in scales], 1e-5)
        dx, part = ln_modulate_bwd(x, scales, mean, rstd, gs)
        dx_ref, part_ref = ln_modulate_bwd_plain(x, scales, mean, rstd, gs)
        torch.cuda.synchronize()
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
        # dx: the same f32 math, at most one output rounding apart (bf16 RMS
        # read <= 1.2e-5, f32 <= 4.3e-8); the partials: f32 sums of ADALN_ROWS
        # rows in another order (<= 6e-8 of the largest, RMS <= 9.6e-8)
        readings = {"dx": compare(dx, dx_ref, atol=1e-6 * float(dx_ref.float().abs().max()),
                                  rtol=rtol, rms_rel=1e-4 if dtype == torch.bfloat16 else 1e-6),
                    "partials": compare(part, part_ref, atol=1e-6 * float(part_ref.abs().max()),
                                        rtol=1e-5, rms_rel=1e-6)}
        esz, n, nblk = x.element_size(), b * l * c, -(-l // ADALN_ROWS)
        record("ln_mod_bwd", (b, l, c, nv), dtype, readings,
               lambda: ln_modulate_bwd(x, scales, mean, rstd, gs),
               lambda: ln_modulate_bwd_plain(x, scales, mean, rstd, gs),
               (12.0 + 6.0 * nv) * n,
               2 * esz * n + 4 * nv * n + esz * nv * b * c + 8 * b * l + 4 * b * nblk * 2 * nv * c)
        del x, gs, dx, dx_ref

    # the product and the sum rounded apart on both sides, as torch rounds
    # them: bit-equal, and held to that
    for b, l, c, dtype in GATE_RES_CASES:
        x, h = tokens(b, l, c, dtype), randn(b, l, c, dtype=dtype)
        (gate,) = chunks(b, c, dtype, 1)
        out, ref = gate_residual_fwd(x, gate, h), gate_residual_plain(x, gate, h)
        torch.cuda.synchronize()
        esz, n = x.element_size(), b * l * c
        record("gate_res", (b, l, c), dtype, {"out": compare(out, ref, atol=0.0, rtol=0.0,
                                                             rms_rel=0.0)},
               lambda: gate_residual_fwd(x, gate, h), lambda: gate_residual_plain(x, gate, h),
               2.0 * n, 3 * esz * n + esz * b * c,
               library=lambda: torch.addcmul(x, gate, h))
        del x, h, out, ref

    for b, l, c, dtype in GATE_RES_BWD_CASES:
        h, dout = randn(b, l, c, dtype=dtype), randn(b, l, c, dtype=dtype)
        (gate,) = chunks(b, c, dtype, 1)
        dh, part = gate_residual_bwd(gate, h, dout)
        dh_ref, part_ref = gate_residual_bwd_plain(gate, h, dout)
        torch.cuda.synchronize()
        esz, n, nblk = h.element_size(), b * l * c, -(-l // ADALN_ROWS)
        record("gate_res_bwd", (b, l, c), dtype,
               {"dh": compare(dh, dh_ref, atol=0.0, rtol=0.0, rms_rel=0.0),
                "partials": compare(part, part_ref, atol=1e-6 * float(part_ref.abs().max()),
                                    rtol=1e-5, rms_rel=1e-6)},
               lambda: gate_residual_bwd(gate, h, dout),
               lambda: gate_residual_bwd_plain(gate, h, dout),
               3.0 * n, 3 * esz * n + esz * b * c + 4 * b * nblk * c)
        del h, dout, dh, dh_ref


# --- phases 3 and 4: the model -----------------------------------------------

def random_state(model: torch.nn.Module, seed: int) -> dict:
    """Every weight drawn from a seeded numpy normal: matrices and kernels
    scaled by 1/sqrt(fan_in), norm scales around 1, biases small, Fourier
    frequencies N(0, 16^2). Zero-initialised layers would otherwise make the
    UNet output exactly 0 and every comparison empty."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("freqs"):
            a = 16.0 * rng.standard_normal(shape)
        elif name.endswith("weight") and len(shape) >= 2:
            a = rng.standard_normal(shape) / math.sqrt(int(np.prod(shape[1:])))
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[name] = torch.from_numpy(a.astype(np.float32))
    return state


def model_checks(dev, state):
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    rng = np.random.default_rng(1)
    models = {}
    for where in (dev, "cpu"):
        m = Unet(**UNET, device=where)
        m.load_state_dict(state)
        models[str(where)] = m.eval()
    gpu, cpu = models[str(dev)], models["cpu"]
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    t = np.array([37.5, 911.0], np.float32)
    ctx = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    with torch.inference_mode():
        ref = cpu(*map(torch.from_numpy, (x, t, ctx)))
        out = gpu(*(torch.from_numpy(a).to(dev) for a in (x, t, ctx)))
    scale = max(1.0, float(ref.abs().max()))
    err = max_err(out.cpu(), ref)
    # f32 on both sides with TF32 off; cuDNN and oneDNN sum the convolutions
    # in other orders through ~60 layers
    log(f"  forward 64x64 f32: max|ref| {scale:.3g}, max err {err:.3g}")
    check(bool(torch.isfinite(out).all()), "forward output finite")
    check(err <= 1e-3 * scale, f"full-width forward: error {err} above {1e-3 * scale}")

    x0 = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    cond = rng.standard_normal((1, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    samples = {}
    for where, m in (("cuda", gpu), ("cpu", cpu)):
        sampler = DiffusionSampler(lambda a, b, c, m=m: m(a, b, c), CosineNoiseSchedule(1000),
                                   EpsilonPredictionTransform(), DDIMSampler(),
                                   guidance_scale=GUIDANCE, device=dev if where == "cuda" else "cpu")
        # from t = 333: from t = 999 random weights drive every sample into
        # the [-1, 1] clip and the comparison would see only +-1
        samples[where] = sampler.generate_samples(
            diffusion_steps=3, init_samples=torch.from_numpy(x0),
            conditioning=torch.from_numpy(cond),
            unconditional=torch.zeros(1, TEXT_LEN, TEXT_DIM), start_step=333.0).cpu()
    err_traj = max_err(samples["cuda"], samples["cpu"])
    saturated = float((samples["cpu"].abs() >= 1.0).float().mean())
    log(f"  DDIM-3 + CFG 32x32 f32 from t=333: max err {err_traj:.3g}, "
        f"{saturated:.0%} of values clipped")
    check(saturated < 0.6, "trajectory samples mostly inside the clip range")
    # early DDIM steps divide by a small signal rate, which amplifies the
    # forward's difference
    check(err_traj <= 1e-2, f"trajectory: error {err_traj} above 1e-2")
    step = train_step_check(dev, gpu, cpu, rng)
    del models, gpu, cpu
    return {"forward_64_f32_err": err, "forward_64_f32_scale": scale,
            "ddim3_cfg_32_f32_err": err_traj, "ddim3_clipped_share": saturated, **step}


def wide_block_check(dev) -> dict:
    """One UNet transformer block at SD's widest level (WIDE_LEVEL: 1280
    channels in 8 heads of 160, which the dispatch pads to 256; 16x16 tokens
    with self-attention, cross to the 77x768 text, GEGLU) in f32, card
    (kernels) against CPU (plain versions), the same random weights and
    inputs: the forward within 1e-3 x max(1, max|ref|), every gradient (the
    weights', the tokens' and the text's) within 1e-3 of its max|g|, the key
    biases' (zero by the math) below 1e-6 of the largest."""
    from flaxdiff_tpu_torch.models.attention import TransformerBlock

    w = WIDE_LEVEL
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, w["side"], w["side"], w["dim"])).astype(np.float32)
    ctx = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    state, results = None, []
    for where in (dev, "cpu"):
        block = TransformerBlock(w["dim"], TEXT_DIM, heads=w["heads"], dim_head=w["dim_head"],
                                 device=where)
        state = random_state(block, 6) if state is None else state
        block.load_state_dict(state)
        xs, cs = (torch.from_numpy(a).to(where).requires_grad_() for a in (x, ctx))
        out = block(xs, cs)
        named = list(block.named_parameters())
        grads = torch.autograd.grad(out, [t for _, t in named] + [xs, cs],
                                    torch.from_numpy(g).to(where))
        names = [name for name, _ in named] + ["tokens", "context"]
        results.append((out.detach().cpu(), [t.cpu() for t in grads], names))
    (out, grads, names), (ref, ref_grads, _) = results
    scale = max(1.0, float(ref.abs().max()))
    err = max_err(out, ref)
    gmax = max(float(r.abs().max()) for r in ref_grads)
    worst, worst_name = 0.0, None
    for name, grad, r in zip(names, grads, ref_grads):
        if name.endswith("to_k.bias"):
            check(max(float(grad.abs().max()), float(r.abs().max())) <= 1e-6 * gmax,
                  f"{name}: a gradient zero by the math is not ~0")
            continue
        rel = max_err(grad, r) / max(float(r.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  transformer block {w['dim']} ch, {w['heads']} heads of {w['dim_head']}, "
        f"{w['side']}x{w['side']} tokens, f32: forward max err {err:.3g} (max|ref| {scale:.3g}); "
        f"worst gradient error {worst:.3g} of its max|g| ({worst_name})")
    check(bool(torch.isfinite(out).all()), "wide block output finite")
    check(err <= 1e-3 * scale, f"wide block forward: error {err} above {1e-3 * scale}")
    check(worst <= 1e-3, f"wide block gradient {worst_name}: error {worst} of its max|g|")
    return {"forward_err": err, "forward_scale": scale, "worst_grad_rel_err": worst,
            "worst_grad": worst_name}


def train_step_check(dev, gpu, cpu, rng):
    """One training step's loss and gradients at 64x64, f32, batch 2, the
    same weights and draws on the card (kernels) and the CPU (plain
    versions)."""
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    arrays = {"sample": rng.standard_normal((2, 64, 64, 3)),
              "cond": rng.standard_normal((2, TEXT_LEN, TEXT_DIM)),
              "noise": rng.standard_normal((2, 64, 64, 3)),
              "t": np.array([91, 655], np.int32), "mask": np.array([False, True])}
    # zero by the math (softmax ignores the shift a key bias adds to every
    # logit of a row): both sides hold f32 rounding
    zero = lambda name: name.endswith("to_k.bias")
    # f32 with TF32 off; convolutions summed in other orders through ~60
    # layers and back
    res = step_check(dev, gpu, cpu, arrays, CosineNoiseSchedule, zero, "train step 64x64 f32")
    return {f"train_step_64_f32_{k}": v for k, v in res.items()}


def step_check(dev, gpu, cpu, arrays, schedule, zero_by_math, label):
    """Loss and every gradient of one training step, f32, the same weights
    and draws on the card and the CPU: loss within 1e-5 relative, each
    gradient within 1e-3 of its max|g|, the ones `zero_by_math` names below
    1e-6 of the model's largest."""
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder

    results = []
    for where, m in ((dev, gpu), ("cpu", cpu)):
        a = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(where)
             for k, v in arrays.items()}
        build = make_loss_builder(schedule(1000, device=where),
                                  EpsilonPredictionTransform(), TrainStepConfig(normalize=False),
                                  null_cond=torch.zeros(1, TEXT_LEN, TEXT_DIM, device=where))
        loss = build({"sample": a["sample"], "cond": a["cond"]}, a["noise"], a["t"],
                     a["mask"])(m)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        results.append((float(loss.detach()), [g.cpu() for g in grads]))
    (loss, grads), (ref_loss, ref_grads) = results
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    gmax = max(float(r.abs().max()) for r in ref_grads)
    worst, worst_name = 0.0, None
    for (name, _), g, r in zip(cpu.named_parameters(), grads, ref_grads):
        if zero_by_math(name):
            check(max(float(g.abs().max()), float(r.abs().max())) <= 1e-6 * gmax,
                  f"{name}: a gradient zero by the math is not ~0")
            continue
        rel = max_err(g, r) / max(float(r.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log(f"  {label}: loss {ref_loss:.6f}, relative error {loss_err:.3g}; worst "
        f"gradient error {worst:.3g} of its max|g| ({worst_name})")
    check(loss_err <= 1e-5, f"{label} loss: relative error {loss_err} above 1e-5")
    check(worst <= 1e-3, f"{label} gradient {worst_name}: error {worst} of its max|g| above 1e-3")
    return {"loss": ref_loss, "loss_rel_err": loss_err, "worst_grad_rel_err": worst,
            "worst_grad": worst_name}


def main_path(dev, state):
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    model = Unet(**UNET, dtype="bfloat16", device=dev)
    model.load_state_dict(state)
    model.eval()
    sampler = DiffusionSampler(lambda x, t, c: model(x, t, c), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(),
                               guidance_scale=GUIDANCE, device=dev)
    rng = np.random.default_rng(2)
    cond = torch.from_numpy(rng.standard_normal((1, TEXT_LEN, TEXT_DIM)).astype(np.float32))
    uncond = torch.zeros(1, TEXT_LEN, TEXT_DIM)
    run = lambda steps, seed: sampler.generate_samples(
        num_samples=1, resolution=RESOLUTION, diffusion_steps=steps,
        generator=make_generator(seed, dev), conditioning=cond, unconditional=uncond)
    run(2, 0)                      # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: PER_FORWARD.get(k, 0) * (STEPS + 1) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == expected, "every attention, GEGLU and GroupNorm call ran its kernel")
    check(tuple(out.shape) == (1, RESOLUTION, RESOLUTION, 3), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "samples finite")
    check(float(out.abs().max()) <= 1.0, "samples clipped to [-1, 1]")
    res = {"wall_s": wall, "forwards": STEPS + 1, "ms_per_forward": wall * 1e3 / (STEPS + 1),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "sample_std": float(out.float().std()), "launches": counts}
    x = torch.randn(2, RESOLUTION, RESOLUTION, 3, device=dev)
    ctx = torch.cat([cond, uncond]).to(dev)
    res["breakdown"] = forward_breakdown(lambda: model(x, torch.full((2,), 500.0, device=dev), ctx),
                                         "batch 2 at 256x256")
    return res


def training_path(dev):
    """DiffusionTrainer.train_step on the full-width UNet from the port's own
    init: 3 warm-up and 20 timed steps over 4 seeded synthetic batches."""
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    torch.manual_seed(0)           # the modules' own initializers
    res = run_training(dev, Unet(**UNET, dtype="bfloat16", device=dev), CosineNoiseSchedule(1000),
                       (TRAIN_BATCH, TRAIN_RES, TRAIN_RES, 3), {**PER_FORWARD, **PER_BACKWARD})
    res["images_per_s"] = res.pop("samples_per_s")
    return res


def run_training(dev, model, schedule, shape, per_step):
    """DiffusionTrainer.train_step from the model's own init, AdamW 1e-4 at
    optax's defaults, EMA 0.999, CFG dropout 0.12 to a zeros context: 3
    warm-up and 20 timed steps over 4 seeded synthetic batches of `shape`
    with a text context. Every launch counter, zeroed just before, must read
    `per_step` launches a step."""
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer, TrainerConfig

    trainer = DiffusionTrainer(
        model, AdamW(TRAIN_LR), schedule, EpsilonPredictionTransform(),
        TrainerConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True,
                      gate_nonfinite=True, seed=0),
        null_cond=torch.zeros(1, TEXT_LEN, TEXT_DIM), device=dev)
    rng = np.random.default_rng(3)
    batch = shape[0]
    batches = [{"sample": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
                "cond": torch.from_numpy(rng.standard_normal(
                    (batch, TEXT_LEN, TEXT_DIM)).astype(np.float32)).to(dev)}
               for _ in range(4)]
    torch.cuda.synchronize()
    reset_launch_counts()
    losses = [trainer.train_step(batches[i % 4]) for i in range(WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += [trainer.train_step(batches[i % 4]) for i in range(WARMUP, WARMUP + TIMED)]
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = WARMUP + TIMED
    expected = {k: steps * per_step.get(k, 0) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == expected, "every forward and backward kernel ran once per call per step")
    losses = [float(x) for x in losses]
    log("  losses " + " ".join(f"{x:.5f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), "every loss finite")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"the loss fell: mean of the last 5 {last5} against {losses[0]}")
    ms = start.elapsed_time(end) / TIMED
    res = {"ms_per_step": ms, "samples_per_s": batch * 1e3 / ms,
           "wall_ms_per_step": wall * 1e3 / TIMED,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": trainer.state.params.numel(), "losses": losses,
           "mean_last5_loss": last5, "launches": counts}
    log(f"  {ms:.3f} ms per step (CUDA events over {TIMED} steps), "
        f"{res['samples_per_s']:.1f} samples/s, peak {res['peak_mem_gib']:.2f} GiB, "
        f"{res['params']} params")
    res["breakdown"] = family_profile(lambda: trainer.train_step(batches[0]), training=True)
    by_family = res["breakdown"]["ms_by_family"]
    if by_family:
        # one stream: the kernels' summed device time is the busy time
        res["busy_ms"] = sum(by_family.values())
        res["idle_share"] = 1.0 - res["busy_ms"] / ms
        log(f"  device busy {res['busy_ms']:.3f} ms of {ms:.3f} ms per step "
            f"({res['idle_share']:.0%} idle)")
    del trainer
    return res


# --- phases 3b, 6 and 7: the DiT ---------------------------------------------

def dit_model_checks(dev, state):
    """The full-width DiT-B/2 in f32 on the card (kernels) and the CPU (plain
    versions), the same random weights: a forward, DDIM-3 + CFG from
    t = 333, one train step's loss and gradients."""
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule

    rng = np.random.default_rng(4)
    models = {}
    for where in (dev, "cpu"):
        m = SimpleDiT(**DIT, device=where)
        m.load_state_dict(state)
        models[str(where)] = m.eval()
    gpu, cpu = models[str(dev)], models["cpu"]
    shape = (2, DIT_RES, DIT_RES, DIT_CH)
    x = rng.standard_normal(shape).astype(np.float32)
    t = np.array([37.5, 911.0], np.float32)
    ctx = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    with torch.inference_mode():
        ref = cpu(*map(torch.from_numpy, (x, t, ctx)))
        out = gpu(*(torch.from_numpy(a).to(dev) for a in (x, t, ctx)))
    scale = max(1.0, float(ref.abs().max()))
    err = max_err(out.cpu(), ref)
    # f32 on both sides with TF32 off: GEMMs and row sums in other orders
    # through 12 blocks
    log(f"  forward {DIT_RES}x{DIT_RES}x{DIT_CH} f32: max|ref| {scale:.3g}, max err {err:.3g}")
    check(bool(torch.isfinite(out).all()), "DiT forward output finite")
    check(err <= 1e-3 * scale, f"DiT full-width forward: error {err} above {1e-3 * scale}")

    # half scale: at t = 333 the linear schedule's signal rate is ~0.57, and
    # x0 = (x - sigma eps) / signal of a unit-scale x would mostly clip
    x0 = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    cond = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    samples = {}
    for where, m in (("cuda", gpu), ("cpu", cpu)):
        sampler = DiffusionSampler(lambda a, b, c, m=m: m(a, b, c), LinearNoiseSchedule(1000),
                                   EpsilonPredictionTransform(), DDIMSampler(),
                                   guidance_scale=GUIDANCE, device=dev if where == "cuda" else "cpu")
        samples[where] = sampler.generate_samples(
            diffusion_steps=3, init_samples=torch.from_numpy(x0),
            conditioning=torch.from_numpy(cond),
            unconditional=torch.zeros(2, TEXT_LEN, TEXT_DIM), start_step=333.0,
            channels=DIT_CH).cpu()
    err_traj = max_err(samples["cuda"], samples["cpu"])
    saturated = float((samples["cpu"].abs() >= 1.0).float().mean())
    log(f"  DDIM-3 + CFG {DIT_RES}x{DIT_RES}x{DIT_CH} f32 from t=333: max err {err_traj:.3g}, "
        f"{saturated:.0%} of values clipped")
    check(saturated < 0.6, "DiT trajectory samples mostly inside the clip range")
    check(err_traj <= 1e-2, f"DiT trajectory: error {err_traj} above 1e-2")
    arrays = {"sample": rng.standard_normal(shape), "cond": rng.standard_normal((2, TEXT_LEN, TEXT_DIM)),
              "noise": rng.standard_normal(shape), "t": np.array([91, 655], np.int32),
              "mask": np.array([False, True])}
    # the raster order rotates keys by position, so no gradient is zero by the math
    step = step_check(dev, gpu, cpu, arrays, LinearNoiseSchedule, lambda name: False,
                      f"train step {DIT_RES}x{DIT_RES}x{DIT_CH} f32")
    del models, gpu, cpu
    return {"forward_f32_err": err, "forward_f32_scale": scale, "ddim3_cfg_f32_err": err_traj,
            "ddim3_clipped_share": saturated, **{f"train_step_f32_{k}": v for k, v in step.items()}}


def dit_serving_path(dev, state):
    """DDIM-50 + CFG 3.0 with DiT-B/2 in bf16: batch 4 of 32x32x4 latents
    with a 77x768 text context and zeros as the null context."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule

    model = SimpleDiT(**DIT, dtype="bfloat16", device=dev)
    model.load_state_dict(state)
    model.eval()
    sampler = DiffusionSampler(lambda x, t, c: model(x, t, c), LinearNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(),
                               guidance_scale=GUIDANCE, device=dev)
    rng = np.random.default_rng(5)
    b = DIT_SERVE_BATCH
    cond = torch.from_numpy(rng.standard_normal((b, TEXT_LEN, TEXT_DIM)).astype(np.float32))
    uncond = torch.zeros(b, TEXT_LEN, TEXT_DIM)
    run = lambda steps, seed: sampler.generate_samples(
        num_samples=b, resolution=DIT_RES, diffusion_steps=steps,
        generator=make_generator(seed, dev), conditioning=cond, unconditional=uncond,
        channels=DIT_CH)
    run(2, 0)                      # warm-up: GEMM algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: DIT_PER_FORWARD.get(k, 0) * (STEPS + 1) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == expected, "every LayerNorm + modulate, gated residual and attention call "
          "ran its kernel")
    check(tuple(out.shape) == (b, DIT_RES, DIT_RES, DIT_CH), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "samples finite")
    check(float(out.abs().max()) <= 1.0, "samples clipped to [-1, 1]")
    res = {"wall_s": wall, "forwards": STEPS + 1, "ms_per_forward": wall * 1e3 / (STEPS + 1),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "sample_std": float(out.float().std()), "launches": counts}
    x = torch.randn(2 * b, DIT_RES, DIT_RES, DIT_CH, device=dev)
    ctx = torch.cat([cond, uncond]).to(dev)
    res["breakdown"] = forward_breakdown(
        lambda: model(x, torch.full((2 * b,), 500.0, device=dev), ctx),
        f"batch {2 * b} of {DIT_RES}x{DIT_RES}x{DIT_CH}")
    del model
    return res


def dit_training_path(dev):
    """DiffusionTrainer.train_step on DiT-B/2 from the port's own init
    (zero AdaLN and output projections: only the gates and the output
    projection move at first), batch 32 of 32x32x4 latents, bf16 over f32
    params, the linear schedule."""
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule

    torch.manual_seed(0)
    return run_training(dev, SimpleDiT(**DIT, dtype="bfloat16", device=dev),
                        LinearNoiseSchedule(1000), (DIT_TRAIN_BATCH, DIT_RES, DIT_RES, DIT_CH),
                        {**DIT_PER_FORWARD, **DIT_PER_BACKWARD})


# kernel-name fragments -> the layer they belong to, first match wins
FAMILIES = [(fam, frag) for fam, frags in KERNEL_SYMBOLS.items() for frag in frags] + [
    ("conv", "conv"), ("conv", "fprop"), ("conv", "implicit"),
    ("gemm", "gemm"), ("gemm", "cutlass"), ("gemm", "nvjet"), ("gemm", "sm90_xmma")]


def forward_breakdown(call, what: str):
    """One CFG model call: its time as launched from Python (CUDA events)
    beside its device busy time (the same call replayed as a CUDA graph);
    the difference is the share of the call the card sits idle. Then, where
    torch.profiler sees the card, the device time by kernel family."""
    with torch.inference_mode():
        fwd_ms = time_ms(call, 10)
        busy = graph_ms(call, 1, replays=10)
    out = {"forward_ms": fwd_ms, "busy_ms": busy, "idle_share": 1.0 - busy / fwd_ms}
    log(f"  one CFG forward ({what}): {fwd_ms:.3f} ms launched from Python, device busy "
        f"{busy:.3f} ms as a CUDA graph ({out['idle_share']:.0%} idle)")
    out.update(family_profile(call))
    return out


def family_profile(call, training: bool = False) -> dict:
    """Device time of one call by kernel family, from torch.profiler. The
    profiler's CUPTI tracing sometimes delivers no device events at all; this
    breakdown only explains the busy time measured above, so it is then
    reported as not measured instead of failing the run."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        mode = contextlib.nullcontext() if training else torch.inference_mode()
        with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
        log(f"  torch.profiler saw no device kernels (attempt {attempt + 1} of 3)")
    else:
        log("  device time by kernel family: not measured")
        return {"kernels": None, "ms_by_family": None, "top_other_ms": None}
    by_family, other = {}, {}
    for ev in events:
        ms = ev.time_range.elapsed_us() / 1e3
        fam = next((f for f, frag in FAMILIES if frag in ev.name.lower()), "other")
        by_family[fam] = by_family.get(fam, 0.0) + ms
        if fam == "other":
            other[ev.name[:80]] = other.get(ev.name[:80], 0.0) + ms
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
    out = {"kernels": len(events), "ms_by_family": top(by_family, len(by_family)),
           "top_other_ms": top(other, 8)}
    log(f"  profiler: {len(events)} kernels, {sum(by_family.values()):.3f} ms; "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["ms_by_family"].items()))
    for name, ms in out["top_other_ms"].items():
        log(f"    other: {ms:.3f} ms {name}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", help="write the full JSON record here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flaxdiff_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"phase 1: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log(f"  built {lib.name} in {build_s:.1f} s")
    ptxas = log_registers((lib.parent / "build.log").read_text())
    hgmma = log_hgmma(lib)

    log("phase 2: kernels against their plain versions")
    cases, yardsticks = kernel_cases(dev, peaks(name))
    torch.cuda.empty_cache()

    from flaxdiff_tpu_torch.models import Unet
    state = random_state(Unet(**UNET, device="cpu"), 0)
    log("phase 3: full-width UNet, card against CPU")
    model_res = model_checks(dev, state)
    model_res["wide_block"] = wide_block_check(dev)
    torch.cuda.empty_cache()

    log(f"phase 4: DDIM-{STEPS} + CFG {GUIDANCE} at {RESOLUTION}x{RESOLUTION}, bf16")
    traj = main_path(dev, state)
    log(f"trajectory: DDIM-{STEPS} CFG {GUIDANCE} {RESOLUTION}x{RESOLUTION} batch 1 bf16 "
        f"wall {traj['wall_s']:.3f} s ({traj['ms_per_forward']:.2f} ms per forward), "
        f"peak {traj['peak_mem_gib']:.2f} GiB on {smi}")
    del state
    torch.cuda.empty_cache()

    log(f"phase 5: DiffusionTrainer.train_step, batch {TRAIN_BATCH} at {TRAIN_RES}x{TRAIN_RES}, "
        f"bf16, {WARMUP} + {TIMED} steps")
    train = training_path(dev)
    log(f"training: batch {TRAIN_BATCH} {TRAIN_RES}x{TRAIN_RES} bf16 {train['ms_per_step']:.3f} "
        f"ms per step, {train['images_per_s']:.1f} images/s, peak {train['peak_mem_gib']:.2f} "
        f"GiB on {smi}")
    torch.cuda.empty_cache()

    from flaxdiff_tpu_torch.models import SimpleDiT
    state = random_state(SimpleDiT(**DIT, device="cpu"), 1)
    # the output projection at a tenth of the drawn scale: the CFG-guided eps
    # of random weights then stays near unit scale, and the trajectory's x0
    # mostly inside the clip
    for key in ("final_proj.weight", "final_proj.bias"):
        state[key] *= 0.1
    log("phase 3b: full-width DiT-B/2, card against CPU")
    dit_res = dit_model_checks(dev, state)
    torch.cuda.empty_cache()

    log(f"phase 6: DiT-B/2 DDIM-{STEPS} + CFG {GUIDANCE}, batch {DIT_SERVE_BATCH} of "
        f"{DIT_RES}x{DIT_RES}x{DIT_CH}, bf16")
    dit_traj = dit_serving_path(dev, state)
    bd = dit_traj["breakdown"]
    log(f"DiT trajectory: DDIM-{STEPS} CFG {GUIDANCE} batch {DIT_SERVE_BATCH} bf16 wall "
        f"{dit_traj['wall_s']:.3f} s ({dit_traj['ms_per_forward']:.2f} ms per call), one call "
        f"busy {bd['busy_ms']:.3f} ms as a graph ({bd['idle_share']:.0%} idle), peak "
        f"{dit_traj['peak_mem_gib']:.2f} GiB on {smi}")
    del state
    torch.cuda.empty_cache()

    log(f"phase 7: DiT-B/2 DiffusionTrainer.train_step, batch {DIT_TRAIN_BATCH} of "
        f"{DIT_RES}x{DIT_RES}x{DIT_CH}, bf16, {WARMUP} + {TIMED} steps")
    dit_train = dit_training_path(dev)
    log(f"DiT training: batch {DIT_TRAIN_BATCH} bf16 {dit_train['ms_per_step']:.3f} ms per step, "
        f"{dit_train['samples_per_s']:.1f} latents/s, peak {dit_train['peak_mem_gib']:.2f} GiB, "
        f"busy {dit_train.get('busy_ms', float('nan')):.3f} ms "
        f"({dit_train.get('idle_share', float('nan')):.0%} idle) on {smi}")

    paths = {"unet_serving": traj, "unet_training": train, "dit_serving": dit_traj,
             "dit_training": dit_train}
    kernels, summary = [], []
    for kname in REPLACES:
        mine = [c for c in cases if c["name"] == kname]
        head = mine[0]
        by_path = {path: res["launches"][kname] for path, res in paths.items()}
        kernel = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(by_path.values()),
            "max_abs_err": max(c["max_abs_err"] for c in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "launches_by_path": by_path, "shape": head["shape"], "dtype": head["dtype"]}
        check(kernel["launches"] > 0, f"{kname} launched on a main path")
        summary.append(kernel)
        kernels.append({**kernel, "cases": mine})
    record = {"device": name, "nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
              "hgmma": hgmma,
              "kernels": kernels, "yardsticks": yardsticks,
              "model": model_res, "trajectory": traj, "training": train, "dit_model": dit_res,
              "dit_trajectory": dit_traj, "dit_training": dit_train,
              "total_s": time.perf_counter() - t0}
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
