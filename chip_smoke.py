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
  2. Hold each of the sixteen kernels against its plain PyTorch version on
     the card: the forward kernels at the serving paths' shapes, the backward
     kernels at the training paths' (bf16, plus one f32 case each with TF32
     off, one f16 case each at a shape a bf16 case times, under the bf16
     limits scaled to f16's ulp, and a ragged case for the AdaLN kernels);
     the flash kernels also at
     head dim 256, the wide flash kernels (head dims above 256) at 320 and
     384, GroupNorm's forward kernels also at the training paths' shapes,
     LayerNorm + modulate at every width its row kernel is compiled for and
     one it is not. Time kernel, plain version and, where one PyTorch call computes
     the same function (torch's scaled_dot_product_attention forward and
     backward, torch.var_mean over the groups, torch.addcmul; a yardstick
     the port never calls), that call, by their device time (CUDA graph
     replays timed by CUDA events), beside the byte/flop bound; the flash
     cases also with their TFLOP/s and share of the bound. GroupNorm's
     forward and backward pairs are also timed beside torch's group_norm and
     native_group_norm_backward (no SiLU, NCHW) at the top-level shapes. The
     statistics kernels' partials must be bit-equal from launch to launch,
     the wide forward's lse bit-equal across its column chunks, and the
     attention dispatch at head dim 160 (padded to 256) within the flash
     limits, forward and backward, in bf16.
  3. The full-width UNet at 64x64 in f32, on the card (kernels) and on the
     CPU (plain versions), with the same random weights: a forward, short
     CFG trajectories at 32x32 (DDIM-3 and euler_ancestral-4 on the cosine
     schedule, the latter's noise drawn once on the CPU for both sides;
     Heun-4 on the KarrasVE ramp with EDM preconditioning and karras
     spacing), and one training step's loss and gradients with the same
     draws (cosine/eps, then EDM); then one transformer block of 1280 channels (16x16
     tokens, cross to the text) at SD's 8 heads of 160 and at UNet3D's 4
     heads of 320 (the wide kernels, the launch counters zeroed just
     before): its forward and every gradient.
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
  8. Every sampler on phase 4's model, weights and inputs, 50 steps each:
     ddpm, simple_ddpm, euler, simple_euler, euler_ancestral, heun and
     multistep_dpm (orders 2, 3) on the cosine schedule; euler, heun and rk4
     on the KarrasVE ramp (sigma_max 80) with EDM preconditioning and karras
     spacing; one DDIM request inpainting the left half, whose kept half
     must equal the reference exactly. Each request's launch counters,
     zeroed just before, must read PER_FORWARD x its model calls.
  9. EDM training: phase 5 with EDMNoiseSchedule and the Karras transform,
     the same checks.
 10. The training CLI end to end, in a temporary directory removed after:
     flaxdiff_tpu_torch.train.main trains phase 5's UNet with the hash text
     encoder on the synthetic dataset (batch 16 at 128x128, bf16 over f32
     params, adamw on a 10-step warmup, grad clip 1.0) for 40 steps,
     checkpointing at 20 and 40; every window loss must be finite and every
     forward and backward kernel launched once per call per step. A second
     run resumes from the step-20 checkpoint and trains to 40: its params,
     EMA and moments must equal the first run's bit for bit. A fit with a
     NaN batch must roll back and keep the state finite. Then
     DiffusionInferencePipeline.from_checkpoint samples DDIM-50 with CFG 3.0
     for the prompts "bright" and "dark" at 128x128, its launch counters
     reading PER_FORWARD x 51. Prints fit's ms per step and images/s beside
     phase 5's, the checkpoint's save time and bytes, peak memory and the
     request's wall time.
 11. Every 2D model family of the registry at full width, random weights,
     built through build_model: the UNet's ref_arch (pure attention, dim_head
     = C / heads), UViT, SimpleUDiT, SimpleMMDiT, HierarchicalMMDiT and the
     hybrid SSM DiT with 2D fusion (FAMILIES11): (a) each f32 forward, batch
     1, card against CPU within 1e-3 x max(1, max|ref|); (b) one DDIM-50 +
     CFG 3.0 request each in bf16, launches exactly the family's census x 51,
     wall, ms per call and one call's busy and idle shares as a CUDA graph;
     (c) SimpleMMDiT's and the hybrid's f32 train step card against CPU
     (loss to 1e-5 relative, each gradient to 1e-3 of its max|g|), and 3 + 20
     bf16 DiffusionTrainer.train_steps of SimpleMMDiT at batch 32 (phase 7's
     checks); (d) remat=True bit-equal to remat=False on the card, output and
     every gradient of one bf16 step, for phase 5's UNet and DiT-B/2; (e)
     the S5 layer's and its scan's device time at the hybrid's shapes.
 12. The training CLI with train.py's training options, in a temporary
     directory removed after: phase 10's run in float16 (flax's dynamic
     loss scale, through the f16 kernels) with MultiSteps(4) over lamb,
     the monitored step every 10 micro-steps, a 16-slot loss ring, the
     gate counter, a validation grid (euler_ancestral-50 + CFG 3.0, 8
     samples) between its two chunks of 20 micro-steps and a torch.profiler
     window, 40 micro-steps with saves every 10. The launch counters must
     read the step's kernels once per call per micro-step plus the grid's
     forward kernels; prints the scale and fin_steps after every micro-step,
     the skipped ones, ms per micro-step beside phase 10's step, busy time
     and idle share, peak memory, the grid's wall time and the trace's size.
     A resume from micro-step 30 (inside an accumulation) must equal the
     uninterrupted run bit for bit, accumulator, counts and scale included;
     a NaN batch must halve the scale and leave params, moments,
     accumulator and counts unchanged. Then the same chain in f32 on phase
     3's UNet at 32x32, card against CPU with the same draws: the scale's
     trajectory equal, the params within an update's quantum; and phase 5's
     UNet forward in float16 against f32 on the card (RMS within 1e-2 of the
     output's, every element within 5e-2 of its largest).
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
# TRAIN_BATCH); bf16 plus one f32 case each (TF32 off), and one f16 case
# each at a shape the bf16 cases time (the f16 training path of phase 12)
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
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
                   (SERVE_BATCH, 256, 256, 8, 256, F32),
                   (SERVE_BATCH, 1024, 1024, 8, 64, F16),
                   (SERVE_BATCH, 1024, TEXT_LEN, 8, 64, F16)]
# flash backward: the UNet's self at 32^2 and 16^2 tokens and cross to the
# text, the DiT's self at its training batch; then head dim 256 at 16^2
# tokens, self and cross, and f32
FLASH_BWD_CASES = [(TRAIN_BATCH, 1024, 1024, 8, 64, BF16),
                   (TRAIN_BATCH, 1024, TEXT_LEN, 8, 64, BF16),
                   (TRAIN_BATCH, 256, 256, 8, 64, BF16), (TRAIN_BATCH, 256, TEXT_LEN, 8, 64, BF16),
                   (2, 1024, 1024, 8, 64, F32),
                   (DIT_TRAIN_BATCH, DIT_TOKENS, DIT_TOKENS, DIT_HEADS, 64, BF16),
                   (TRAIN_BATCH, 256, 256, 8, 256, BF16),
                   (TRAIN_BATCH, 256, TEXT_LEN, 8, 256, BF16), (2, 256, 256, 8, 256, F32),
                   (TRAIN_BATCH, 1024, 1024, 8, 64, F16), (TRAIN_BATCH, 1024, TEXT_LEN, 8, 64, F16)]
# the wide kernels (head dims above 256): UNet3D_LEVEL's 4 heads of 320 at
# 32^2 tokens (serving) and 16^2 (training), self and cross; 384; f32
WIDE_FWD_CASES = [(SERVE_BATCH, 1024, 1024, 4, 320, BF16),
                  (SERVE_BATCH, 1024, TEXT_LEN, 4, 320, BF16),
                  (SERVE_BATCH, 1024, 1024, 4, 384, BF16), (SERVE_BATCH, 256, 256, 4, 320, F32),
                  (SERVE_BATCH, 1024, 1024, 4, 320, F16)]
WIDE_BWD_CASES = [(TRAIN_BATCH, 256, 256, 4, 320, BF16), (TRAIN_BATCH, 256, TEXT_LEN, 4, 320, BF16),
                  (TRAIN_BATCH, 256, 256, 4, 384, BF16), (2, 256, 256, 4, 320, F32),
                  (TRAIN_BATCH, 256, 256, 4, 320, F16)]
# SD's widest UNet level: 1280 channels in 8 heads of 160 at 16x16 tokens;
# the same width in UNet3D's 4 heads (dim_head = channels // 4,
# flaxdiff_tpu/models/unet3d.py:92) runs the wide flash kernels at 320
WIDE_LEVEL = dict(dim=1280, heads=8, dim_head=160, side=16)
UNET3D_LEVEL = dict(WIDE_LEVEL, heads=4, dim_head=320)
# launches of one forward and backward of that block: self and cross
# attention, each through the three wide kernels, and the GEGLU
UNET3D_BLOCK = {"flash_fwd_wide": 2, "flash_bwd_dq_wide": 2, "flash_bwd_dkv_wide": 2,
                "geglu": 1, "geglu_bwd": 1}
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
            (TRAIN_BATCH, 16 * 16, 512, BF16), (TRAIN_BATCH, 64 * 64, 128, BF16),
            (TRAIN_BATCH, 128 * 128, 64, F16)]
# GEGLU (batch, rows, 2F, dtype): forward cases at SERVE_BATCH
GEGLU_CASES = [(SERVE_BATCH, 4096, 2048, BF16), (SERVE_BATCH, 1024, 4096, BF16),
               (SERVE_BATCH, 1024, 4096, F32), (TRAIN_BATCH, 1024, 2048, BF16),
               (TRAIN_BATCH, 256, 4096, BF16), (TRAIN_BATCH, 256, 4096, F32),
               (SERVE_BATCH, 1024, 4096, F16), (TRAIN_BATCH, 1024, 2048, F16)]
# the AdaLN kernels (batch, L, C, dtype, views): DiT-B at its serving batch
# (one CFG call) and its training batch, one f32 case, and a ragged L = 77
_SB, _TB = 2 * DIT_SERVE_BATCH, DIT_TRAIN_BATCH
LN_MOD_CASES = [(_SB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_SB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                (_SB, DIT_TOKENS, DIT_WIDTH, F32, 1), (3, TEXT_LEN, DIT_WIDTH, BF16, 2)]
# and the other widths B10's row kernel is compiled for (DiT-S, -L, -XL),
# one it is not (1280, the generic kernel), at the serving batch
LN_MOD_CASES += [(_SB, DIT_TOKENS, c, BF16, 2) for c in (384, 1024, 1152, 1280)]
LN_MOD_CASES += [(_SB, DIT_TOKENS, DIT_WIDTH, F16, 2)]
LN_MOD_BWD_CASES = [(_TB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                    (_SB, DIT_TOKENS, DIT_WIDTH, F32, 2), (3, TEXT_LEN, DIT_WIDTH, BF16, 2),
                    (_TB, DIT_TOKENS, DIT_WIDTH, F16, 2)]
GATE_RES_CASES = [(_SB, DIT_TOKENS, DIT_WIDTH, BF16), (_TB, DIT_TOKENS, DIT_WIDTH, BF16),
                  (_SB, DIT_TOKENS, DIT_WIDTH, F32), (3, TEXT_LEN, DIT_WIDTH, BF16),
                  (_TB, DIT_TOKENS, DIT_WIDTH, F16)]
GATE_RES_BWD_CASES = [(_TB, DIT_TOKENS, DIT_WIDTH, BF16), (_SB, DIT_TOKENS, DIT_WIDTH, F32),
                      (3, TEXT_LEN, DIT_WIDTH, BF16), (_TB, DIT_TOKENS, DIT_WIDTH, F16)]

REPLACES = {
    "flash_fwd": "flaxdiff_tpu/ops/flash_attention.py:78",
    "flash_bwd_dq": "flaxdiff_tpu/ops/flash_attention.py:132",
    "flash_bwd_dkv": "flaxdiff_tpu/ops/flash_attention.py:171",
    "flash_fwd_wide": "flaxdiff_tpu/ops/flash_attention.py:78",
    "flash_bwd_dq_wide": "flaxdiff_tpu/ops/flash_attention.py:132",
    "flash_bwd_dkv_wide": "flaxdiff_tpu/ops/flash_attention.py:171",
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
                      flash_fwd_wide=("flash_fwd_wide_wgmma_kernel", "flash_fwd_wide_fma_kernel"),
                      flash_bwd_dq_wide=("flash_bwd_dq_wide_wgmma_kernel",
                                         "flash_bwd_dq_wide_fma_kernel"),
                      flash_bwd_dkv_wide=("flash_bwd_dkv_wide_wgmma_kernel",
                                          "flash_bwd_dkv_wide_fma_kernel"),
                      ln_mod=("ln_mod_fwd_kernel", "ln_mod_fwd_rows_kernel"),
                      gate_res=("gate_res_fwd_kernel",))
# the 16-bit paths that must run on wgmma (HGMMA in the built library)
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_split_wgmma_kernel",
                 "flash_fwd_wide_wgmma_kernel", "flash_bwd_dq_wide_wgmma_kernel",
                 "flash_bwd_dkv_wide_wgmma_kernel")
SOURCES = {
    "flash_fwd": "flaxdiff_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "flaxdiff_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv": "flaxdiff_tpu_torch/csrc/flash_bwd.cu",
    "flash_fwd_wide": "flaxdiff_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq_wide": "flaxdiff_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dkv_wide": "flaxdiff_tpu_torch/csrc/flash_bwd.cu",
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
# An f16 value's ulp is at most 2^-10 |x|: its limits are the bf16 ones
# scaled by HALF_SCALE (1/8) where they cover a 16-bit rounding
BF16_RTOL, F16_RTOL = 2.0 ** -7, 2.0 ** -10
HALF_RTOL = {BF16: BF16_RTOL, F16: F16_RTOL}
HALF_SCALE = {BF16: 1.0, F16: F16_RTOL / BF16_RTOL}


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
    name (template arguments: dtype and, where the kernel has them, head dim
    and consumer warpgroups; the wide kernels take the dtype only)."""
    m = re.search("(" + "|".join(WGMMA_KERNELS) + r")I(6__half|13__nv_bfloat16)(?:Li(\d+)E)?"
                  r"(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    dtype = "f16" if m.group(2) == "6__half" else "bf16"
    d = f" D{m.group(3)}" if m.group(3) else ""
    nc = f" NC{m.group(4)}" if m.group(4) else ""
    return f"{m.group(1)} {dtype}{d}{nc}"


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
    from flaxdiff_tpu_torch.ops import (flash_bwd_dkv, flash_bwd_dkv_wide, flash_bwd_dq,
                                        flash_bwd_dq_wide, flash_fwd, flash_fwd_wide, geglu_bwd,
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

    for b, lq, lk, heads, d, dtype in FLASH_FWD_CASES + WIDE_FWD_CASES:
        # head dims above 256 take the wide kernels (their own rows)
        fwd, name = (flash_fwd_wide, "flash_fwd_wide") if d > 256 else (flash_fwd, "flash_fwd")
        q, k, v = (randn(b, n, heads, d, dtype=dtype) for n in (lq, lk, lk))
        out, lse = fwd(q, k, v)
        ref, ref_lse = flash_fwd_plain(q, k, v)
        if d > 256:
            # every column chunk sums the same scores in the same order
            chunk_lse = fwd(q, k, v, chunk_lse=True)[1]
            torch.cuda.synchronize()
            check(all(torch.equal(c, lse) for c in chunk_lse),
                  f"{name} {(b, lq, lk, heads, d)}: lse bit-equal across "
                  f"{chunk_lse.shape[0]} column chunks")
            del chunk_lse
        torch.cuda.synchronize()
        # bf16: p is rounded to bf16 against a running (kernel) or final
        # (plain) row max, which atol covers (up to 1.7e-3 on an H100 for
        # 77 keys); |out| has a std of only sqrt(e / Lk) (0.026 at 4096
        # keys), so the RMS limit and lse (f32, the same unrounded sums on
        # both sides) catch a dropped key tile
        if dtype in HALF_RTOL:
            hs = HALF_SCALE[dtype]
            reading = compare(out, ref, atol=4e-3 * hs, rtol=HALF_RTOL[dtype], rms_rel=1e-2 * hs)
        else:
            reading = compare(out, ref, atol=1e-5, rtol=1e-5, rms_rel=1e-5)
        reading.update(lse_err=max_err(lse, ref_lse), lse_atol=1e-4)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        esz = q.element_size()
        bh = b * heads
        record(name, (b, lq, lk, heads, d), dtype, {"out": reading},
               lambda: fwd(q, k, v), lambda: flash_fwd_plain(q, k, v),
               4.0 * bh * lq * lk * d, bh * (esz * d * (2 * lq + 2 * lk) + 4 * lq),
               library=sdpa)
        del q, k, v, out, ref

    for b, lq, lk, heads, d, dtype in FLASH_BWD_CASES + WIDE_BWD_CASES:
        wide = "_wide" if d > 256 else ""
        fwd, bwd_dq, bwd_dkv = ((flash_fwd_wide, flash_bwd_dq_wide, flash_bwd_dkv_wide) if wide
                                else (flash_fwd, flash_bwd_dq, flash_bwd_dkv))
        q, k, v = (randn(b, n, heads, d, dtype=dtype) for n in (lq, lk, lk))
        do = randn(b, lq, heads, d, dtype=dtype)
        out, lse = fwd(q, k, v)
        delta = flash_delta(out, do)
        dq, (dk, dv) = bwd_dq(q, k, v, do, lse, delta), bwd_dkv(q, k, v, do, lse, delta)
        dq_ref = flash_bwd_dq_plain(q, k, v, do, lse, delta)
        dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        # bf16: p and ds are rounded to bf16 on both sides from f32 values
        # summed in another order; a rounding that flips moves a gradient by
        # about one ulp of ds times |k|, which atol (relative to the largest
        # gradient) covers, up to 1.4e-3 of it on an H100; rtol is one
        # output ulp. The RMS error read <= 1.2e-4; a dropped 64-row tile
        # of 1024 moves it by ~6%. f32: summation order only
        limits = ((4e-3 * HALF_SCALE[dtype], HALF_RTOL[dtype], 1e-3 * HALF_SCALE[dtype])
                  if dtype in HALF_RTOL else (1e-5, 1e-5, 1e-5))
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
        record("flash_bwd_dq" + wide, shape, dtype, {"dq": read(dq, dq_ref)},
               lambda: bwd_dq(q, k, v, do, lse, delta),
               lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta),
               3 * 2.0 * bh * lq * lk * d, bh * (esz * (qkvo + lq * d) + 8 * lq),
               library=sdpa_bwd)
        # the function's 4 products; at d = 256 the 16-bit kernel computes
        # the two score products in both of its warpgroups (6 in all), and
        # the wide kernels in every column chunk's block
        record("flash_bwd_dkv" + wide, shape, dtype,
               {"dk": read(dk, dk_ref), "dv": read(dv, dv_ref)},
               lambda: bwd_dkv(q, k, v, do, lse, delta),
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
        rtol = HALF_RTOL.get(dtype, 1e-5)
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
        rtol = HALF_RTOL.get(dtype, 1e-5)
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
        rtol = HALF_RTOL.get(dtype, 1e-5)
        # dx: the same f32 math, at most one output rounding apart (bf16 RMS
        # read <= 1.2e-5, f32 <= 4.3e-8); the partials: f32 sums of ADALN_ROWS
        # rows in another order (<= 6e-8 of the largest, RMS <= 9.6e-8)
        readings = {"dx": compare(dx, dx_ref, atol=1e-6 * float(dx_ref.float().abs().max()),
                                  rtol=rtol, rms_rel=1e-4 * HALF_SCALE[dtype]
                                  if dtype in HALF_RTOL else 1e-6),
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

# the S5 layer's leaves, drawn like its HiPPO init: decay rates
# exp(log_A_real) around n + 1/2, frequencies around pi n, steps dt in
# [1e-3, 1e-1] (long memory along the 256 tokens), B and C by 1/sqrt(fan_in)
S5_LEAVES = {
    "log_A_real": lambda rng, s: np.log(np.arange(s[0]) + 0.5) + 0.1 * rng.standard_normal(s),
    "A_imag": lambda rng, s: np.pi * np.arange(s[0]) + 0.1 * rng.standard_normal(s),
    "log_dt": lambda rng, s: rng.uniform(math.log(1e-3), math.log(1e-1), s),
    "D": lambda rng, s: rng.standard_normal(s),
    **{k: (lambda rng, s: rng.standard_normal(s) / math.sqrt(s[0]))
       for k in ("B_re", "B_im", "C_re", "C_im")},
}


def random_state(model: torch.nn.Module, seed: int) -> dict:
    """Every weight drawn from a seeded numpy normal: matrices and kernels
    scaled by 1/sqrt(fan_in), norm scales around 1, biases small, Fourier
    frequencies N(0, 16^2), the S5 leaves as S5_LEAVES. Zero-initialised
    layers would otherwise make the UNet output exactly 0 and every
    comparison empty."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in S5_LEAVES:
            a = S5_LEAVES[leaf](rng, shape)
        elif name.endswith("freqs"):
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
    from flaxdiff_tpu_torch.predictors import (EpsilonPredictionTransform,
                                               KarrasPredictionTransform)
    from flaxdiff_tpu_torch.samplers import DDIMSampler, EulerAncestralSampler, HeunSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, KarrasVENoiseSchedule

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

    pair = ((dev, gpu), ("cpu", cpu))
    x0 = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    cond = rng.standard_normal((1, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    # from t = 333: from t = 999 random weights drive every eps-prediction
    # sample into the [-1, 1] clip (x0 divides by signal ~ 5e-5)
    vp = dict(init_samples=x0, cond=cond, start_step=333.0)
    res = {"forward_64_f32_err": err, "forward_64_f32_scale": scale}
    res["ddim3"] = trajectory_check(pair, "DDIM-3 + CFG 32x32 f32 from t=333",
                                    CosineNoiseSchedule, EpsilonPredictionTransform(),
                                    DDIMSampler(), 3, **vp)
    # its noise drawn once here and fed to both sides
    draws = [rng.standard_normal(x0.shape).astype(np.float32) for _ in range(4)]
    res["euler_ancestral4"] = trajectory_check(
        pair, "euler_ancestral-4 + CFG 32x32 f32 from t=333", CosineNoiseSchedule,
        EpsilonPredictionTransform(), EulerAncestralSampler(), 4, draws=draws, **vp)
    # EDM preconditioning keeps x0 = c_skip x + c_out F bounded from sigma 80
    res["heun4_karras"] = trajectory_check(
        pair, "Heun-4 + CFG KarrasVE/Karras, karras spacing, 32x32 f32 from sigma 80",
        KarrasVENoiseSchedule, KarrasPredictionTransform(), HeunSampler(), 4,
        init_samples=(80.0 * x0).astype(np.float32), cond=cond, spacing="karras")
    res.update(train_step_check(dev, gpu, cpu, rng))
    del models, gpu, cpu
    return res


def trajectory_check(models, label, schedule, transform, sampler, steps, init_samples, cond,
                     start_step=None, spacing="linear", draws=None) -> dict:
    """A short trajectory with CFG, f32, on the card (kernels) and on the
    CPU (plain versions), the same weights, inputs and draws: within 1e-2,
    and the samples mostly inside the clip, or the comparison would see only
    +-1. Early steps divide by a small signal rate, which amplifies the
    forward's difference."""
    from flaxdiff_tpu_torch.samplers import DiffusionSampler, GivenNoise

    samples = []
    for where, m in models:
        sampler_ = DiffusionSampler(lambda a, b, c, m=m: m(a, b, c), schedule(1000), transform,
                                    sampler, guidance_scale=GUIDANCE, timestep_spacing=spacing,
                                    device=where)
        samples.append(sampler_.generate_samples(
            diffusion_steps=steps, init_samples=torch.from_numpy(init_samples),
            generator=None if draws is None else GivenNoise(draws, device=where),
            conditioning=torch.from_numpy(cond), unconditional=torch.zeros(cond.shape),
            start_step=start_step).cpu())
    out, ref = samples
    err = max_err(out, ref)
    clipped = float((ref.abs() >= 1.0).float().mean())
    log(f"  {label}: max err {err:.3g}, {clipped:.0%} of values clipped")
    check(clipped < 0.6, f"{label}: samples mostly inside the clip range")
    check(err <= 1e-2, f"{label}: error {err} above 1e-2")
    return {"err": err, "clipped_share": clipped}


def wide_block_check(dev, w: dict, expected_launches=None) -> dict:
    """One UNet transformer block of a wide level (WIDE_LEVEL: 1280 channels
    in 8 heads of 160, which the dispatch pads to 256; UNET3D_LEVEL: 4 heads
    of 320, the wide kernels; 16x16 tokens with self-attention, cross to the
    77x768 text, GEGLU) in f32, card (kernels) against CPU (plain versions),
    the same random weights and inputs: the forward within 1e-3 x max(1,
    max|ref|), every gradient (the weights', the tokens' and the text's)
    within 1e-3 of its max|g|, the key biases' (zero by the math) below 1e-6
    of the largest. With `expected_launches`, the launch counters, zeroed
    just before the card's forward and backward, must read those launches."""
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.models.attention import TransformerBlock

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
        reset_launch_counts()
        out = block(xs, cs)
        named = list(block.named_parameters())
        grads = torch.autograd.grad(out, [t for _, t in named] + [xs, cs],
                                    torch.from_numpy(g).to(where))
        if where == dev:
            torch.cuda.synchronize()
            counts = launch_counts()
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
    res = {"forward_err": err, "forward_scale": scale, "worst_grad_rel_err": worst,
           "worst_grad": worst_name, "launches": counts}
    if expected_launches is not None:
        expected = {k: expected_launches.get(k, 0) for k in counts}
        log(f"  launches {counts}, expected {expected}")
        check(counts == expected, f"the {w['heads']} x {w['dim_head']} block ran its kernels")
    return res


def train_step_check(dev, gpu, cpu, rng):
    """One training step's loss and gradients at 64x64, f32, batch 2, the
    same weights and draws on the card (kernels) and the CPU (plain
    versions): the cosine schedule with eps prediction, then EDM (float
    timesteps drawn from its log-normal sigmas, c_in, c_noise, the c_skip /
    c_out wrap and EDM weights)."""
    from flaxdiff_tpu_torch.predictors import (EpsilonPredictionTransform,
                                               KarrasPredictionTransform)
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, EDMNoiseSchedule

    arrays = {"sample": rng.standard_normal((2, 64, 64, 3)),
              "cond": rng.standard_normal((2, TEXT_LEN, TEXT_DIM)),
              "noise": rng.standard_normal((2, 64, 64, 3)),
              "t": np.array([91, 655], np.int32), "mask": np.array([False, True])}
    # zero by the math (softmax ignores the shift a key bias adds to every
    # logit of a row): both sides hold f32 rounding
    zero = lambda name: name.endswith("to_k.bias")
    # f32 with TF32 off; convolutions summed in other orders through ~60
    # layers and back
    res = step_check(dev, gpu, cpu, arrays, CosineNoiseSchedule, EpsilonPredictionTransform(),
                     zero, "train step 64x64 f32")
    out = {f"train_step_64_f32_{k}": v for k, v in res.items()}
    arrays["t"] = EDMNoiseSchedule(1000).sample_timesteps(
        torch.Generator().manual_seed(7), 2).numpy()
    res = step_check(dev, gpu, cpu, arrays, EDMNoiseSchedule, KarrasPredictionTransform(),
                     zero, f"EDM train step 64x64 f32, t {arrays['t']}")
    out.update({f"edm_train_step_64_f32_{k}": v for k, v in res.items()})
    return out


def step_check(dev, gpu, cpu, arrays, schedule, transform, zero_by_math, label):
    """Loss and every gradient of one training step, f32, the same weights
    and draws on the card and the CPU: loss within 1e-5 relative, each
    gradient within 1e-3 of its max|g|, the ones `zero_by_math` names below
    1e-6 of the model's largest."""
    from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder

    results = []
    for where, m in ((dev, gpu), ("cpu", cpu)):
        a = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(where)
             for k, v in arrays.items()}
        build = make_loss_builder(schedule(1000, device=where),
                                  transform, TrainStepConfig(normalize=False),
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


def serving_model(dev, state):
    """Phase 4's UNet in bf16 with `state`'s weights, and its text and null
    contexts."""
    from flaxdiff_tpu_torch.models import Unet

    model = Unet(**UNET, dtype="bfloat16", device=dev)
    model.load_state_dict(state)
    model.eval()
    rng = np.random.default_rng(2)
    cond = torch.from_numpy(rng.standard_normal((1, TEXT_LEN, TEXT_DIM)).astype(np.float32))
    return model, cond, torch.zeros(1, TEXT_LEN, TEXT_DIM)


def main_path(dev, state):
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    model, cond, uncond = serving_model(dev, state)
    sampler = DiffusionSampler(lambda x, t, c: model(x, t, c), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(),
                               guidance_scale=GUIDANCE, device=dev)
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


def run_training(dev, model, schedule, shape, per_step, transform=None,
                 fixed_draws: bool = False):
    """DiffusionTrainer.train_step from the model's own init, AdamW 1e-4 at
    optax's defaults, EMA 0.999, CFG dropout 0.12 to a zeros context: 3
    warm-up and 20 timed steps over 4 seeded synthetic batches of `shape`
    with a text context, eps prediction unless `transform` says otherwise.
    Every launch counter, zeroed just before, must read `per_step` launches a
    step, and the loss must fall: the mean of the last 5 below the first or,
    with `fixed_draws`, the loss of the first batch under one fixed draw of
    noise and timesteps lower after the steps than before them (EDM's
    per-step loss swings 1-4x with its log-normal sigma draws, far more than
    23 steps move it)."""
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.trainer import (AdamW, DiffusionTrainer, TrainerConfig,
                                            TrainStepConfig, make_loss_builder)

    trainer = DiffusionTrainer(
        model, AdamW(TRAIN_LR), schedule, transform or EpsilonPredictionTransform(),
        TrainerConfig(uncond_prob=0.12, ema_decay=0.999, normalize=False, weighted_loss=True,
                      gate_nonfinite=True, seed=0),
        null_cond=torch.zeros(1, TEXT_LEN, TEXT_DIM), device=dev)
    rng = np.random.default_rng(3)
    batch = shape[0]
    batches = [{"sample": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev),
                "cond": torch.from_numpy(rng.standard_normal(
                    (batch, TEXT_LEN, TEXT_DIM)).astype(np.float32)).to(dev)}
               for _ in range(4)]
    if fixed_draws:
        gen = torch.Generator(device=dev).manual_seed(1)
        draws = (torch.randn(shape, generator=gen, device=dev),
                 trainer.schedule.sample_timesteps(gen, batch),
                 torch.zeros(batch, dtype=torch.bool, device=dev))
        build = make_loss_builder(trainer.schedule, transform,
                                  TrainStepConfig(normalize=False, weighted_loss=True))
        with torch.no_grad():
            probe = lambda: float(build(batches[0], *draws)(trainer.state.model))
            fixed_before = probe()
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
    if fixed_draws:
        with torch.no_grad():
            fixed_after = probe()
        log(f"  first batch, fixed draws: loss {fixed_before:.5f} before, {fixed_after:.5f} after")
        check(fixed_after < fixed_before, f"the loss fell under fixed draws: {fixed_after} "
              f"against {fixed_before}")
    else:
        check(last5 < losses[0], f"the loss fell: mean of the last 5 {last5} against {losses[0]}")
    ms = start.elapsed_time(end) / TIMED
    res = {"ms_per_step": ms, "samples_per_s": batch * 1e3 / ms,
           "wall_ms_per_step": wall * 1e3 / TIMED,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": trainer.state.params.numel(), "losses": losses,
           "mean_last5_loss": last5, "launches": counts}
    if fixed_draws:
        res.update(fixed_draw_loss_before=fixed_before, fixed_draw_loss_after=fixed_after)
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


# --- phase 10: the training CLI, checkpoints, resume, inference from a checkpoint --

CLI_STEPS, CLI_SAVE_EVERY, CLI_LOG_EVERY, CLI_WARMUP, CLI_POISON_STEPS = 40, 20, 10, 10, 10
# phase 5's UNet; the hash encoder's 64 features set the context width
CLI_MODEL = {k: v for k, v in UNET.items() if k != "context_dim"}
CLI_PROMPTS = ["bright", "dark"]


def cli_args(checkpoint_dir: str, total_steps: int, dev) -> list:
    return ["--device", str(dev), "--dataset", "synthetic", "--text_encoder", "hash", "--image_size", str(TRAIN_RES),
            "--batch_size", str(TRAIN_BATCH), "--architecture", "unet",
            "--model_config", json.dumps(CLI_MODEL), "--dtype", "bfloat16",
            "--optimizer", "adamw", "--lr", str(TRAIN_LR), "--warmup_steps", str(CLI_WARMUP),
            "--total_steps", str(total_steps), "--grad_clip", "1.0",
            "--save_every", str(CLI_SAVE_EVERY), "--log_every", str(CLI_LOG_EVERY),
            "--checkpoint_dir", checkpoint_dir, "--seed", "0"]


def copy_run(src: str, dst: str, step: int) -> None:
    """A run directory holding `src`'s config, hash table and `step` only
    (hard links: nothing is copied)."""
    os.makedirs(dst)
    for name in ("pipeline_config.json", "hash_table.npy"):
        shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
    shutil.copytree(os.path.join(src, str(step)), os.path.join(dst, str(step)),
                    copy_function=os.link)


def cli_path(dev, per_step: dict) -> dict:
    """Phase 10 (see the module docstring)."""
    import tempfile

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.trainer import Checkpointer

    root = tempfile.mkdtemp(prefix="flaxdiff_cli_")
    res = {}
    try:
        whole, resumed, poisoned = (os.path.join(root, n) for n in ("whole", "resumed", "poison"))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = train.main(cli_args(whole, CLI_STEPS, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expected = {k: CLI_STEPS * per_step.get(k, 0) for k in counts}
        log(f"  launches {counts}, expected {expected}")
        check(counts == expected, "every forward and backward kernel ran once per call per step")
        log("  window losses " + " ".join(f"{x:.5f}" for x in hist["loss"]))
        check(hist["steps"] == list(range(CLI_LOG_EVERY, CLI_STEPS + 1, CLI_LOG_EVERY))
              and all(math.isfinite(x) for x in hist["loss"]), "every window loss finite")
        # the first window holds the warm-up (cuDNN's choices, the allocator)
        steady = [TRAIN_BATCH * 1e3 / ips for ips in hist["imgs_per_sec"][1:]]
        ckpt = hist["checkpoint"]
        res["fit"] = {"wall_s": wall, "window_ms_per_step": [TRAIN_BATCH * 1e3 / ips for ips in
                                                             hist["imgs_per_sec"]],
                      "ms_per_step": float(np.median(steady)),
                      "images_per_s": TRAIN_BATCH * 1e3 / float(np.median(steady)),
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "losses": hist["loss"], "launches": counts, "saves": hist["saves"],
                      "checkpoint": ckpt}
        log(f"  fit: {res['fit']['ms_per_step']:.3f} ms per step (median of windows 2-4: "
            + " ".join(f"{x:.3f}" for x in steady) + f"), {res['fit']['images_per_s']:.1f} "
            f"images/s, {wall:.2f} s for {CLI_STEPS} steps with the model's build; peak "
            f"{res['fit']['peak_mem_gib']:.2f} GiB; checkpoint of step {ckpt['step']}: "
            f"{ckpt['bytes'] / 2 ** 30:.3f} GiB, the loop held {ckpt['blocked_s'] * 1e3:.1f} ms, "
            f"written in {ckpt['write_s']:.3f} s")

        copy_run(whole, resumed, CLI_SAVE_EVERY)
        reset_launch_counts()
        hist = train.main(cli_args(resumed, CLI_STEPS, dev))
        counts = launch_counts()
        half = CLI_STEPS - CLI_SAVE_EVERY
        check(counts == {k: half * per_step.get(k, 0) for k in counts},
              f"the resumed run launched every kernel once per call for {half} steps")
        a, _ = Checkpointer(whole).restore(CLI_STEPS)
        b, _ = Checkpointer(resumed).restore(CLI_STEPS)
        diffs = {k: float((a[k] - b[k]).abs().max()) for k in ("params", "ema", "exp_avg",
                                                                "exp_avg_sq")}
        res["resume"] = {"max_abs_diff": diffs, "bit_equal": all(torch.equal(a[k], b[k]) for k in diffs),
                         "steps": hist["steps"], "losses": hist["loss"]}
        log(f"  resumed from step {CLI_SAVE_EVERY} to {CLI_STEPS}: largest differences to the "
            f"uninterrupted run {diffs}")
        check(res["resume"]["bit_equal"], "the resumed run equals the uninterrupted one bit for bit")

        copy_run(whole, poisoned, CLI_SAVE_EVERY)
        run = train.make_run(cli_args(poisoned, CLI_STEPS, dev))

        def poison(batches, at):
            for i, batch in enumerate(batches):
                if i == at:
                    batch = {**batch, "sample": np.full(batch["sample"].shape, np.nan, np.float32)}
                yield batch

        hist = run.trainer.fit(poison(run.batches(run.start_step), 1), CLI_POISON_STEPS)
        run.trainer.checkpointer.close()
        state = run.trainer.state
        finite = all(bool(torch.isfinite(v).all()) for v in state.buffers().values())
        res["poison"] = {"steps": hist["steps"], "step_after": state.step, "finite": finite}
        log(f"  NaN batch at step {CLI_SAVE_EVERY + 2}: windows kept {hist['steps']}, state at "
            f"step {state.step}, finite {finite}")
        check(finite and hist["steps"] == [] and state.step == CLI_SAVE_EVERY,
              "the NaN batch rolled the run back to the restored state, every buffer finite")
        del run, state
        torch.cuda.empty_cache()

        pipe = DiffusionInferencePipeline.from_checkpoint(whole, device=dev)
        request = lambda steps: pipe.generate_samples(
            resolution=TRAIN_RES, diffusion_steps=steps, sampler="ddim",
            guidance_scale=GUIDANCE, prompts=CLI_PROMPTS, seed=1)
        request(2)                 # warm-up: cuDNN's choices, the allocator
        reset_launch_counts()
        t0 = time.perf_counter()
        out = request(STEPS)
        req_wall = time.perf_counter() - t0
        counts = launch_counts()
        check(counts == {k: PER_FORWARD.get(k, 0) * (STEPS + 1) for k in counts},
              "the pipeline's request launched PER_FORWARD x 51 kernels")
        check(out.shape == (2, TRAIN_RES, TRAIN_RES, 3) and bool(np.isfinite(out).all())
              and float(np.abs(out).max()) <= 1.0, f"samples {out.shape}, finite, in [-1, 1]")
        res["serving"] = {"wall_s": req_wall, "launches": counts,
                          "sample_std": float(out.std()), "ms_per_call": req_wall * 1e3 / (STEPS + 1)}
        res["launches"] = {k: res["fit"]["launches"][k] + counts[k] for k in counts}
        log(f"  from_checkpoint: DDIM-{STEPS} CFG {GUIDANCE} for {CLI_PROMPTS} at "
            f"{TRAIN_RES}x{TRAIN_RES} bf16: wall {req_wall:.3f} s "
            f"({res['serving']['ms_per_call']:.2f} ms per call)")
        del pipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# --- phase 12: the JAX CLI's training options, float16 through the loss scale --

# phase 10's run with train.py's training options: float16 (flax's dynamic
# loss scale), MultiSteps(4) over lamb, the monitored step every 10 steps, a
# 16-slot loss ring, the gate counter, a validation grid (euler_ancestral-50
# + CFG) between the two chunks of 20 steps, and a profiler window; saves
# every 10 steps, so the resume can start at 30, inside an accumulation
CLI12_STEPS, CLI12_SAVE_EVERY, CLI12_RESUME_AT, CLI12_ACCUM = 40, 10, 30, 4
CLI12_VAL_EVERY, CLI12_VAL_STEPS, CLI12_RING, CLI12_CADENCE = 20, 50, 16, 10
# the card-vs-CPU check of the same chain in f32 (phase 3's UNet at 32x32,
# batch 2): MultiSteps(2) over lamb with the scale growing every 2 finite
# steps, a NaN batch at step 4 of 5
CHAIN_STEPS, CHAIN_NAN_AT, CHAIN_RES = 5, 3, 32


def with_flags(args: list, **flags) -> list:
    """`args` with each --flag set to its value (True: a bare switch),
    replacing the value a flag already has."""
    args = list(args)
    for flag, value in flags.items():
        key = "--" + flag
        if key in args:
            i = args.index(key)
            del args[i:i + (1 if value is True else 2)]
        args += [key] if value is True else [key, str(value)]
    return args


def cli12_args(checkpoint_dir: str, dev, profile_dir: str) -> list:
    return with_flags(cli_args(checkpoint_dir, CLI12_STEPS, dev), dtype="float16",
                      grad_accum=CLI12_ACCUM, optimizer="lamb", numerics_cadence=CLI12_CADENCE,
                      loss_ring=CLI12_RING, gate_counter=True, val_every=CLI12_VAL_EVERY,
                      val_steps=CLI12_VAL_STEPS, save_every=CLI12_SAVE_EVERY,
                      profile_dir=profile_dir)


@contextlib.contextmanager
def recorded_scale(trajectory: list, runs: list):
    """train.make_run patched to keep each run and to stack the loss scale
    and fin_steps on the device after every step (no host read), for the
    trajectory the run never prints."""
    from flaxdiff_tpu_torch import train

    make_run = train.make_run

    def recording(argv=None):
        run = make_run(argv)
        inner, scale = run.trainer._run, run.trainer.state.dynamic_scale

        def step(fn, batch):
            out = inner(fn, batch)
            trajectory.append(torch.stack([scale.scale, scale.fin_steps.float()]))
            return out
        run.trainer._run = step
        runs.append(run)
        return run
    train.make_run = recording
    try:
        yield
    finally:
        train.make_run = make_run


def options_path(dev, per_step: dict, phase10: dict, phase5: dict) -> dict:
    """Phase 12 (see the module docstring). The fit's windows hold the
    profiler window and the monitored steps, so the micro-step is also
    timed as phase 5 times its step: the same trainer, 3 warm-up and 20
    micro-steps on 4 batches already on the card, between CUDA events."""
    import tempfile

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.trainer import Checkpointer

    root = tempfile.mkdtemp(prefix="flaxdiff_cli12_")
    res = {}
    try:
        whole, resumed, poisoned = (os.path.join(root, n) for n in ("whole", "resumed", "poison"))
        trajectory, runs = [], []
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_scale(trajectory, runs):
            hist = train.main(cli12_args(whole, dev, os.path.join(root, "profile")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        # one validation grid at step 20: euler_ancestral-50 calls the model
        # STEPS + 1 times, as phase 8 counts it
        expected = {k: CLI12_STEPS * per_step.get(k, 0) + (STEPS + 1) * PER_FORWARD.get(k, 0)
                    for k in counts}
        log(f"  launches {counts}, expected {expected}")
        check(counts == expected, "every f16 forward and backward kernel ran once per call per "
              "micro-step, and the forward kernels once per call of the validation grid")
        traj = torch.stack(trajectory).cpu().tolist()
        scales, fins = [s for s, _ in traj], [int(f) for _, f in traj]
        state = runs[0].trainer.state
        skipped = [i + 1 for i in range(1, len(scales)) if scales[i] < scales[i - 1]]
        skipped = ([1] if scales and scales[0] < 65536.0 else []) + skipped
        landed = CLI12_ACCUM * int(state.count) + int(state.mini_step)
        log(f"  loss scale by micro-step: {scales}")
        log(f"  fin_steps by micro-step: {fins}")
        log(f"  skipped micro-steps (the scale backed off): {skipped}; count "
            f"{int(state.count)}, mini-step {int(state.mini_step)}, step {state.step}")
        check(len(traj) == CLI12_STEPS and state.step == CLI12_STEPS,
              "the trajectory has every micro-step")
        check(landed + len(skipped) == CLI12_STEPS, f"every micro-step either landed or was "
              f"skipped: {landed} + {len(skipped)}")
        check(all(math.isfinite(x) for x in hist["loss"]), "every window loss finite")
        check(hist["steps"] == [16, 20, 36, 40], f"ring windows {hist['steps']}")
        check(len(hist["numerics"]) == CLI12_STEPS // CLI12_CADENCE
              and all(row["numerics/skipped"] in (0.0, 1.0) for row in hist["numerics"]),
              "a monitored step every 10 micro-steps")
        check(any(k.startswith("numerics/module/TimeProjection_0/") for k in hist["numerics"][0]),
              "the aux's modules carry the JAX names")
        check(hist["skipped_steps"] == sum(1 for r in hist["numerics"] if r["numerics/skipped"]),
              "skipped monitored steps counted")
        events = state.gate_events.tolist()
        trace = hist["profile_trace"]
        trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace) as f:
            kernel_events = len(re.findall(r'"cat":\s*"kernel"', f.read()))
        check(trace_bytes > 0 and kernel_events > 0,
              f"the profiler trace {trace} exists with device kernels ({kernel_events})")
        val = hist["validation"]
        check(len(val) == 1 and val[0]["step"] == CLI12_VAL_EVERY
              and val[0]["samples"].shape == (8, TRAIN_RES, TRAIN_RES, 3),
              "one validation grid of 8 samples at step 20")
        # ms per micro-step from the ring's windows after the first (which
        # holds the warm-up), weighted by their micro-steps; they also hold
        # the profiler windows (micro-steps 10-14 of each chunk) and the
        # monitored steps
        per_window = [TRAIN_BATCH * 1e3 / ips for ips in hist["imgs_per_sec"]]
        sizes = np.diff([0] + hist["steps"])
        ms = float(np.dot(per_window[1:], sizes[1:]) / sizes[1:].sum())
        res["fit"] = {"wall_s": wall, "window_ms_per_step": per_window,
                      "window_steps": sizes.tolist(), "ms_per_micro_step": ms,
                      "phase10_ms_per_step": phase10["fit"]["ms_per_step"],
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "losses": hist["loss"], "launches": counts, "scale": scales,
                      "fin_steps": fins, "skipped": skipped, "count": int(state.count),
                      "gate_events": events, "numerics": hist["numerics"],
                      "validation_wall_s": val[0]["wall_s"],
                      "validation_std": float(val[0]["samples"].std()),
                      "profile_trace_bytes": trace_bytes, "profile_kernel_events": kernel_events,
                      "checkpoint": hist["checkpoint"]}
        log(f"  fit: {ms:.3f} ms per micro-step (windows 2-4, by micro-steps: "
            + " ".join(f"{x:.3f}" for x in per_window[1:]) + f"; phase 10's bf16 step "
            f"{phase10['fit']['ms_per_step']:.3f}), {wall:.2f} s with the model's build and "
            f"the validation; peak {res['fit']['peak_mem_gib']:.2f} GiB; validation grid "
            f"(euler_ancestral-{CLI12_VAL_STEPS} + CFG, 8 samples) {val[0]['wall_s']:.3f} s; "
            f"gate counter {events}; trace {trace_bytes} bytes, {kernel_events} kernel events")
        trainer = runs[0].trainer
        stream = runs[0].batches(0)
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in next(stream).items()
                    if k in ("sample", "cond")} for _ in range(4)]
        stream.close()
        for i in range(WARMUP):
            trainer.train_step(batches[i % 4])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(TIMED):
            trainer.train_step(batches[i % 4])
        end.record()
        end.synchronize()
        loop_ms = start.elapsed_time(end) / TIMED
        res["fit"].update(loop_ms_per_micro_step=loop_ms,
                          phase5_ms_per_step=phase5["ms_per_step"])
        log(f"  loop: {loop_ms:.3f} ms per micro-step (CUDA events over {TIMED}; phase 5's bf16 "
            f"step {phase5['ms_per_step']:.3f})")
        res["fit"]["breakdown"] = family_profile(lambda: trainer.train_step(batches[0]),
                                                 training=True)
        by_family = res["fit"]["breakdown"]["ms_by_family"]
        if by_family:
            res["fit"]["busy_ms"] = sum(by_family.values())
            res["fit"]["idle_share"] = 1.0 - res["fit"]["busy_ms"] / loop_ms
            log(f"  device busy {res['fit']['busy_ms']:.3f} ms of {loop_ms:.3f} ms per "
                f"micro-step ({res['fit']['idle_share']:.0%} idle)")
        del runs[:], state, trainer, batches
        torch.cuda.empty_cache()

        copy_run(whole, resumed, CLI12_RESUME_AT)
        reset_launch_counts()
        hist = train.main(cli12_args(resumed, dev, os.path.join(root, "profile_resumed")))
        rest = CLI12_STEPS - CLI12_RESUME_AT
        check(launch_counts() == {k: rest * per_step.get(k, 0) for k in counts},
              f"the resumed run launched every kernel once per call for {rest} micro-steps")
        a, _ = Checkpointer(whole).restore(CLI12_STEPS)
        b, _ = Checkpointer(resumed).restore(CLI12_STEPS)
        mid, _ = Checkpointer(whole).restore(CLI12_RESUME_AT)
        tensors = [k for k, v in a.items() if isinstance(v, torch.Tensor)]
        equal = {k: torch.equal(a[k], b[k]) for k in tensors}
        res["resume"] = {"bit_equal": equal, "mini_step_at_resume": int(mid["mini_step"]),
                         "steps": hist["steps"]}
        log(f"  resumed from micro-step {CLI12_RESUME_AT} (mini-step "
            f"{int(mid['mini_step'])} of {CLI12_ACCUM}) to {CLI12_STEPS}: bit-equal {equal}")
        check(CLI12_RESUME_AT % CLI12_ACCUM != 0 and all(equal.values())
              and {"acc", "mini_step", "count", "loss_scale", "loss_ring",
                   "gate_events"} <= set(tensors),
              "the resumed run equals the uninterrupted one bit for bit, accumulator and "
              "loss scale included")

        copy_run(whole, poisoned, CLI12_STEPS)
        run = train.make_run(cli12_args(poisoned, dev, os.path.join(root, "profile_poison")))
        state = run.trainer.state
        stream = run.batches(run.start_step)
        batch = next(stream)
        stream.close()
        batch = {**batch, "sample": np.full(batch["sample"].shape, np.nan, np.float32)}
        before = {k: v.clone() for k, v in state.buffers().items()}
        loss = float(run.trainer.train_step(batch))
        after = state.buffers()
        kept = {k: torch.equal(before[k], after[k]) for k in
                ("params", "exp_avg", "exp_avg_sq", "acc", "count", "mini_step", "gate_events")}
        scale_before = float(before["loss_scale"])
        res["poison"] = {"loss": loss, "kept": kept, "scale_before": scale_before,
                         "scale_after": float(after["loss_scale"]),
                         "fin_steps_after": int(after["loss_scale_fin_steps"]),
                         "step_after": state.step}
        log(f"  NaN batch at micro-step {CLI12_STEPS + 1}: loss {loss}, scale {scale_before} -> "
            f"{res['poison']['scale_after']}, fin_steps {res['poison']['fin_steps_after']}, "
            f"unchanged {kept}")
        check(not math.isfinite(loss) and all(kept.values())
              and res["poison"]["scale_after"] == scale_before / 2
              and res["poison"]["fin_steps_after"] == 0 and state.step == CLI12_STEPS + 1,
              "the NaN batch backed the scale off and left params, moments, accumulator and "
              "counts unchanged")
        run.trainer.checkpointer.close()
        del run, state, before, after
        torch.cuda.empty_cache()
        res["launches"] = res["fit"]["launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def chain_card_vs_cpu(dev, unet_state: dict) -> dict:
    """Phase 12's chain in f32, card against CPU: the same weights, batches
    and draws through make_train_step with MultiSteps(2) over clip + lamb,
    the loss scale growing every 2 finite steps and a NaN batch. The scale
    and fin_steps must equal the CPU's after every step, the counts too,
    and the params end within an update's quantum: every element within 3x
    the largest element an update moved, 99% within 1% of it (Adam and the
    trust ratio turn ulp-level differences of near-zero gradients into
    whole steps, as tests/test_torch_train.py holds)."""
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import (DynamicScale, MultiSteps, TrainState,
                                            TrainStepConfig, chain, clip_by_global_norm, lamb,
                                            make_train_step, warmup_cosine_decay_schedule)

    rng = np.random.default_rng(12)
    shape = (2, CHAIN_RES, CHAIN_RES, 3)
    batches = [rng.standard_normal(shape).astype(np.float32) for _ in range(CHAIN_STEPS)]
    batches[CHAIN_NAN_AT][:] = np.nan
    draws = [(rng.standard_normal(shape).astype(np.float32),
              rng.integers(0, 1000, 2).astype(np.int64), np.array([False, True]))
             for _ in range(CHAIN_STEPS)]
    cond = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    sides = []
    for where in (dev, torch.device("cpu")):
        model = Unet(**UNET, device=where)
        model.load_state_dict(unet_state)
        tx = MultiSteps(chain(clip_by_global_norm(1.0),
                              lamb(warmup_cosine_decay_schedule(0.0, 1e-3, 1, 4))), 2)
        state = TrainState(model, tx, ema_decay=0.999,
                           dynamic_scale=DynamicScale(growth_interval=2))
        start = state.params.clone()
        step = make_train_step(CosineNoiseSchedule(1000, device=where),
                               EpsilonPredictionTransform(), TrainStepConfig(normalize=False),
                               null_cond=torch.zeros(1, TEXT_LEN, TEXT_DIM, device=where),
                               gate_nonfinite=True)
        traj = []
        for x, (noise, t, mask) in zip(batches, draws):
            to = lambda a: torch.from_numpy(a).to(where)
            step(state, {"sample": to(x), "cond": to(cond)}, to(noise), to(t), to(mask))
            traj.append((float(state.dynamic_scale.scale), int(state.dynamic_scale.fin_steps),
                         int(state.count), int(state.mini_step)))
        sides.append((traj, state.params.cpu(), start.cpu()))
        del model, state
    (traj, params, _), (ref_traj, ref_params, start) = sides
    moved = float((ref_params - start).abs().max())
    d = (params - ref_params).abs()
    share = float((d <= 1e-2 * moved).float().mean())
    res = {"trajectory": traj, "cpu_trajectory": ref_traj, "largest_move": moved,
           "max_param_diff": float(d.max()), "share_within_1pct": share}
    log(f"  f32 chain card vs CPU: (scale, fin_steps, count, mini-step) {traj}; params differ "
        f"by at most {float(d.max()):.3g} (largest move {moved:.3g}), {share:.4f} within 1%")
    check(traj == ref_traj, f"the loss scale's trajectory equals the CPU's: {ref_traj}")
    grown = traj[CHAIN_NAN_AT - 1][0]
    check(grown > traj[0][0] and traj[CHAIN_NAN_AT][0] < grown, "the scale grew and backed off")
    check(float(d.max()) <= 3 * moved and share >= 0.99,
          "the params within an update's quantum of the CPU's")
    return res


def f16_forward_check(dev, unet_state: dict) -> dict:
    """Phase 5's UNet in float16 against the same weights in f32 on the
    card, one forward at 64x64, batch 2, with the text context: the f16
    kernels and f16 activations through ~40 layers. Limits: RMS of the
    difference within 1e-2 of the f32 output's, every element within 5e-2
    of its largest (a few f16 ulps a layer, compounded)."""
    from flaxdiff_tpu_torch.models import Unet

    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32)).to(dev)
    t = torch.tensor([91.0, 655.0], device=dev)
    ctx = torch.from_numpy(rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)).to(dev)
    outs = []
    for dtype in ("float32", "float16"):
        model = Unet(**UNET, dtype=dtype, device=dev)
        model.load_state_dict(unet_state)
        with torch.no_grad():
            outs.append(model(x, t, ctx).float())
        del model
    ref, out = outs
    reading = compare(out, ref, atol=5e-2 * float(ref.abs().max()), rtol=0.0, rms_rel=1e-2)
    log(f"  f16 forward against f32: max err {reading['max_abs_err']:.3g} (limit "
        f"{reading['atol']:.3g}), rms rel {reading['rms_rel']:.3g} (limit 1e-2)")
    check(bool(torch.isfinite(out).all()) and passes(reading), f"f16 forward: {reading}")
    return reading


# --- phases 8 and 9: every sampler, EDM training -------------------------------

# (request, sampler name and settings, schedule, spacing): the cosine schedule
# with eps prediction, the KarrasVE ramp (sigma_max 80) with EDM
# preconditioning and karras spacing, and an inpainting request
SAMPLER_REQUESTS = [(name, name, {}, "cosine", "linear") for name in
                    ("ddpm", "simple_ddpm", "euler", "simple_euler", "euler_ancestral", "heun")]
SAMPLER_REQUESTS += [(f"multistep_dpm{k}", "multistep_dpm", {"order": k}, "cosine", "linear")
                     for k in (2, 3)]
SAMPLER_REQUESTS += [(f"{name}_karras", name, {}, "karras", "karras")
                     for name in ("euler", "heun", "rk4")]
SAMPLER_REQUESTS += [("ddim_inpaint", "ddim", {}, "cosine", "linear")]
CALLS_PER_STEP = {"heun": 2, "rk4": 4}


def sampler_paths(dev, state):
    """Every sampler at phase 4's full width (bf16, batch 1, CFG 3.0, the
    77x768 text), one 50-step request each, the launch counters zeroed just
    before each and read just after: PER_FORWARD x its model calls (50 x
    calls a step + the terminal one). The inpainting request generates the
    left half and keeps the right half of a reference, exactly."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import (EpsilonPredictionTransform,
                                               KarrasPredictionTransform)
    from flaxdiff_tpu_torch.samplers import DiffusionSampler, get_sampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, KarrasVENoiseSchedule

    model, cond, uncond = serving_model(dev, state)
    schedules = {"cosine": (CosineNoiseSchedule(1000), EpsilonPredictionTransform()),
                 "karras": (KarrasVENoiseSchedule(1000, sigma_max=80.0),
                            KarrasPredictionTransform())}
    shape = (1, RESOLUTION, RESOLUTION, 3)
    reference = torch.from_numpy(np.random.default_rng(8).uniform(-0.9, 0.9, shape)
                                 .astype(np.float32))
    mask = torch.zeros(1, RESOLUTION, RESOLUTION)
    mask[:, :, : RESOLUTION // 2] = 1.0
    results, total = {}, {}
    for request, name, kwargs, sched, spacing in SAMPLER_REQUESTS:
        schedule, transform = schedules[sched]
        sampler = DiffusionSampler(lambda x, t, c: model(x, t, c), schedule, transform,
                                   get_sampler(name, **kwargs), guidance_scale=GUIDANCE,
                                   timestep_spacing=spacing, device=dev)
        inpaint = dict(inpaint_reference=reference, inpaint_mask=mask) \
            if request.endswith("inpaint") else {}
        calls = STEPS * CALLS_PER_STEP.get(name, 1) + 1
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = sampler.generate_samples(num_samples=1, resolution=RESOLUTION,
                                       diffusion_steps=STEPS, generator=make_generator(9, dev),
                                       conditioning=cond, unconditional=uncond, **inpaint)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expected = {k: PER_FORWARD.get(k, 0) * calls for k in counts}
        check(counts == expected, f"{request}: launches {counts}, expected {expected}")
        check(tuple(out.shape) == shape, f"{request}: output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{request}: samples finite")
        check(float(out.abs().max()) <= 1.0, f"{request}: samples clipped to [-1, 1]")
        res = {"wall_s": wall, "model_calls": calls, "ms_per_call": wall * 1e3 / calls,
               "sample_std": float(out.float().std())}
        if inpaint:
            kept = out[:, :, RESOLUTION // 2:].cpu()
            check(torch.equal(kept, reference[:, :, RESOLUTION // 2:]),
                  f"{request}: the kept half equals the reference")
            res["kept_half_exact"] = True
        log(f"  {request}: {calls} model calls, wall {wall:.3f} s, {res['ms_per_call']:.2f} ms "
            f"per call, sample std {res['sample_std']:.3f}")
        results[request] = res
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    del model
    return {"requests": results, "launches": total}


def edm_training_path(dev):
    """DiffusionTrainer.train_step on phase 5's UNet with EDM: the
    log-normal sigma draws, the Karras transform and EDM loss weights."""
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import KarrasPredictionTransform
    from flaxdiff_tpu_torch.schedulers import EDMNoiseSchedule

    torch.manual_seed(0)
    res = run_training(dev, Unet(**UNET, dtype="bfloat16", device=dev), EDMNoiseSchedule(1000),
                       (TRAIN_BATCH, TRAIN_RES, TRAIN_RES, 3), {**PER_FORWARD, **PER_BACKWARD},
                       KarrasPredictionTransform(), fixed_draws=True)
    res["images_per_s"] = res.pop("samples_per_s")
    return res


# --- phases 3b, 6 and 7: the DiT ---------------------------------------------

def dit_model_checks(dev, state):
    """The full-width DiT-B/2 in f32 on the card (kernels) and the CPU (plain
    versions), the same random weights: a forward, DDIM-3 + CFG from
    t = 333, one train step's loss and gradients."""
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler
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
    traj = trajectory_check(((dev, gpu), ("cpu", cpu)),
                            f"DDIM-3 + CFG {DIT_RES}x{DIT_RES}x{DIT_CH} f32 from t=333",
                            LinearNoiseSchedule, EpsilonPredictionTransform(), DDIMSampler(), 3,
                            init_samples=x0, cond=cond, start_step=333.0)
    arrays = {"sample": rng.standard_normal(shape), "cond": rng.standard_normal((2, TEXT_LEN, TEXT_DIM)),
              "noise": rng.standard_normal(shape), "t": np.array([91, 655], np.int32),
              "mask": np.array([False, True])}
    # the raster order rotates keys by position, so no gradient is zero by the math
    step = step_check(dev, gpu, cpu, arrays, LinearNoiseSchedule, EpsilonPredictionTransform(),
                      lambda name: False, f"train step {DIT_RES}x{DIT_RES}x{DIT_CH} f32")
    del models, gpu, cpu
    return {"forward_f32_err": err, "forward_f32_scale": scale, "ddim3": traj,
            **{f"train_step_f32_{k}": v for k, v in step.items()}}


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


# --- phase 11: every 2D model family of the registry ------------------------------

# the FlaxDiff CLI's default architecture (bench.py:130-138 ref_arch): phase
# 4's UNet with pure attention, dim_head = C / heads (32 and 64)
REF_ARCH = dict(UNET, attention_configs=(None, None) + tuple(
    dict(ATTN, dim_head=c // ATTN["heads"], only_pure_attention=True) for c in (256, 512)))
LATENT = dict(output_channels=4, patch_size=2, in_channels=4, context_dim=TEXT_DIM)
# name -> (registry name, constructor kwargs beyond the JAX defaults, input
# (side, channels), the schedule, launches of one CFG call). The widths are
# the JAX defaults: UViT patch 16, 768 wide, 12 layers of 12 heads on 256^2
# images; SimpleUDiT, SimpleMMDiT and the hybrid SSM DiT (state 64, 3 SSM
# blocks to 1 attention) 768 wide, 12 layers of 12 heads at patch 2 on
# phase 6's 32x32x4 latents; HierarchicalMMDiT (512, 768, 1024) wide, (4, 4,
# 14) layers of (8, 12, 16) heads, base patch 8 on 256^2 images. Launches:
# ref_arch attends once at levels 2 and 3 down and up and in the middle, 19
# res blocks x 2 norms; UViT 13 blocks of self-attention + GEGLU; the U-DiT
# 13 DiT blocks; an MMDiT block one two-view LayerNorm + modulate, two gated
# residuals and one attention (12 blocks; the hierarchy 22 encoder + 8
# decoder); the hybrid's 3 attention blocks (its SSM blocks run plain ops,
# as in JAX)
FAMILIES11 = {
    "unet_ref_arch": ("unet", REF_ARCH, (RESOLUTION, 3), "cosine",
                      {"flash_fwd": 5, "gn_stats": 38, "gn_norm": 38}),
    "uvit": ("uvit", dict(context_dim=TEXT_DIM), (RESOLUTION, 3), "cosine",
             {"flash_fwd": 13, "geglu": 13}),
    "simple_udit": ("simple_udit", LATENT, (DIT_RES, DIT_CH), "linear",
                    {"ln_mod": 26, "gate_res": 26, "flash_fwd": 13}),
    "simple_mmdit": ("simple_mmdit", LATENT, (DIT_RES, DIT_CH), "linear",
                     {"ln_mod": 12, "gate_res": 24, "flash_fwd": 12}),
    "hierarchical_mmdit": ("hierarchical_mmdit", dict(context_dim=TEXT_DIM), (RESOLUTION, 3),
                           "cosine", {"ln_mod": 30, "gate_res": 60, "flash_fwd": 30}),
    "hybrid_ssm_2d": ("hybrid_ssm+2d", LATENT, (DIT_RES, DIT_CH), "linear",
                      {"ln_mod": 6, "gate_res": 6, "flash_fwd": 3}),
}
MMDIT_PER_BACKWARD = {"ln_mod_bwd": 12, "gate_res_bwd": 24, "flash_bwd_dq": 12,
                      "flash_bwd_dkv": 12}


def family_model(dev, key: str, dtype=None, state=None, **extra):
    """FAMILIES11[key] through the registry, the entry point a user calls,
    with `state`'s weights."""
    from flaxdiff_tpu_torch.inference import build_model

    name, kwargs = FAMILIES11[key][:2]
    model = build_model(name, device=dev, dtype=dtype, **kwargs, **extra)
    if state is not None:
        model.load_state_dict(state)
    return model


def family_inputs(key: str, batch: int, seed: int):
    side, ch = FAMILIES11[key][2]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, side, side, ch)).astype(np.float32),
            np.array([37.5, 911.0][:batch], np.float32),
            rng.standard_normal((batch, TEXT_LEN, TEXT_DIM)).astype(np.float32))


def family_schedule(key: str):
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule, LinearNoiseSchedule
    return {"cosine": CosineNoiseSchedule, "linear": LinearNoiseSchedule}[FAMILIES11[key][3]]


def family_forward_check(dev, key: str, state, cpu) -> dict:
    """(a) The f32 forward, batch 1, card (kernels) against CPU (plain
    versions; `cpu` holds `state`), the same random weights: within 1e-3 x
    max(1, max|ref|). Records the CPU forward's wall time, the cost of the
    check at the configuration's full size."""
    args = family_inputs(key, 1, 20)
    gpu = family_model(dev, key, state=state).eval()
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(*map(torch.from_numpy, args))
        cpu_s = time.perf_counter() - t0
        out = gpu(*(torch.from_numpy(a).to(dev) for a in args)).float().cpu()
    del gpu
    scale = max(1.0, float(ref.abs().max()))
    err = max_err(out, ref)
    log(f"  {key} forward {tuple(ref.shape)} f32: max|ref| {scale:.3g}, max err {err:.3g} "
        f"(CPU forward {cpu_s:.1f} s)")
    check(bool(torch.isfinite(out).all()), f"{key} forward output finite")
    check(err <= 1e-3 * scale, f"{key} forward: error {err} above {1e-3 * scale}")
    return {"forward_f32_err": err, "forward_f32_scale": scale, "cpu_forward_s": cpu_s}


def family_serving(dev, key: str, state) -> dict:
    """(b) One DDIM-50 + CFG 3.0 request in bf16, batch 1 with the 77x768
    text and a zeros null context; the launch counters, zeroed just before,
    must read the family's per-call census x 51. Then one CFG call as
    launched from Python beside its busy time as a CUDA graph."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler

    (side, ch), per_forward = FAMILIES11[key][2], FAMILIES11[key][4]
    model = family_model(dev, key, "bfloat16", state).eval()
    sampler = DiffusionSampler(lambda x, t, c: model(x, t, c), family_schedule(key)(1000),
                               EpsilonPredictionTransform(), DDIMSampler(),
                               guidance_scale=GUIDANCE, device=dev)
    _, _, cond = family_inputs(key, 1, 21)
    cond, uncond = torch.from_numpy(cond), torch.zeros(1, TEXT_LEN, TEXT_DIM)
    run = lambda steps, seed: sampler.generate_samples(
        num_samples=1, resolution=side, diffusion_steps=steps, channels=ch,
        generator=make_generator(seed, dev), conditioning=cond, unconditional=uncond)
    run(2, 0)                      # warm-up: GEMM and conv algorithm choice, allocator
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: per_forward.get(k, 0) * (STEPS + 1) for k in counts}
    check(counts == expected, f"{key}: launches {counts}, expected {expected}")
    check(tuple(out.shape) == (1, side, side, ch), f"{key}: output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{key}: samples finite")
    check(float(out.abs().max()) <= 1.0, f"{key}: samples clipped to [-1, 1]")
    res = {"wall_s": wall, "forwards": STEPS + 1, "ms_per_forward": wall * 1e3 / (STEPS + 1),
           "launches_per_call": {k: v // (STEPS + 1) for k, v in counts.items() if v},
           "launches": counts}
    x = torch.randn(2, side, side, ch, device=dev)
    ctx = torch.cat([cond, uncond]).to(dev)
    res["breakdown"] = forward_breakdown(lambda: model(x, torch.full((2,), 500.0, device=dev), ctx),
                                         f"{key}, batch 2 of {side}x{side}x{ch}")
    log(f"  {key}: DDIM-{STEPS} + CFG wall {wall:.3f} s ({res['ms_per_forward']:.2f} ms per "
        f"call), launches per call {res['launches_per_call']}")
    del model
    return res


def remat_check(dev, label: str, make, shape, seed: int) -> dict:
    """(d) One bf16 forward and backward with remat=True against
    remat=False, the same weights and inputs: the output and every gradient
    bit-equal. The plain model runs twice first: a difference there would be
    the card's own nondeterminism, not remat's (cuDNN's deterministic
    algorithms are asked for during the check)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(0, 999, shape[0]).astype(np.float32)).to(dev)
    ctx = torch.from_numpy(rng.standard_normal((shape[0], TEXT_LEN, TEXT_DIM))
                           .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    state, results = None, []
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for remat in (False, False, True):
            model = make(remat)
            state = random_state(model, seed) if state is None else state
            model.load_state_dict(state)
            out = model(x, t, ctx)
            grads = torch.autograd.grad((out.float() * g).sum(), list(model.parameters()))
            results.append((out.detach(), grads))
            del model
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    same = lambda a, b: torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    check(same(results[0], results[1]), f"{label}: two plain runs bit-equal (determinism)")
    check(same(results[0], results[2]), f"{label}: remat bit-equal to no remat")
    log(f"  {label} bf16 {tuple(shape)}: remat output and {len(results[0][1])} gradients "
        f"bit-equal to no remat")
    return {"bit_equal": True, "shape": list(shape), "gradients": len(results[0][1])}


def s5_scan_timing(dev) -> dict:
    """(e) The hybrid's S5 layer (state 64, 768 features, its 256 tokens)
    at the serving path's CFG batch and the training batch, bf16 in: one
    direction's layer and the log-depth scan alone, device time as a CUDA
    graph. The scan is plain PyTorch (JAX's associative_scan is XLA, no
    Pallas kernel)."""
    from flaxdiff_tpu_torch.models import S5Layer
    from flaxdiff_tpu_torch.models.ssm import linear_scan

    torch.manual_seed(0)
    layer = S5Layer(DIT_WIDTH, 64, dtype=BF16, device=dev)
    res = {}
    with torch.inference_mode():
        a_bar, b_bar = layer.discretize()
        for batch in (2, DIT_TRAIN_BATCH):
            u = torch.randn(batch, DIT_TOKENS, DIT_WIDTH, device=dev, dtype=BF16)
            bu = torch.complex(u.float() @ b_bar.real.T, u.float() @ b_bar.imag.T)
            res[f"batch_{batch}"] = {"layer_ms": graph_ms(lambda: layer(u), 5),
                                     "scan_ms": graph_ms(lambda: linear_scan(a_bar, bu), 5),
                                     "layer_launched_ms": time_ms(lambda: layer(u), 10)}
            log(f"  S5 layer [{batch}, {DIT_TOKENS}, {DIT_WIDTH}] state 64: "
                f"{res[f'batch_{batch}']['layer_ms']:.4f} ms on the device "
                f"({res[f'batch_{batch}']['layer_launched_ms']:.4f} ms launched), scan "
                f"{res[f'batch_{batch}']['scan_ms']:.4f} ms")
    return res


def family_paths(dev) -> dict:
    """Phase 11: every configuration of FAMILIES11, (a) card against CPU and
    (b) a serving request; (c) SimpleMMDiT's and the hybrid's f32 train step
    card against CPU, and SimpleMMDiT's bf16 training path; (d) remat on
    phase 5's UNet and DiT-B/2; (e) the S5 scan's time."""
    from flaxdiff_tpu_torch.models import SimpleDiT, Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule

    out = {"forward": {}, "serving": {}}
    for i, key in enumerate(FAMILIES11):
        t0 = time.perf_counter()
        cpu = family_model("cpu", key)
        state = random_state(cpu, 30 + i)
        cpu.load_state_dict(state)
        out["forward"][key] = family_forward_check(dev, key, state, cpu.eval())
        del cpu
        torch.cuda.empty_cache()
        out["serving"][key] = family_serving(dev, key, state)
        out["serving"][key]["phase_s"] = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()

    rng = np.random.default_rng(40)
    shape = (2, DIT_RES, DIT_RES, DIT_CH)
    arrays = {"sample": rng.standard_normal(shape),
              "cond": rng.standard_normal((2, TEXT_LEN, TEXT_DIM)),
              "noise": rng.standard_normal(shape), "t": np.array([91, 655], np.int32),
              "mask": np.array([False, True])}
    out["train_step_f32"] = {}
    for i, key in enumerate(("simple_mmdit", "hybrid_ssm_2d")):
        state = random_state(family_model("cpu", key), 50 + i)
        gpu, cpu = (family_model(where, key, state=state) for where in (dev, "cpu"))
        # RoPE rotates every key by its position: no gradient is zero by the math
        out["train_step_f32"][key] = step_check(
            dev, gpu, cpu, arrays, LinearNoiseSchedule, EpsilonPredictionTransform(),
            lambda name: False, f"{key} train step {DIT_RES}x{DIT_RES}x{DIT_CH} f32")
        del gpu, cpu, state
        torch.cuda.empty_cache()

    log(f"  SimpleMMDiT DiffusionTrainer.train_step, batch {DIT_TRAIN_BATCH}, bf16, "
        f"{WARMUP} + {TIMED} steps")
    torch.manual_seed(0)
    out["mmdit_training"] = run_training(
        dev, family_model(dev, "simple_mmdit", "bfloat16"), LinearNoiseSchedule(1000),
        (DIT_TRAIN_BATCH, DIT_RES, DIT_RES, DIT_CH),
        {**FAMILIES11["simple_mmdit"][4], **MMDIT_PER_BACKWARD})
    torch.cuda.empty_cache()

    out["remat"] = {
        "unet": remat_check(dev, "phase 5's UNet", lambda r: Unet(
            **UNET, dtype="bfloat16", remat=r, device=dev),
            (TRAIN_BATCH, TRAIN_RES, TRAIN_RES, 3), 60),
        "dit": remat_check(dev, "DiT-B/2", lambda r: SimpleDiT(
            **DIT, dtype="bfloat16", remat=r, device=dev),
            (DIT_TRAIN_BATCH, DIT_RES, DIT_RES, DIT_CH), 61)}
    torch.cuda.empty_cache()
    out["s5_scan"] = s5_scan_timing(dev)
    return out


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
    unet_state = random_state(Unet(**UNET, device="cpu"), 0)
    log("phase 3: full-width UNet, card against CPU")
    model_res = model_checks(dev, unet_state)
    model_res["wide_block"] = wide_block_check(dev, WIDE_LEVEL)
    # the wide kernels' path: UNET3D_LEVEL's block, its launches counted
    model_res["unet3d_block"] = wide_block_check(dev, UNET3D_LEVEL, UNET3D_BLOCK)
    torch.cuda.empty_cache()

    log(f"phase 4: DDIM-{STEPS} + CFG {GUIDANCE} at {RESOLUTION}x{RESOLUTION}, bf16")
    traj = main_path(dev, unet_state)
    log(f"trajectory: DDIM-{STEPS} CFG {GUIDANCE} {RESOLUTION}x{RESOLUTION} batch 1 bf16 "
        f"wall {traj['wall_s']:.3f} s ({traj['ms_per_forward']:.2f} ms per forward), "
        f"peak {traj['peak_mem_gib']:.2f} GiB on {smi}")
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

    torch.cuda.empty_cache()

    log(f"phase 8: every sampler, {STEPS} steps + CFG {GUIDANCE} at {RESOLUTION}x{RESOLUTION}, "
        f"bf16")
    t8 = time.perf_counter()
    samplers_res = sampler_paths(dev, unet_state)
    samplers_res["phase_s"] = time.perf_counter() - t8
    for request, r in samplers_res["requests"].items():
        log(f"sampler {request}: {r['model_calls']} calls, wall {r['wall_s']:.3f} s "
            f"({r['ms_per_call']:.2f} ms per call) on {smi}")
    del unet_state
    torch.cuda.empty_cache()

    log(f"phase 9: EDM DiffusionTrainer.train_step, batch {TRAIN_BATCH} at "
        f"{TRAIN_RES}x{TRAIN_RES}, bf16, {WARMUP} + {TIMED} steps")
    t9 = time.perf_counter()
    edm_train = edm_training_path(dev)
    edm_train["phase_s"] = time.perf_counter() - t9
    log(f"EDM training: batch {TRAIN_BATCH} {TRAIN_RES}x{TRAIN_RES} bf16 "
        f"{edm_train['ms_per_step']:.3f} ms per step, {edm_train['images_per_s']:.1f} images/s, "
        f"peak {edm_train['peak_mem_gib']:.2f} GiB on {smi}")

    torch.cuda.empty_cache()

    log(f"phase 10: the training CLI, batch {TRAIN_BATCH} at {TRAIN_RES}x{TRAIN_RES}, bf16, "
        f"{CLI_STEPS} steps, resume, a NaN batch, DDIM-{STEPS} + CFG from the checkpoint")
    t10 = time.perf_counter()
    cli = cli_path(dev, {**PER_FORWARD, **PER_BACKWARD})
    cli["phase_s"] = time.perf_counter() - t10
    log(f"CLI fit: batch {TRAIN_BATCH} {TRAIN_RES}x{TRAIN_RES} bf16 {cli['fit']['ms_per_step']:.3f} "
        f"ms per step, {cli['fit']['images_per_s']:.1f} images/s (phase 5's loop "
        f"{train['ms_per_step']:.3f} ms, {train['images_per_s']:.1f}), peak "
        f"{cli['fit']['peak_mem_gib']:.2f} GiB, checkpoint "
        f"{cli['fit']['checkpoint']['bytes'] / 2 ** 30:.3f} GiB held the loop "
        f"{cli['fit']['checkpoint']['blocked_s'] * 1e3:.1f} ms, written in "
        f"{cli['fit']['checkpoint']['write_s']:.3f} s; request wall {cli['serving']['wall_s']:.3f} s; "
        f"phase {cli['phase_s']:.1f} s on {smi}")

    torch.cuda.empty_cache()

    log(f"phase 11: every model family at full width: card against CPU, DDIM-{STEPS} + CFG "
        f"{GUIDANCE} in bf16, SimpleMMDiT and the hybrid SSM DiT's train steps, remat, the S5 "
        f"scan")
    t11 = time.perf_counter()
    families = family_paths(dev)
    families["phase_s"] = time.perf_counter() - t11
    for key, r in families["serving"].items():
        bd = r["breakdown"]
        log(f"family {key}: DDIM-{STEPS} CFG {GUIDANCE} batch 1 bf16 wall {r['wall_s']:.3f} s "
            f"({r['ms_per_forward']:.2f} ms per call), one call busy {bd['busy_ms']:.3f} ms as a "
            f"graph ({bd['idle_share']:.0%} idle) on {smi}")
    mm = families["mmdit_training"]
    log(f"SimpleMMDiT training: batch {DIT_TRAIN_BATCH} bf16 {mm['ms_per_step']:.3f} ms per "
        f"step, {mm['samples_per_s']:.1f} latents/s, peak {mm['peak_mem_gib']:.2f} GiB; phase 11 "
        f"{families['phase_s']:.1f} s on {smi}")

    torch.cuda.empty_cache()

    log(f"phase 12: the training CLI with train.py's options, batch {TRAIN_BATCH} at "
        f"{TRAIN_RES}x{TRAIN_RES}, float16 with the loss scale, MultiSteps({CLI12_ACCUM}) over "
        f"lamb, {CLI12_STEPS} micro-steps, resume at {CLI12_RESUME_AT}, a NaN batch; the f32 "
        f"chain card against CPU; the f16 forward against f32")
    t12 = time.perf_counter()
    options = options_path(dev, {**PER_FORWARD, **PER_BACKWARD}, cli, train)
    unet_state = random_state(Unet(**UNET, device="cpu"), 0)
    options["chain_card_vs_cpu"] = chain_card_vs_cpu(dev, unet_state)
    options["f16_forward"] = f16_forward_check(dev, unet_state)
    del unet_state
    options["phase_s"] = time.perf_counter() - t12
    of = options["fit"]
    log(f"CLI fp16 options: batch {TRAIN_BATCH} {TRAIN_RES}x{TRAIN_RES} float16 "
        f"{of['loop_ms_per_micro_step']:.3f} ms per micro-step in a loop (phase 5's bf16 step "
        f"{of['phase5_ms_per_step']:.3f} ms), {of['ms_per_micro_step']:.3f} in fit (phase 10's "
        f"bf16 fit {of['phase10_ms_per_step']:.3f} ms), busy "
        f"{of.get('busy_ms', float('nan')):.3f} ms "
        f"({of.get('idle_share', float('nan')):.0%} idle), peak {of['peak_mem_gib']:.2f} GiB, "
        f"skipped micro-steps {of['skipped']}, final scale {of['scale'][-1]}, validation "
        f"{of['validation_wall_s']:.3f} s; phase {options['phase_s']:.1f} s on {smi}")

    paths = {"unet_serving": traj, "unet_training": train, "dit_serving": dit_traj,
             "dit_training": dit_train, "unet3d_block_320": model_res["unet3d_block"],
             "unet_samplers": samplers_res, "unet_edm_training": edm_train,
             "unet_cli": cli, "mmdit_training": families["mmdit_training"],
             "unet_cli_f16": options,
             **{f"{key}_serving": r for key, r in families["serving"].items()}}
    kernels, summary = [], []
    for kname in REPLACES:
        mine = [c for c in cases if c["name"] == kname]
        head = mine[0]
        by_path = {path: res["launches"][kname] for path, res in paths.items()}
        f16 = next(c for c in mine if c["dtype"] == "float16")
        kernel = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(by_path.values()),
            "max_abs_err": max(c["max_abs_err"] for c in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "launches_by_path": by_path, "shape": head["shape"], "dtype": head["dtype"],
            # the f16 case and the launches on the f16 path (phase 12)
            "f16": {k: f16[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "max_abs_err")}
            | {"launches": by_path["unet_cli_f16"]}}
        check(kernel["launches"] > 0, f"{kname} launched on a main path")
        summary.append(kernel)
        kernels.append({**kernel, "cases": mine})
    record = {"device": name, "nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
              "hgmma": hgmma,
              "kernels": kernels, "yardsticks": yardsticks,
              "model": model_res, "trajectory": traj, "training": train, "dit_model": dit_res,
              "dit_trajectory": dit_traj, "dit_training": dit_train,
              "samplers": samplers_res, "edm_training": edm_train, "cli": cli,
              "families": families, "options": options,
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
