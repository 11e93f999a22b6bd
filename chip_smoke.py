#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flaxdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Phases; any failure exits non-zero and prints no result line.
  1. Print the card's name and power limit; build the CUDA kernels from
     flaxdiff_tpu_torch/csrc with nvcc for sm_90a and the native library
     (packed-record reader, PNG unfilter) from flaxdiff_tpu_torch/native
     with g++; print each kernel's registers, the registers and spills of
     every wgmma instantiation and, where cuobjdump exists, their HGMMA
     (wgmma) and HMMA (mma.sync) counts.
     Fails if any kernel instantiation spills, if ptxas serialised a wgmma
     (warning C7520), or if one holds no HGMMA or any HMMA.
  2. Hold each of the eighteen kernels against its plain PyTorch version on
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
     limits, forward and backward, in bf16. The batch-invariant linear
     and convolution (bi_gemm, bi_conv: the served route's Dense and
     ConvLayer, fault C6) at phase 4's shapes, a ragged row count, element-
     wise loads, f16 and f32, against their plain versions run in f32, each
     case's route (gemm_route, conv_route: the wgmma tiles, mma.sync, FMA,
     the narrow f32 conv) printed; and, once for every route and dtype,
     each gives a sample the same bits at batch 16 as at batch 1-15
     (77-token rows) or 1, 2, 4 and 8 (32x32 images) and in three orders.
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
  8. Every sampler on phase 4's model, weights and inputs, 25 steps each:
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
     1, card against CPU within 1e-3 x max(1, max|ref|); (b) one DDIM-25 +
     CFG 3.0 request each in bf16, launches exactly the family's census x 26,
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
     gate counter, a validation grid (euler_ancestral-25 + CFG 3.0, 8
     samples) between its chunks of 20 and 12 micro-steps and a
     torch.profiler window, 32 micro-steps with saves every 10. The launch counters must
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
 13. Latent video diffusion: UNet3D at ModelScope text-to-video's widths
     (320/640/1280/1280, attention at the first three levels and the
     middle, 4 heads: head dims 80, 160 and 320, the last through the wide
     flash kernels) with random weights, a 77x1024 text context, over the
     SD VAE (the JAX defaults, random weights). (a) f32, card against CPU,
     on 4 frames of 16x16x4 latents: the forward, DDIM-2 + CFG, one latent
     train step's loss and gradients with the codec encoding 128x128 frames
     inside the step, the codec's encode mean and decode, and remat bit-equal
     to the plain forward in bf16; (b) DDIM-25 + CFG 3.0, batch 1, 16 frames
     of 32x32x4 in bf16, decoded to 16 x 256x256x3: the request's wall, ms
     per call, the decode's time, one call's busy and idle shares, and the
     launch counters at T2V_PER_FORWARD x 26; (c) 3 + 5 DiffusionTrainer
     train_steps at batch 2 clips of 16 x 256x256x3 pixels through the codec,
     bf16 over f32 params: losses finite, the kernels launched once per call
     per step, ms per step, clips/s, peak memory; (d) the CLI with
     --autoencoder sd_vae over a random full-width SD VAE saved as an npz:
     phase 10's UNet on 256x256 images, 5 steps and a save, then
     from_checkpoint(autoencoder=...) serving 2 prompts (DDIM-25) decoded to
     256x256.
     Phase 2 also holds the flash kernels at phase 13's attention shapes and
     at batch x heads above 65535 (fault C5: 131072 at head dim 32, 65600 at
     320).
  14. The training-free caches and the quality metrics. (a) f32, card
     against CPU: DiT-B/2 (phase 6's weights) under record, record_ref,
     reuse and spatial (split 2, keep 1/8: 32 of 256 tokens) within the
     forward limit, the selected tokens equal (the k-th score gap printed),
     DDIM-10 + CFG under CachePlan(refresh_every=3) and the composed default
     within 1e-2; in bf16 record bit-equal to the plain forward and a
     refresh_every=1 request to the uncached one; PSNR and SSIM of 16 pairs
     at 256x256 within 1e-4 relative; InceptionV3's features of 4 images
     grown from 256x256 and 4 shrunk from 512x512 within 1e-4 x max|ref|.
     (b) bf16 DDIM-25 + CFG 3.0 requests of DiT-B/2 at batch 4 under every
     plan of docs/CACHING.md's table, and of SimpleUDiT and SimpleMMDiT
     (phase 11's) uncached and under the composed default: wall, ms per
     call, device busy time (profiler sum) and idle share, the launches of
     flash, LayerNorm + modulate and gated residual exactly as the plan
     implies, the trajectory PSNR against the uncached request; the
     pipeline's diffcache counters; a cached and a composed trajectory
     under sync debug mode "error". (c) InceptionV3 at 299x299 for a batch
     of 32, FID of 64 noised against 64 real images with sqrtm's share, and
     the CLI on phase 10's UNet with --val_every 5 --val_metrics
     psnr,ssim,fid (10 steps): finite val/psnr, val/ssim and val/fid.
     Phase 2 also holds flash, LayerNorm + modulate and the gated residual
     at the spatial step's 32 tokens.
  15. The serving subsystem: phase 4's UNet (bf16, CFG 3.0) behind a
     DiffusionInferencePipeline with the hash encoder's 77x768 text input,
     served by ServingScheduler with prompted requests. (a) DDIM-25, DDIM-50
     and Euler-ancestral-50 batched in bucket 4 (rounds of 10 steps), and
     two multistep DPM requests admitted at different offsets, all on x0
     before the clip (random eps weights saturate the samples): each of the
     five alone in bucket 1 and batched in bucket 4 bit-equal to the solo
     generate_samples; one round under sync debug "error".
     (b) a seeded Poisson replay (32 requests at 8 Hz, buckets 1/2/4/8,
     max_inflight 2) twice after prewarm: latency p50/p99, requests/s,
     images/s, occupancy, program-cache hit rate, shed and backpressure
     counts; the second replay builds no program and launches PER_FORWARD x
     model calls (launches zeroed just before); one bucket-8 round's
     launched, wall and busy ms and idle share beside phase 4's. (c) (b)'s
     workload in (b)'s buckets under a FaultPlan (a round fault, a fetch
     fault, a device loss): every request completes bit-equal to its
     fault-free run and to its solo generate_samples (requeues move it to
     other buckets, positions and mates), every fault fires and is
     recovered; requeued, quarantined and rebuild counts. (d) two replicas behind the
     FrontDoor with serving.replica_lost killing one mid-replay: every
     future resolves, the failovers counted. (e) DiT-B/2 (phase 6's) under
     the composed default plan through the scheduler: a request bit-equal to
     itself alone in its bucket, its launches the plan's (phase 14's
     planned_launches), its distance to the solo call printed.
  16. The packed-shard data feed: 4 shards of 128 PNG images at phase 10's
     128x128, written by the port's write_image_dataset; the reader's
     decoded records/s on one host thread; phase 10's CLI run (40 steps)
     with --dataset packed_shards --dataset_path '<dir>/shard-*.rec', its
     images/s beside phase 10's, every loss finite, and a resume from step
     20 bit-equal to the uninterrupted run.
  17. The run's telemetry. (a) Phase 10's CLI run (UNet-text-128, batch 16,
     bf16) for 32 steps with --telemetry_dir, --telemetry_sample_every 4,
     --prometheus_textfile, --registry and --run_name, and one device-profile
     window of 4 steps opened through the trainer's profile_trigger: every
     file the JAX CLI writes is there and parses, scripts/diagnose_run.py
     --json exits 0 on the directory, productive plus badput lies within 5%
     of the fit's wall clock, MFU is reported against the card's peak and
     lies in (0, 1), the window's family sums equal its kernel total within
     1%, the train step has one program row whose FLOPs equal 16 x the same
     step's count at batch 1 on the CPU (flash's backward products included),
     every kernel ran once per call per step; prints ms per step beside phase 10's, the goodput fraction,
     the phase split, MFU, peak memory and the top families. (b) Phase 4's
     UNet-text-256 served by ServingScheduler under an enabled hub with the
     profiler armed for one round: DDIM-10 requests in buckets 4 and 1, one
     program row per cache miss, each request bit-equal to its solo call (x0
     before the clip); then a forced rebuild (serving.device_lost) dumps one
     incident bundle and every request stays bit-equal. (c) The KL
     autoencoder trainer at the JAX defaults' widths (64/128/256, latent 4,
     8 groups): f32 card against CPU on 2 images of 64x64 (loss 1e-5
     relative, every gradient 1e-3 of its max|g|), then 3 + 10 bf16 steps at
     batch 8 of 256x256: B4-B7 once per GroupNorm call per step, ms per
     step, images/s, peak memory.
  18. Data, FSDP and sequence parallelism on one card (at most 60 s).
     (a) Phase 10's CLI cell (UNet-text-128, batch 16, bf16) for 10 steps
     saving at 5, then the same with --mesh_data 1 --mesh_fsdp 1 --mesh_seq
     1 on a one-rank NCCL process group started here (the trainer's
     collectives run through NCCL), then a resume under the mesh from step
     5: every loss and the final params, EMA and both moments of the mesh
     run bit-equal to the run without it, the resume bit-equal to the
     uninterrupted mesh run, every kernel once per call per step; ms per
     step of both runs. (b) The ring's hop loop (parallel/ring_attention.py)
     with the in-process transport over 4 sequence shards, forward and
     backward, against one flash call over the whole sequence and its
     backward: UNet-text-256's level-2 self-attention [2, 4096, 8, 64] and
     UNet3D-T2V's level-0 spatial self-attention [32, 1024, 4, 80 -> 128],
     bf16, the output within flash's forward limits and the gradients within
     its backward limits times the hops (each hop's kernels round a partial
     gradient to bf16), lse within 1e-4; one f32 case [2, 1024, 8, 64]
     within 1e-5; device ms of the loop beside the single call; each flash
     kernel launched once per shard per hop. (c) Fault C7: phase 7's DiT-B/2
     train step with backend "ring" and "ulysses" under a one-rank mesh
     bit-equal to "auto" without one; phase 4's CFG call (UNet-text-256,
     bf16, inference mode) with "prebuilt" bit-equal to "xla" (with its
     warning), with "performer" finite.
     What one card cannot show: a ring or an FSDP step across ranks, NCCL
     between cards and its speed (the CPU tests hold gloo worlds of 4
     against the JAX package).
Every inference-mode path's launches include bi_gemm's and bi_conv's, one
per routed Dense and ConvLayer call (counted by a module pre-hook). Each
phase's seconds (phase_s) are printed before the kernels' line.
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
# phase 13's UNet3D (ModelScope T2V's widths, 4 heads) at its serving and
# training shapes, 32 frames of 32x32 latents a call or step: the spatial
# self and cross attention of level 2 (8x8 tokens, 320 wide) and the middle
# (4x4), and the temporal attention over 16 frames of level 2 (2 x 64
# sequences), level 0 (2 x 1024, 80 padded to 128) and level 1 (2 x 256, 160
# padded to 256)
T2V_FRAMES, T2V_TEXT = 32, 77
T2V_FLASH_CASES = [(2 * 1024, 16, 16, 4, 128, BF16), (2 * 256, 16, 16, 4, 256, BF16)]
T2V_WIDE_CASES = [(T2V_FRAMES, 64, 64, 4, 320, BF16), (T2V_FRAMES, 64, T2V_TEXT, 4, 320, BF16),
                  (T2V_FRAMES, 16, 16, 4, 320, BF16), (2 * 64, 16, 16, 4, 320, BF16)]
# fault C5: batch * heads past gridDim.y's 65535 (temporal attention over
# B*H*W sequences of 16 frames): the JAX default UNet3D's level 0 at 64x64,
# batch 8 (131072 at head dim 32), and 65600 at 320
C5_FLASH_CASES = [(32768, 16, 16, 4, 32, BF16)]
C5_WIDE_CASES = [(16400, 16, 16, 4, 320, BF16)]
# phase 14's spatial step: DiT-B/2's deep trunk on the 32 selected tokens of a
# CFG call at batch 4
CACHE_FLASH_CASES = [(2 * DIT_SERVE_BATCH, 32, 32, DIT_HEADS, 64, BF16)]
FLASH_FWD_CASES += T2V_FLASH_CASES + C5_FLASH_CASES + CACHE_FLASH_CASES
FLASH_BWD_CASES += T2V_FLASH_CASES + C5_FLASH_CASES
WIDE_FWD_CASES += T2V_WIDE_CASES + C5_WIDE_CASES
WIDE_BWD_CASES += T2V_WIDE_CASES + C5_WIDE_CASES
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
# phase 14's spatial step: the deep blocks on 32 of the 256 tokens
LN_MOD_CASES += [(_SB, 32, DIT_WIDTH, BF16, 1)]
LN_MOD_BWD_CASES = [(_TB, DIT_TOKENS, DIT_WIDTH, BF16, 1), (_TB, DIT_TOKENS, DIT_WIDTH, BF16, 2),
                    (_SB, DIT_TOKENS, DIT_WIDTH, F32, 2), (3, TEXT_LEN, DIT_WIDTH, BF16, 2),
                    (_TB, DIT_TOKENS, DIT_WIDTH, F16, 2)]
GATE_RES_CASES = [(_SB, DIT_TOKENS, DIT_WIDTH, BF16), (_TB, DIT_TOKENS, DIT_WIDTH, BF16),
                  (_SB, DIT_TOKENS, DIT_WIDTH, F32), (3, TEXT_LEN, DIT_WIDTH, BF16),
                  (_TB, DIT_TOKENS, DIT_WIDTH, F16), (_SB, 32, DIT_WIDTH, BF16)]
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
    # no TPU kernel: XLA's dot_general and conv under flax's nn.Dense and
    # nn.Conv (the ConvLayer), which the port's served route replaces with
    # batch-invariant kernels (fault C6)
    "bi_gemm": "none (XLA dot_general, nn.Dense at flaxdiff_tpu/models/common.py:80)",
    "bi_conv": "none (XLA conv, nn.Conv at flaxdiff_tpu/models/common.py:165)",
}
# the batch-invariant kernels: served paths only, no backward
BI_KERNELS = ("bi_gemm", "bi_conv")
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
                      gate_res=("gate_res_fwd_kernel",),
                      bi_gemm=("bi_gemm_wgmma_kernel", "bi_gemm_mma_kernel", "bi_gemm_fma_kernel"),
                      bi_conv=("bi_conv_wgmma_kernel", "bi_conv_mma_kernel", "bi_conv_narrow_kernel",
                               "bi_conv_fma_kernel"))
# the 16-bit paths that must run on wgmma (HGMMA in the built library)
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_split_wgmma_kernel",
                 "flash_fwd_wide_wgmma_kernel", "flash_bwd_dq_wide_wgmma_kernel",
                 "flash_bwd_dkv_wide_wgmma_kernel", "bi_gemm_wgmma_kernel", "bi_conv_wgmma_kernel")
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
    "bi_gemm": "flaxdiff_tpu_torch/csrc/bi_gemm.cu",
    "bi_conv": "flaxdiff_tpu_torch/csrc/bi_conv.cu",
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


# calls of the Dense and ConvLayer modules that take a batch-invariant kernel
# (under inference mode, on the card) since the last reset_counts(), counted
# by a forward pre-hook on every module that main() installs: the launches of
# bi_gemm and bi_conv each path must show. A call counts here, a launch in
# the wrapper, so equal counts show every routed call launched its kernel once.
ROUTE_CALLS = {name: 0 for name in BI_KERNELS}


def _route_hook(module, args):
    kernel = getattr(module, "batch_invariant_kernel", None)
    if kernel and torch.is_inference_mode_enabled() and args and args[0].is_cuda:
        ROUTE_CALLS[kernel] += 1


def install_route_census():
    return torch.nn.modules.module.register_module_forward_pre_hook(_route_hook)


def reset_counts() -> None:
    """Zero the kernels' launch counters and the routed calls."""
    from flaxdiff_tpu_torch.ops import reset_launch_counts
    reset_launch_counts()
    for name in ROUTE_CALLS:
        ROUTE_CALLS[name] = 0


def routed(expected: dict) -> dict:
    """`expected` launches with the batch-invariant kernels' from the routed
    calls counted since the last reset_counts()."""
    return {**expected, **ROUTE_CALLS}


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
    """'flash_fwd_wgmma_kernel bf16 D64 NC2' or 'bi_conv_wgmma_kernel bf16
    128x64' from a wgmma kernel's mangled name (template arguments: dtype
    and, where the kernel has them, head dim and consumer warpgroups, or the
    batch-invariant kernels' tile width under their 128 rows; the wide
    kernels take the dtype only)."""
    m = re.search("(" + "|".join(WGMMA_KERNELS) + r")I(6__half|13__nv_bfloat16)(?:Li(\d+)E)?"
                  r"(?:Li(\d+)E)?", mangled)
    if not m:
        return mangled
    dtype = "f16" if m.group(2) == "6__half" else "bf16"
    if m.group(1).startswith("bi_"):
        return f"{m.group(1)} {dtype} 128x{m.group(3)}"
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
                                                   rows_per_block, stats_rows_per_block)
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
        # 20 calls a graph, 3 where one call takes a tenth of a millisecond or
        # more (C5's cases: their library backward takes ~64 ms a call)
        calls = 20 if b_ms < 0.1 else 3
        ms = graph_ms(call, calls)
        plain_ms = graph_ms(plain, 3, replays=3)
        library_ms = graph_ms(library, calls) if library is not None else None
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
        return case

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
        rows, bwd_rows = stats_rows_per_block(hw, c), rows_per_block(b, hw, c)
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
        gs_ref, cs_ref = groupnorm_bwd_stats_plain(x, g, mean, rstd, scale, bias, True, bwd_rows)
        bwd_nblk = -(-hw // bwd_rows)
        torch.cuda.synchronize()
        # f32 sums of up to 1024 rows a channel and block, in another order:
        # up to 1.4e-7 of the largest sum per element and 1.8e-7 RMS on an
        # H100
        read = lambda o, r: compare(o, r, atol=1e-6 * float(r.abs().max()), rtol=1e-5,
                                    rms_rel=1e-6)
        record("gn_bwd_stats", (b, hw, c), dtype,
               {"group_sums": read(gs, gs_ref), "channel_sums": read(cs, cs_ref)},
               lambda: groupnorm_bwd_stats(x, g, mean, rstd, scale, bias, True),
               lambda: groupnorm_bwd_stats_plain(x, g, mean, rstd, scale, bias, True,
                                                 bwd_rows),
               16.0 * n, 2 * esz * n + 8 * b * 8 + 8 * c + 4 * b * bwd_nblk * 2 * (8 + c))
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
    bi_cases(randn, gen, record)
    return cases, yardsticks


def dispatch_check(randn) -> None:
    """The attention dispatch at WIDE_LEVEL's head dim (160, padded to 256),
    cross-attention to the text in bf16: forward and dq, dk, dv against the
    plain versions at the true head dim, under the flash bf16 limits, with
    one launch of each flash kernel."""
    from flaxdiff_tpu_torch.ops import dot_product_attention, launch_counts
    from flaxdiff_tpu_torch.ops.flash_attention import (flash_bwd_dkv_plain, flash_bwd_dq_plain,
                                                        flash_delta, flash_fwd_plain)
    b, heads, d, lq = SERVE_BATCH, WIDE_LEVEL["heads"], WIDE_LEVEL["dim_head"], WIDE_LEVEL["side"] ** 2
    q = randn(b, lq, heads, d, dtype=BF16).requires_grad_()
    k, v = (randn(b, TEXT_LEN, heads, d, dtype=BF16).requires_grad_() for _ in range(2))
    do = randn(b, lq, heads, d, dtype=BF16)
    reset_counts()
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


# the batch-invariant kernels at phase 4's shapes (a CFG call, batch 2, at
# 256^2): bi_gemm (batch, rows a sample, K, N, dtype): level 2's GEGLU input
# (4096 tokens), its q/k/v projection and feed-forward output, level 3's
# GEGLU input (1024), the text's keys and values (77 rows, ragged), the time
# embedding (1 row) and its projection at level 0 (64 outputs: half of a
# 128-column tile) in bf16 and f16, DiT-B/2's MLP input (phase 6: 8 x 256
# tokens), a K that is no multiple of 8 (the element-wise loads), f16 and f32
BI_GEMM_CASES = [(2, 4096, 256, 2048, BF16), (2, 4096, 256, 512, BF16),
                 (2, 4096, 1024, 256, BF16), (2, 1024, 512, 4096, BF16),
                 (2, TEXT_LEN, TEXT_DIM, 512, BF16), (2, 1, 512, 512, BF16),
                 (2, 1, 512, 64, BF16), (2, 1, 512, 64, F16),
                 (2 * DIT_SERVE_BATCH, DIT_TOKENS, DIT_WIDTH, 4 * DIT_WIDTH, BF16),
                 (3, 111, 100, 70, BF16), (2, 4096, 256, 2048, F16), (2, 1024, 512, 512, F32)]
# bi_conv (batch, side, Cin, Cout, kernel, stride, padding, dtype): the UNet's
# 3x3 convs at levels 0-3, conv_in (3 channels: element-wise loads), the
# stride-2 downsample (SAME pads 0 low, 1 high), a 1x1 skip, conv_out in f32
# (the narrow kernel), levels 2 and 3 in f16, and DiT-B/2's patch embedding
# (2x2 at stride 2, VALID)
BI_CONV_CASES = [(2, 256, 64, 64, 3, 1, "SAME", BF16), (2, 128, 128, 128, 3, 1, "SAME", BF16),
                 (2, 64, 256, 256, 3, 1, "SAME", BF16), (2, 32, 512, 512, 3, 1, "SAME", BF16),
                 (2, 256, 3, 64, 3, 1, "SAME", BF16), (2, 256, 64, 64, 3, 2, "SAME", BF16),
                 (2, 128, 64, 128, 1, 1, "SAME", BF16), (2, 256, 64, 3, 3, 1, "SAME", F32),
                 (2, 64, 256, 256, 3, 1, "SAME", F16), (2, 32, 512, 512, 3, 1, "SAME", F16),
                 (2 * DIT_SERVE_BATCH, DIT_RES, DIT_CH, DIT_WIDTH, 2, 2, "VALID", BF16)]
BI_ORDERS = 16   # the per-sample bit check's largest batch


def bi_reading(out, x, w, b, plain) -> dict:
    """The kernel against its plain version run in f32 on the same inputs
    (TF32 off) and rounded to the output's dtype: the kernel sums in f32 in
    another order, then rounds once, so a 16-bit output is at most one ulp
    off (rtol), beside a few f32 ulps of the sum (atol, of max|ref|). The
    16-bit library calls are no yardstick here: cuDNN's 3x3 algorithms
    (Winograd transforms) read 2 bf16 ulps off the f32 result."""
    ref = plain(x.float(), w.float(), None if b is None else b.float()).to(out.dtype)
    scale = float(ref.float().abs().max())
    if out.dtype in HALF_RTOL:
        return compare(out, ref, atol=1e-4 * scale, rtol=HALF_RTOL[out.dtype],
                       rms_rel=1e-2 * HALF_SCALE[out.dtype])
    return compare(out, ref, atol=1e-5 * scale, rtol=1e-5, rms_rel=1e-5)


def bi_same_bits(op, x, what: str, batches=(1, 2, 4, 8)) -> dict:
    """Each sample of `x` [16, ...] through `op` gives the same bits at each
    of `batches` as at 16, and at 16 in three other orders."""
    gen = torch.Generator(device=x.device).manual_seed(16)
    ref = op(x)
    n = x.shape[0]
    orders = {"reversed": torch.arange(n - 1, -1, -1, device=x.device),
              "halves swapped": torch.cat([torch.arange(n // 2, n), torch.arange(n // 2)]).to(x.device),
              "shuffled": torch.randperm(n, generator=gen, device=x.device)}
    moved = {f"batch {b}": int((op(x[:b]) != ref[:b]).flatten(1).any(1).sum()) for b in batches}
    moved.update({order: int((op(x[perm]) != ref[perm]).flatten(1).any(1).sum())
                  for order, perm in orders.items()})
    torch.cuda.synchronize()
    log(f"  {what}: samples whose bits moved {moved}")
    check(not any(moved.values()), f"{what}: a sample's bits follow its batch: {moved}")
    return moved


def bi_cases(randn, gen, record):
    """The batch-invariant linear and convolution against their plain
    versions (one library call per sample), timed beside one library call
    over the whole batch, with the route each case takes (gemm_route,
    conv_route), and each sample's bits across batch sizes and orders once
    for every route and dtype (bf16, f16, f32): the linear's 77-token rows at
    batch 1-15, the convolution's 32x32 images at batch 1, 2, 4 and 8."""
    import torch.nn.functional as F

    from flaxdiff_tpu_torch.ops.batch_invariant import (ROUTES, bi_conv2d, bi_conv2d_plain,
                                                        bi_linear, bi_linear_plain, conv_output_size,
                                                        conv_route, gemm_route)
    dname = lambda dtype: str(dtype).replace("torch.", "")
    checked = set()
    for batch, tokens, k, n, dtype in BI_GEMM_CASES:
        x = randn(batch, tokens, k, dtype=dtype)
        w = randn(n, k, dtype=dtype) * k ** -0.5
        b = randn(n, dtype=dtype)
        route = ROUTES[gemm_route(n, k, dtype)]
        log(f"  bi_gemm [{batch},{tokens},{k}]x[{k},{n}] {dname(dtype)}: route {route}")
        out = bi_linear(x, w, b)
        reading = bi_reading(out, x, w, b, bi_linear_plain)
        torch.cuda.synchronize()
        esz, rows = x.element_size(), batch * tokens
        record("bi_gemm", (batch, tokens, k, n), dtype, {"out": reading},
               lambda: bi_linear(x, w, b), lambda: bi_linear_plain(x, w, b),
               2.0 * rows * k * n, esz * (rows * k + n * k + rows * n + n),
               library=lambda: F.linear(x, w, b))["route"] = route
        # a column tile that N fills only in part (the time embedding's
        # 64 outputs) gets a bit check of its own
        key = ("bi_gemm", dtype, route, n % 128 == 0)
        if key not in checked:
            checked.add(key)
            xs = randn(BI_ORDERS, 77, k, dtype=dtype)
            bi_same_bits(lambda t: bi_linear(t, w, b), xs,
                         f"bi_gemm [{BI_ORDERS},77,{k}]x[{k},{n}] {dname(dtype)} {route}",
                         batches=range(1, BI_ORDERS))
        del x, w, b, out
    for batch, side, cin, cout, ksz, stride, pad, dtype in BI_CONV_CASES:
        x = randn(batch, side, side, cin, dtype=dtype)
        w = randn(cout, cin, ksz, ksz, dtype=dtype) * (cin * ksz * ksz) ** -0.5
        w = w.contiguous(memory_format=torch.channels_last)
        b = randn(cout, dtype=dtype)
        if pad == "SAME":
            total = max((-(-side // stride) - 1) * stride + ksz - side, 0)
            p = (total // 2, total - total // 2)
        else:
            p = (0, 0)
        pads, strides = (p, p), (stride, stride)
        route = ROUTES[conv_route(cin, cout, ksz, ksz, strides, dtype)]
        log(f"  bi_conv [{batch},{side}^2,{cin}->{cout}] {ksz}x{ksz}/{stride} {dname(dtype)}: "
            f"route {route}")
        out = bi_conv2d(x, w, b, strides, pads)
        reading = bi_reading(out, x, w, b, lambda *t: bi_conv2d_plain(*t, strides, pads))
        torch.cuda.synchronize()
        o = conv_output_size(side, ksz, stride, p)
        esz = x.element_size()
        library = None
        if p[0] == p[1]:
            xc = x.permute(0, 3, 1, 2)
            library = lambda: F.conv2d(xc, w, b, stride=strides, padding=p[0])
        record("bi_conv", (batch, side, side, cin, cout, ksz, stride), dtype,
               {"out": reading}, lambda: bi_conv2d(x, w, b, strides, pads),
               lambda: bi_conv2d_plain(x, w, b, strides, pads),
               2.0 * batch * o * o * cout * cin * ksz * ksz,
               esz * (x.numel() + w.numel() + batch * o * o * cout + cout),
               library=library)["route"] = route
        if ("bi_conv", dtype, route) not in checked:
            checked.add(("bi_conv", dtype, route))
            xs = randn(BI_ORDERS, 32, 32, cin, dtype=dtype)
            bi_same_bits(lambda t: bi_conv2d(t, w, b, strides, pads), xs,
                         f"bi_conv [{BI_ORDERS},32,32,{cin}] -> {cout}, {ksz}x{ksz}/{stride} "
                         f"{dname(dtype)} {route}")
        del x, w, b, out


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
    from flaxdiff_tpu_torch.ops import launch_counts
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
        reset_counts()
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
        check(counts == routed(expected), f"the {w['heads']} x {w['dim_head']} block ran its kernels")
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


def step_check(dev, gpu, cpu, arrays, schedule, transform, zero_by_math, label, codecs=None):
    """Loss and every gradient of one training step, f32, the same weights
    and draws on the card and the CPU: loss within 1e-5 relative, each
    gradient within 1e-3 of its max|g|, the ones `zero_by_math` names below
    1e-6 of the model's largest. `codecs`: (card's, CPU's) latent codec, its
    posterior noise ``arrays["vae_noise"]``."""
    from flaxdiff_tpu_torch.trainer import TrainStepConfig, make_loss_builder

    results = []
    for i, (where, m) in enumerate(((dev, gpu), ("cpu", cpu))):
        a = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(where)
             for k, v in arrays.items()}
        build = make_loss_builder(schedule(1000, device=where),
                                  transform, TrainStepConfig(normalize=False),
                                  null_cond=torch.zeros(1, *a["cond"].shape[1:], device=where),
                                  autoencoder=None if codecs is None else codecs[i])
        loss = build({"sample": a["sample"], "cond": a["cond"]}, a["noise"], a["t"],
                     a["mask"], a.get("vae_noise"))(m)
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
    from flaxdiff_tpu_torch.ops import launch_counts
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
    reset_counts()
    t0 = time.perf_counter()
    out = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: PER_FORWARD.get(k, 0) * (STEPS + 1) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == routed(expected), "every attention, GEGLU and GroupNorm call ran its kernel")
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
    from flaxdiff_tpu_torch.ops import launch_counts
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
    reset_counts()
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
    check(counts == routed(expected), "every forward and backward kernel ran once per call per step")
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
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.trainer import Checkpointer

    root = tempfile.mkdtemp(prefix="flaxdiff_cli_")
    res = {}
    try:
        whole, resumed, poisoned = (os.path.join(root, n) for n in ("whole", "resumed", "poison"))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        hist = train.main(cli_args(whole, CLI_STEPS, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expected = {k: CLI_STEPS * per_step.get(k, 0) for k in counts}
        log(f"  launches {counts}, expected {expected}")
        check(counts == routed(expected), "every forward and backward kernel ran once per call per step")
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
        reset_counts()
        hist = train.main(cli_args(resumed, CLI_STEPS, dev))
        counts = launch_counts()
        half = CLI_STEPS - CLI_SAVE_EVERY
        check(counts == routed({k: half * per_step.get(k, 0) for k in counts}),
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
        reset_counts()
        t0 = time.perf_counter()
        out = request(STEPS)
        req_wall = time.perf_counter() - t0
        counts = launch_counts()
        check(counts == routed({k: PER_FORWARD.get(k, 0) * (STEPS + 1) for k in counts}),
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
# 16-slot loss ring, the gate counter, a validation grid (euler_ancestral-25
# + CFG) between the chunks of 20 and 12 steps, and a profiler window; saves
# every 10 steps, so the resume can start at 30, inside an accumulation
CLI12_STEPS, CLI12_SAVE_EVERY, CLI12_RESUME_AT, CLI12_ACCUM = 32, 10, 30, 4
CLI12_VAL_EVERY, CLI12_VAL_STEPS, CLI12_RING, CLI12_CADENCE = 20, 25, 16, 10
# the card-vs-CPU check of the same chain in f32 (phase 3's UNet at 32x32,
# batch 2): MultiSteps(2) over lamb with the scale growing every 2 finite
# steps, a NaN batch at step 4 of 4
CHAIN_STEPS, CHAIN_NAN_AT, CHAIN_RES = 4, 3, 32


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
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.trainer import Checkpointer

    root = tempfile.mkdtemp(prefix="flaxdiff_cli12_")
    res = {}
    try:
        whole, resumed, poisoned = (os.path.join(root, n) for n in ("whole", "resumed", "poison"))
        trajectory, runs = [], []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with recorded_scale(trajectory, runs):
            hist = train.main(cli12_args(whole, dev, os.path.join(root, "profile")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        # one validation grid at step 20: euler_ancestral-25 calls the model
        # CLI12_VAL_STEPS + 1 times, as phase 8 counts it
        expected = {k: CLI12_STEPS * per_step.get(k, 0)
                    + (CLI12_VAL_STEPS + 1) * PER_FORWARD.get(k, 0) for k in counts}
        log(f"  launches {counts}, expected {expected}")
        check(counts == routed(expected), "every f16 forward and backward kernel ran once per call per "
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
        # the ring is read every 16 micro-steps of a chunk and at its end
        windows = [s for a, b in ((0, CLI12_VAL_EVERY), (CLI12_VAL_EVERY, CLI12_STEPS))
                   for s in range(a + CLI12_RING, b, CLI12_RING)] + [CLI12_VAL_EVERY, CLI12_STEPS]
        check(hist["steps"] == sorted(windows), f"ring windows {hist['steps']}")
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
        reset_counts()
        hist = train.main(cli12_args(resumed, dev, os.path.join(root, "profile_resumed")))
        rest = CLI12_STEPS - CLI12_RESUME_AT
        check(launch_counts() == routed({k: rest * per_step.get(k, 0) for k in counts}),
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
# 25 steps a request (once 50): a call's time and launches do not
# depend on the count, and the script must stay inside two thirds of its limit
SAMPLER_STEPS = 25


def sampler_paths(dev, state):
    """Every sampler at phase 4's full width (bf16, batch 1, CFG 3.0, the
    77x768 text), one SAMPLER_STEPS-step request each, the launch counters
    zeroed just before each and read just after: PER_FORWARD x its model calls (steps x
    calls a step + the terminal one). The inpainting request generates the
    left half and keeps the right half of a reference, exactly."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.ops import launch_counts
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
        calls = SAMPLER_STEPS * CALLS_PER_STEP.get(name, 1) + 1
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = sampler.generate_samples(num_samples=1, resolution=RESOLUTION,
                                       diffusion_steps=SAMPLER_STEPS, generator=make_generator(9, dev),
                                       conditioning=cond, unconditional=uncond, **inpaint)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expected = {k: PER_FORWARD.get(k, 0) * calls for k in counts}
        check(counts == routed(expected), f"{request}: launches {counts}, expected {expected}")
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
    from flaxdiff_tpu_torch.ops import launch_counts
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
    reset_counts()
    t0 = time.perf_counter()
    out = run(STEPS, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: DIT_PER_FORWARD.get(k, 0) * (STEPS + 1) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == routed(expected), "every LayerNorm + modulate, gated residual and attention call "
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
# phase 11's requests: 25 steps (once 50), as phase 8's; a call's time and
# launches do not depend on the count
STEPS11 = 25
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
    """(b) One DDIM-25 + CFG 3.0 request in bf16, batch 1 with the 77x768
    text and a zeros null context; the launch counters, zeroed just before,
    must read the family's per-call census x 26. Then one CFG call as
    launched from Python beside its busy time as a CUDA graph."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.ops import launch_counts
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
    reset_counts()
    t0 = time.perf_counter()
    out = run(STEPS11, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: per_forward.get(k, 0) * (STEPS11 + 1) for k in counts}
    check(counts == routed(expected), f"{key}: launches {counts}, expected {expected}")
    check(tuple(out.shape) == (1, side, side, ch), f"{key}: output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{key}: samples finite")
    check(float(out.abs().max()) <= 1.0, f"{key}: samples clipped to [-1, 1]")
    res = {"wall_s": wall, "forwards": STEPS11 + 1, "ms_per_forward": wall * 1e3 / (STEPS11 + 1),
           "launches_per_call": {k: v // (STEPS11 + 1) for k, v in counts.items() if v},
           "launches": counts}
    x = torch.randn(2, side, side, ch, device=dev)
    ctx = torch.cat([cond, uncond]).to(dev)
    res["breakdown"] = forward_breakdown(lambda: model(x, torch.full((2,), 500.0, device=dev), ctx),
                                         f"{key}, batch 2 of {side}x{side}x{ch}")
    log(f"  {key}: DDIM-{STEPS11} + CFG wall {wall:.3f} s ({res['ms_per_forward']:.2f} ms per "
        f"call), launches per call {res['launches_per_call']}")
    del model
    return res


def remat_check(dev, label: str, make, shape, seed: int, state=None,
                ctx_shape=(TEXT_LEN, TEXT_DIM)) -> dict:
    """(d) One bf16 forward and backward with remat=True against
    remat=False, the same weights (`state`, or drawn from `seed`) and inputs:
    the output and every gradient bit-equal. The plain model runs twice
    first: a difference there would be the card's own nondeterminism, not
    remat's (cuDNN's deterministic algorithms are asked for during the
    check)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(0, 999, shape[0]).astype(np.float32)).to(dev)
    ctx = torch.from_numpy(rng.standard_normal((shape[0], *ctx_shape))
                           .astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    results = []
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


# --- phase 13: latent video diffusion, UNet3D at ModelScope T2V's widths ------------

# ModelScope text-to-video (damo-vilab/text-to-video-ms-1.7b, unet/config.json):
# block_out_channels (320, 640, 1280, 1280) with three CrossAttnDownBlock3D and
# a DownBlock3D, 2 layers a block, 32 groups, a time embedding of 4 x 320 and
# cross-attention 1024 wide; heads: the JAX UNet3D's one count, 4 (head dims
# 80, 160, 320, 320). Clips of 16 frames of 32x32x4 latents (256x256 video
# through the SD VAE at the JAX defaults), a random 77x1024 text context
T2V = dict(output_channels=4, emb_features=1280, feature_depths=(320, 640, 1280, 1280),
           attention_levels=(True, True, True, False), num_res_blocks=2, norm_groups=32,
           heads=4, in_channels=4, context_dim=1024)
T2V_CTX = (77, 1024)
T2V_FRAMES, T2V_SIDE, T2V_PIXELS = 16, 32, 256
T2V_TRAIN_BATCH, T2V_WARMUP, T2V_TIMED = 2, 3, 5
# 13a's trajectory, card against CPU (the CPU side is most of its time)
T2V_CHECK_STEPS = 2
# 13b's and 13d's requests: DDIM-25 (phase 4's DDIM-50 at half the depth)
STEPS13 = 25
# launches of one forward: 21 level blocks (8 down, the middle, 12 up) of two
# GroupNorm + SiLU each; 16 of them attend (levels 0-2 and the middle): self,
# cross and temporal attention and a GEGLU each, levels 0 and 1 through the
# flash kernels (head dims 80 and 160 padded), level 2 and the middle through
# the wide ones (320); one backward launches each backward kernel as often
T2V_PER_FORWARD = {"flash_fwd": 30, "flash_fwd_wide": 18, "geglu": 16, "gn_stats": 42,
                   "gn_norm": 42}
T2V_PER_BACKWARD = {"flash_bwd_dq": 30, "flash_bwd_dkv": 30, "flash_bwd_dq_wide": 18,
                    "flash_bwd_dkv_wide": 18, "geglu_bwd": 16, "gn_bwd_stats": 42,
                    "gn_bwd_dx": 42}
# 13d: phase 10's UNet on the SD VAE's 32x32x4 latents of 256x256 images
CLI13_MODEL = {k: v for k, v in CLI_MODEL.items() if k not in ("in_channels", "output_channels")}
CLI13_STEPS, CLI13_BATCH = 5, 16


def t2v_state(seed: int) -> dict:
    """Random weights for T2V (as ``random_state``, drawn with a seeded torch
    generator: a billion numpy draws take minutes), the output conv at a
    tenth of that scale: the CFG-guided eps of random weights then stays near
    unit scale and a trajectory's x0 mostly inside the clip. The shapes come
    from a model on the meta device (no memory, no init)."""
    from flaxdiff_tpu_torch.inference import build_model

    gen = torch.Generator().manual_seed(seed)
    state = {}
    for name, t in build_model("unet_3d", device="meta", **T2V).state_dict().items():
        shape = tuple(t.shape)
        a = torch.randn(shape, generator=gen)
        if name.endswith("freqs"):
            a *= 16.0
        elif name.endswith("weight") and len(shape) >= 2:
            a /= math.sqrt(int(np.prod(shape[1:])))
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * a
        else:
            a *= 0.1
        state[name] = a * 0.1 if name.startswith("conv_out.") else a
    return state


def t2v_model(where, state: dict, dtype=None, **extra):
    """T2V through the registry on `where` with `state`'s weights, built on
    the meta device and given the weights' tensors (no init)."""
    from flaxdiff_tpu_torch.inference import build_model

    model = build_model("unet_3d", device="meta", dtype=dtype, **T2V, **extra)
    model.load_state_dict({k: v.to(where) for k, v in state.items()}, assign=True)
    return model


def sd_vae(where, seed: int = 5, dtype=None):
    """The SD VAE at the JAX defaults with random weights from a seed."""
    from flaxdiff_tpu_torch.models import SDVAE
    return SDVAE.create(seed, dtype=dtype, device=where)


def t2v_card_vs_cpu(dev, state: dict) -> dict:
    """13a: T2V and the SD VAE in f32, card (kernels) against CPU (plain
    versions), the same weights, inputs and draws, on 4 frames of 16x16x4
    latents (128x128 pixels): the forward, a DDIM-2 + CFG trajectory from
    t = 333, one latent train step's loss and gradients (the codec encoding
    inside the step), the codec's encode mean and decode; then remat=True
    bit-equal to remat=False in bf16 on the card."""
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    rng = np.random.default_rng(70)
    frames, side = 4, 16
    gpu, cpu = t2v_model(dev, state).eval(), t2v_model("cpu", state).eval()
    x = rng.standard_normal((1, frames, side, side, 4)).astype(np.float32)
    t = np.array([611.0], np.float32)
    ctx = rng.standard_normal((1, *T2V_CTX)).astype(np.float32)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(*map(torch.from_numpy, (x, t, ctx)))
        cpu_s = time.perf_counter() - t0
        out = gpu(*(torch.from_numpy(a).to(dev) for a in (x, t, ctx))).cpu()
    scale, err = max(1.0, float(ref.abs().max())), max_err(out, ref)
    log(f"  forward [1, {frames}, {side}, {side}, 4] f32: max|ref| {scale:.3g}, max err "
        f"{err:.3g} (CPU forward {cpu_s:.1f} s)")
    check(bool(torch.isfinite(out).all()), "T2V forward output finite")
    check(err <= 1e-3 * scale, f"T2V forward: error {err} above {1e-3 * scale}")
    res = {"forward_f32_err": err, "forward_f32_scale": scale, "cpu_forward_s": cpu_s}
    res["ddim"] = trajectory_check(((dev, gpu), ("cpu", cpu)),
                                   f"DDIM-{T2V_CHECK_STEPS} + CFG [1, {frames}, {side}, {side}, 4] "
                                   "f32 from t=333", CosineNoiseSchedule,
                                   EpsilonPredictionTransform(), DDIMSampler(), T2V_CHECK_STEPS,
                                   init_samples=x, cond=ctx, start_step=333.0)

    codecs = (sd_vae(dev), sd_vae("cpu"))
    pixels = rng.uniform(-1, 1, (1, frames, 8 * side, 8 * side, 3)).astype(np.float32)
    arrays = {"sample": pixels, "cond": ctx, "noise": rng.standard_normal(x.shape),
              "t": np.array([433], np.int32), "mask": np.array([False]),
              "vae_noise": rng.standard_normal((frames, side, side, 4))}
    # the key biases of the spatial attention get no gradient by the math
    # (softmax ignores a shift shared by a row's logits); the temporal ones
    # rotate by RoPE first and get one
    zero = lambda name: name.endswith("to_k.bias") and "spatial_attn" in name
    res["latent_train_step"] = step_check(
        dev, gpu, cpu, arrays, CosineNoiseSchedule, EpsilonPredictionTransform(), zero,
        f"latent train step, SD VAE encoding [1, {frames}, {8 * side}, {8 * side}, 3], f32",
        codecs=codecs)
    del gpu, cpu
    torch.cuda.empty_cache()

    with torch.inference_mode():
        outs = [(c.encode(torch.from_numpy(pixels).to(where)).cpu(),
                 c.decode(torch.from_numpy(x).to(where)).cpu())
                for where, c in ((dev, codecs[0]), ("cpu", codecs[1]))]
    res["sd_vae"] = {}
    for i, what in enumerate(("encode mean", "decode")):
        out, ref = outs[0][i], outs[1][i]
        scale, err = max(1.0, float(ref.abs().max())), max_err(out, ref)
        log(f"  SD VAE {what} {tuple(ref.shape)} f32: max|ref| {scale:.3g}, max err {err:.3g}")
        check(bool(torch.isfinite(out).all()) and err <= 1e-3 * scale,
              f"SD VAE {what}: error {err} above {1e-3 * scale}")
        res["sd_vae"][what.replace(" ", "_")] = {"err": err, "scale": scale}
    del codecs
    torch.cuda.empty_cache()

    res["remat"] = remat_check(dev, "T2V UNet3D", lambda r: t2v_model(dev, state, "bfloat16",
                                                                      remat=r),
                               x.shape, 71, state=state, ctx_shape=T2V_CTX)
    return res


def t2v_serving(dev, state: dict) -> dict:
    """13b: DDIM-25 + CFG 3.0, batch 1, a clip of 16 frames of 32x32x4
    latents in bf16, decoded by the SD VAE to 16 x 256x256x3; the launch
    counters, zeroed just before, must read T2V_PER_FORWARD x 26 (the codec
    is plain PyTorch). Then the decode alone, and one CFG call as launched
    beside its busy time as a CUDA graph."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule

    model = t2v_model(dev, state, "bfloat16").eval()
    codec = sd_vae(dev, dtype="bfloat16")
    sampler = DiffusionSampler(lambda x, t, c: model(x, t, c), CosineNoiseSchedule(1000),
                               EpsilonPredictionTransform(), DDIMSampler(),
                               guidance_scale=GUIDANCE, device=dev, autoencoder=codec)
    rng = np.random.default_rng(72)
    cond = torch.from_numpy(rng.standard_normal((1, *T2V_CTX)).astype(np.float32))
    uncond = torch.zeros(1, *T2V_CTX)
    run = lambda steps, seed: sampler.generate_samples(
        num_samples=1, resolution=T2V_PIXELS, sequence_length=T2V_FRAMES,
        diffusion_steps=steps, generator=make_generator(seed, dev), conditioning=cond,
        unconditional=uncond)
    run(2, 0)                      # warm-up: GEMM and conv algorithm choice, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run(STEPS13, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    expected = {k: T2V_PER_FORWARD.get(k, 0) * (STEPS13 + 1) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == routed(expected), "every attention, GEGLU and GroupNorm call of T2V ran its kernel")
    shape = (1, T2V_FRAMES, T2V_PIXELS, T2V_PIXELS, 3)
    check(tuple(out.shape) == shape, f"decoded clip {tuple(out.shape)}, want {shape}")
    check(bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0,
          "decoded frames finite, in [-1, 1]")
    latents = torch.randn(1, T2V_FRAMES, T2V_SIDE, T2V_SIDE, 4, device=dev)
    with torch.inference_mode():
        decode_ms = time_ms(lambda: codec.decode(latents), 3)
    res = {"wall_s": wall, "forwards": STEPS13 + 1, "ms_per_forward": wall * 1e3 / (STEPS13 + 1),
           "decode_ms": decode_ms, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_call": {k: v // (STEPS13 + 1) for k, v in counts.items() if v},
           "launches": counts, "sample_std": float(out.float().std())}
    x = torch.randn(2, T2V_FRAMES, T2V_SIDE, T2V_SIDE, 4, device=dev)
    ctx = torch.cat([cond, uncond]).to(dev)
    res["breakdown"] = forward_breakdown(
        lambda: model(x, torch.full((2,), 500.0, device=dev), ctx),
        f"2 clips of {T2V_FRAMES} x {T2V_SIDE}x{T2V_SIDE}x4")
    log(f"  request wall {wall:.3f} s ({res['ms_per_forward']:.2f} ms per call), the decode "
        f"{decode_ms:.3f} ms; wide flash per call: fwd {res['launches_per_call'].get('flash_fwd_wide', 0)}")
    del model, codec, sampler
    return res


def t2v_training(dev) -> dict:
    """13c: DiffusionTrainer.train_step on T2V from the port's own init with
    the SD VAE (bf16) encoding inside the step: T2V_TRAIN_BATCH clips of 16 x
    256x256x3 seeded uint8 pixels, bf16 over f32 params, AdamW 1e-4, EMA
    0.999, CFG dropout 0.12 to a zeros context; 3 warm-up and 10 timed steps.
    Every loss finite; the launch counters, zeroed just before, read the
    forward and backward kernels once per call per step."""
    from flaxdiff_tpu_torch.inference import build_model
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer, TrainerConfig

    torch.manual_seed(0)           # the modules' own initializers
    model = build_model("unet_3d", device=dev, dtype="bfloat16", **T2V)
    trainer = DiffusionTrainer(
        model, AdamW(TRAIN_LR), CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
        TrainerConfig(uncond_prob=0.12, ema_decay=0.999, normalize=True, weighted_loss=True,
                      gate_nonfinite=True, seed=0),
        null_cond=torch.zeros(1, *T2V_CTX), device=dev,
        autoencoder=sd_vae(dev, dtype="bfloat16"))
    rng = np.random.default_rng(73)
    b = T2V_TRAIN_BATCH
    batches = [{"sample": torch.from_numpy(rng.integers(
                    0, 256, (b, T2V_FRAMES, T2V_PIXELS, T2V_PIXELS, 3), dtype=np.uint8)).to(dev),
                "cond": torch.from_numpy(rng.standard_normal((b, *T2V_CTX)).astype(
                    np.float32)).to(dev)} for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [trainer.train_step(batches[i % 4]) for i in range(T2V_WARMUP)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [trainer.train_step(batches[i % 4])
               for i in range(T2V_WARMUP, T2V_WARMUP + T2V_TIMED)]
    end.record()
    end.synchronize()
    counts = launch_counts()
    steps = T2V_WARMUP + T2V_TIMED
    per_step = {**T2V_PER_FORWARD, **T2V_PER_BACKWARD}
    expected = {k: steps * per_step.get(k, 0) for k in counts}
    log(f"  launches {counts}, expected {expected}")
    check(counts == routed(expected), "every forward and backward kernel ran once per call per step")
    losses = [float(x) for x in losses]
    log("  losses " + " ".join(f"{x:.5f}" for x in losses))
    check(all(math.isfinite(x) for x in losses), "every loss finite")
    ms = start.elapsed_time(end) / T2V_TIMED
    res = {"batch_clips": b, "ms_per_step": ms, "clips_per_s": b * 1e3 / ms,
           "frames_per_s": b * T2V_FRAMES * 1e3 / ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "params": trainer.state.params.numel(), "losses": losses, "launches": counts,
           "launches_per_step": {k: v // steps for k, v in counts.items() if v}}
    log(f"  {ms:.3f} ms per step (CUDA events over {T2V_TIMED} steps), {res['clips_per_s']:.2f} "
        f"clips/s, peak {res['peak_mem_gib']:.2f} GiB, {res['params']} params")
    res["breakdown"] = family_profile(lambda: trainer.train_step(batches[0]), training=True)
    by_family = res["breakdown"]["ms_by_family"]
    if by_family:
        res["busy_ms"] = sum(by_family.values())
        res["idle_share"] = 1.0 - res["busy_ms"] / ms
        log(f"  device busy {res['busy_ms']:.3f} ms of {ms:.3f} ms per step "
            f"({res['idle_share']:.0%} idle)")
    del trainer, model
    return res


def cli13_args(checkpoint_dir: str, npz: str, dev) -> list:
    codec = json.dumps({"npz": npz, "dtype": "bfloat16"})
    return ["--device", str(dev), "--dataset", "synthetic", "--text_encoder", "hash",
            "--image_size", str(T2V_PIXELS), "--batch_size", str(CLI13_BATCH),
            "--architecture", "unet", "--model_config", json.dumps(CLI13_MODEL),
            "--dtype", "bfloat16", "--optimizer", "adamw", "--lr", str(TRAIN_LR),
            "--warmup_steps", "5", "--total_steps", str(CLI13_STEPS), "--grad_clip", "1.0",
            "--save_every", str(CLI13_STEPS), "--log_every", "5", "--checkpoint_dir",
            checkpoint_dir, "--seed", "0", "--autoencoder", "sd_vae", "--autoencoder_opts", codec]


def cli13_path(dev) -> dict:
    """13d: the CLI with --autoencoder sd_vae over a random full-width SD VAE
    written as diffusers-named weights to an npz in a temporary directory
    (removed after): phase 10's UNet on 32x32x4 latents of 256x256 synthetic
    images, 5 steps and a save; then from_checkpoint(autoencoder=...) serves
    2 prompts, DDIM-25 + CFG, decoded to 256x256."""
    import tempfile

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.models import SDVAE
    from flaxdiff_tpu_torch.ops import launch_counts

    root = tempfile.mkdtemp(prefix="flaxdiff_cli13_")
    res = {}
    try:
        npz, run_dir = os.path.join(root, "sd_vae.npz"), os.path.join(root, "run")
        np.savez(npz, **{k: v.numpy() for k, v in sd_vae("cpu", seed=6).diffusers_state_dict()
                         .items()})
        reset_counts()
        t0 = time.perf_counter()
        hist = train.main(cli13_args(run_dir, npz, dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        per_step = {**PER_FORWARD, **PER_BACKWARD}
        check(counts == routed({k: CLI13_STEPS * per_step.get(k, 0) for k in counts}),
              f"the latent CLI run launched every kernel once per call per step: {counts}")
        log("  window losses " + " ".join(f"{x:.5f}" for x in hist["loss"]))
        check(all(math.isfinite(x) for x in hist["loss"]) and hist["checkpoint"]["step"] ==
              CLI13_STEPS, "every window loss finite, the last step saved")
        with open(os.path.join(run_dir, "pipeline_config.json")) as f:
            config = json.load(f)
        check(config["autoencoder"]["name"] == "sd_vae", "the config records the codec")
        res["fit"] = {"wall_s": wall, "losses": hist["loss"], "launches": counts,
                      "ms_per_step_last_window": CLI13_BATCH * 1e3 / hist["imgs_per_sec"][-1],
                      "autoencoder": config["autoencoder"]}
        pipe = DiffusionInferencePipeline.from_checkpoint(
            run_dir, device=dev, autoencoder=SDVAE.from_npz(npz, dtype="bfloat16", device=dev))
        request = lambda steps: pipe.generate_samples(
            resolution=T2V_PIXELS, diffusion_steps=steps, sampler="ddim",
            guidance_scale=GUIDANCE, prompts=CLI_PROMPTS, seed=1)
        request(2)
        reset_counts()
        t0 = time.perf_counter()
        out = request(STEPS13)
        req_wall = time.perf_counter() - t0
        serve_counts = launch_counts()
        check(serve_counts == routed({k: PER_FORWARD.get(k, 0) * (STEPS13 + 1) for k in serve_counts}),
              "the latent pipeline's request launched PER_FORWARD x 26 kernels")
        check(out.shape == (2, T2V_PIXELS, T2V_PIXELS, 3) and bool(np.isfinite(out).all())
              and float(np.abs(out).max()) <= 1.0, f"decoded samples {out.shape}, finite, in [-1, 1]")
        res["serving"] = {"wall_s": req_wall, "launches": serve_counts,
                          "ms_per_call": req_wall * 1e3 / (STEPS13 + 1)}
        res["launches"] = {k: counts[k] + serve_counts[k] for k in counts}
        log(f"  CLI: {CLI13_STEPS} steps in {wall:.2f} s with the build (last window "
            f"{res['fit']['ms_per_step_last_window']:.3f} ms per step); from_checkpoint: "
            f"DDIM-{STEPS13} CFG {GUIDANCE} for {CLI_PROMPTS} decoded to {T2V_PIXELS}x{T2V_PIXELS}: "
            f"wall {req_wall:.3f} s")
        del pipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def t2v_paths(dev) -> dict:
    """Phase 13 (see the module docstring)."""
    out = {}
    t0 = time.perf_counter()
    state = t2v_state(74)
    log(f"  T2V: {sum(v.numel() for k, v in state.items() if not k.endswith('freqs'))} "
        f"parameters, drawn in {time.perf_counter() - t0:.1f} s")
    out["card_vs_cpu"] = t2v_card_vs_cpu(dev, state)
    torch.cuda.empty_cache()
    log(f"  13b: DDIM-{STEPS13} + CFG {GUIDANCE}, batch 1, {T2V_FRAMES} frames of "
        f"{T2V_SIDE}x{T2V_SIDE}x4, bf16, SD VAE decode")
    out["serving"] = t2v_serving(dev, state)
    del state
    torch.cuda.empty_cache()
    log(f"  13c: DiffusionTrainer.train_step, {T2V_TRAIN_BATCH} clips of {T2V_FRAMES} x "
        f"{T2V_PIXELS}x{T2V_PIXELS}x3 through the SD VAE, bf16, {T2V_WARMUP} + {T2V_TIMED} steps")
    out["training"] = t2v_training(dev)
    torch.cuda.empty_cache()
    log(f"  13d: the CLI with --autoencoder sd_vae, {CLI13_STEPS} steps at {T2V_PIXELS}x"
        f"{T2V_PIXELS}, from_checkpoint decoded")
    out["cli"] = cli13_path(dev)
    return out


# --- phase 14: the training-free caches and the quality metrics ----------------------

# 14a's spatial keep on DiT-B/2: k = round(256 / 8) = 32 tokens through the deep trunk
CACHE_KEEP, CACHE_K = 0.125, 32
CACHE_TRAJ_STEPS = 10
# 14b's requests and 14c's validation: 25 steps (once 50); each plan's
# launches and counters are computed for the count
STEPS14 = 25
# 14c: Inception's timed batch, FID's sample counts, the CLI's run
INCEPTION_BATCH, FID_SAMPLES, FID_SIDE = 32, 64, 256
CLI14_STEPS, CLI14_VAL_EVERY, CLI14_VAL_STEPS = 10, 5, STEPS14
# the blocks of one call of each cached family (12 DiT blocks; the U-DiT's
# 6 downs, mid and 6 ups), its launches a block (an MMDiT block: one
# two-view LayerNorm + modulate) and the blocks a reuse call runs for each
# of the split's blocks (the flat trunk's shallow blocks; the U-DiT's outer
# downs and their ups)
CACHED_FAMILIES = {"simple_dit": (12, {"ln_mod": 2, "gate_res": 2, "flash_fwd": 1}, 1),
                   "simple_udit": (13, {"ln_mod": 2, "gate_res": 2, "flash_fwd": 1}, 2),
                   "simple_mmdit": (12, {"ln_mod": 1, "gate_res": 2, "flash_fwd": 1}, 1)}


def cache_plans14() -> dict:
    """docs/CACHING.md's table (bench.py:stage_diffcache's plans)."""
    from flaxdiff_tpu_torch.ops.diffcache import DEFAULT_CACHE_PLAN, CachePlan
    from flaxdiff_tpu_torch.ops.spatialcache import (DEFAULT_COMPOSED_PLAN, ComposedPlan,
                                                     SpatialPlan)
    edges = dict(depth_fraction=0.2, refresh_head=2, refresh_tail=1)
    return {"off": None,
            "conservative": CachePlan(refresh_every=2, depth_fraction=0.5),
            "default": DEFAULT_CACHE_PLAN,
            "aggressive": CachePlan(refresh_every=5, depth_fraction=0.2),
            "composed_conservative": ComposedPlan(CachePlan(refresh_every=6, **edges),
                                                  SpatialPlan(keep_fraction=0.25)),
            "composed_default": DEFAULT_COMPOSED_PLAN,
            "composed_aggressive": ComposedPlan(CachePlan(refresh_every=24, **edges),
                                                SpatialPlan(keep_fraction=0.125, every=3))}


def planned_launches(key: str, model, plan, steps: int) -> dict:
    """A request's launches as the plan implies them: every refresh and
    spatial step and the terminal call run all of the family's blocks (a
    spatial step's deep blocks on k tokens), a reuse step the blocks of its
    split."""
    from flaxdiff_tpu_torch.ops.spatialcache import CODE_REUSE, ComposedPlan, resolve_plan
    blocks, per_block, per_split = CACHED_FAMILIES[key]
    plan = resolve_plan(plan)
    if plan is None:
        full, reuse_blocks = np.ones(steps, bool), 0
    else:
        full = (plan.step_codes(steps) != CODE_REUSE if isinstance(plan, ComposedPlan)
                else plan.flags(steps))
        reuse_blocks = per_split * model.cache_split_index(plan.depth_fraction)
    run = (int(full.sum()) + 1) * blocks + int((~full).sum()) * reuse_blocks
    return {k: v * run for k, v in per_block.items()}


def busy_ms(call):
    """The device time of one call: torch.profiler's kernel durations summed
    (one stream: they do not overlap); None when it sees no device events.
    Device activity only: tracing the host's operators of a whole request
    took ~15 s a request to collect."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(ev.time_range.elapsed_us() for ev in events) / 1e3
    return None


def trajectory_psnr(out: torch.Tensor, base: torch.Tensor) -> float:
    """docs/CACHING.md's trajectory PSNR: the cached endpoint against the
    uncached one, before the clip, over the uncached endpoint's range."""
    out, base = out.double(), base.double()
    mse = float(((out - base) ** 2).mean())
    peak = float(base.max() - base.min())
    return math.inf if mse == 0 else 10.0 * math.log10(peak * peak / mse)


def dit14_state() -> dict:
    """Phase 6's DiT-B/2 weights: seed 1, the output projection at a tenth."""
    from flaxdiff_tpu_torch.models import SimpleDiT
    state = random_state(SimpleDiT(**DIT, device="cpu"), 1)
    for key in ("final_proj.weight", "final_proj.bias"):
        state[key] *= 0.1
    return state


def cache_card_vs_cpu(dev, state) -> dict:
    """14a: DiT-B/2 in f32, card (kernels) against CPU (plain versions), the
    same weights: the four cache modes at split 2 and keep 1/8, the selected
    tokens, DDIM-10 + CFG under a timestep and a composed plan; then in bf16
    record bit-equal to the plain forward and a refresh_every=1 request to
    the uncached one."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.ops import spatialcache as sc
    from flaxdiff_tpu_torch.ops.diffcache import CachePlan, resolve_cache_fns
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule

    models = []
    for where in (dev, "cpu"):
        m = SimpleDiT(**DIT, device=where)
        m.load_state_dict(state)
        models.append((where, m.eval()))
    split = models[1][1].cache_split_index(0.2)
    check(split == 2 and sc.spatial_k(DIT_TOKENS, CACHE_KEEP) == CACHE_K,
          f"DiT-B/2 splits at {split}, keeps {sc.spatial_k(DIT_TOKENS, CACHE_KEEP)} tokens")
    rng = np.random.default_rng(70)
    # a CFG call of 2 samples: [cond; uncond] rows
    x1 = rng.standard_normal((2, DIT_RES, DIT_RES, DIT_CH)).astype(np.float32)
    x1 = np.concatenate([x1, x1])
    x2 = (x1 + 0.3 * rng.standard_normal(x1.shape)).astype(np.float32)
    t = np.array([37.5, 911.0] * 2, np.float32)
    text = rng.standard_normal((2, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    ctx = np.concatenate([text, np.zeros_like(text)])
    outs = []
    for where, m in models:
        a1, a2, at, ac = (torch.from_numpy(a).to(where) for a in (x1, x2, t, ctx))
        kw = dict(cache_split=split)
        with torch.inference_mode():
            plain = m(a1, at, ac)
            rec, taps = m(a1, at, ac, cache_mode="record", **kw)
            rr, taps_rr, ref = m(a1, at, ac, cache_mode="record_ref", **kw)
            check(torch.equal(rec, plain) and torch.equal(rr, plain) and torch.equal(taps_rr, taps),
                  f"f32 record and record_ref bit-equal to the plain forward on {where}")
            reuse = m(a2, at, ac, cache_mode="reuse", cache_taps=taps, **kw)
            _, _, ref2 = m(a2, at, ac, cache_mode="record_ref", **kw)
            sp, sp_taps, sp_ref = m(a2, at, ac, cache_mode="spatial", cache_taps=taps,
                                    cache_ref=ref, cache_keep=CACHE_KEEP, **kw)
            idx = sc.select_tokens(ref2, ref, CACHE_KEEP, "l2")
            scores = sc.token_change_scores(ref2, ref, "l2")
        outs.append({k: v.float().cpu() for k, v in dict(
            record=plain, taps=taps, ref=ref, reuse=reuse, spatial=sp, spatial_taps=sp_taps,
            spatial_ref=sp_ref, idx=idx, scores=scores).items()})
    gpu, cpu = outs
    ranked = torch.sort(cpu["scores"], descending=True).values
    gap = float(ranked[CACHE_K - 1] - ranked[CACHE_K])
    same = torch.equal(gpu["idx"], cpu["idx"])
    res = {"split": split, "k": CACHE_K, "selection_equal": same, "kth_gap": gap,
           "kth_score": float(ranked[CACHE_K - 1])}
    log(f"  selected tokens card == CPU: {same}; the scores ranked {CACHE_K} and {CACHE_K + 1}: "
        f"{float(ranked[CACHE_K - 1]):.6g} and {float(ranked[CACHE_K]):.6g} (gap {gap:.3g})")
    if not same:
        differ = sorted(set(gpu["idx"].long().tolist()) ^ set(cpu["idx"].long().tolist()))
        log(f"  the selections differ in tokens {differ}, gap {gap:.3g}")
    check(same, f"card and CPU select the same {CACHE_K} tokens (gap {gap:.3g})")
    for name in ("record", "taps", "ref", "reuse", "spatial", "spatial_taps", "spatial_ref"):
        scale = max(1.0, float(cpu[name].abs().max()))
        err = max_err(gpu[name], cpu[name])
        res[f"{name}_err"], res[f"{name}_scale"] = err, scale
        log(f"  {name} f32: max|ref| {scale:.3g}, max err {err:.3g}")
        check(err <= 1e-3 * scale, f"cache mode {name}: error {err} above {1e-3 * scale}")

    x0 = (0.5 * rng.standard_normal((1, DIT_RES, DIT_RES, DIT_CH))).astype(np.float32)
    cond = rng.standard_normal((1, TEXT_LEN, TEXT_DIM)).astype(np.float32)
    for label, plan in (("timestep", CachePlan(refresh_every=3)),
                        ("composed", sc.DEFAULT_COMPOSED_PLAN)):
        samples = []
        for where, m in models:
            fns = (sc.resolve_composed_fns(m, plan) if isinstance(plan, sc.ComposedPlan)
                   else resolve_cache_fns(m, plan))
            ds = DiffusionSampler(lambda a, b, c, m=m: m(a, b, c), LinearNoiseSchedule(1000),
                                  EpsilonPredictionTransform(), DDIMSampler(),
                                  guidance_scale=GUIDANCE, device=where, cache_plan=plan,
                                  cache_fns=fns)
            samples.append(ds.generate_samples(
                diffusion_steps=CACHE_TRAJ_STEPS, init_samples=torch.from_numpy(x0),
                conditioning=torch.from_numpy(cond), unconditional=torch.zeros(cond.shape),
                start_step=333.0, channels=DIT_CH).cpu())
        err = max_err(*samples)
        clipped = float((samples[1].abs() >= 1.0).float().mean())
        res[f"ddim{CACHE_TRAJ_STEPS}_{label}"] = {"err": err, "clipped_share": clipped}
        log(f"  DDIM-{CACHE_TRAJ_STEPS} + CFG under the {label} plan f32 from t=333: max err "
            f"{err:.3g}, {clipped:.0%} clipped")
        check(clipped < 0.6 and err <= 1e-2, f"the {label} cached trajectory within 1e-2")
    del models

    model = SimpleDiT(**DIT, dtype="bfloat16", device=dev)
    model.load_state_dict(state)
    model.eval()
    a1, at, ac = (torch.from_numpy(a).to(dev) for a in (x1, t, ctx))
    with torch.inference_mode():
        plain = model(a1, at, ac)
        rec, _ = model(a1, at, ac, cache_mode="record", cache_split=split)
    check(torch.equal(plain, rec), "bf16 record bit-equal to the plain forward")
    pipe = DiffusionInferencePipeline(model, state, LinearNoiseSchedule(1000),
                                      EpsilonPredictionTransform(), device=dev)
    uncached = pipe.get_sampler("ddim", GUIDANCE)
    always = pipe.get_sampler("ddim", GUIDANCE, cache_plan=CachePlan(refresh_every=1))
    request = lambda ds: ds.generate_samples(
        num_samples=1, resolution=DIT_RES, diffusion_steps=CACHE_TRAJ_STEPS,
        generator=make_generator(2, dev), conditioning=torch.from_numpy(cond),
        unconditional=torch.zeros(cond.shape), channels=DIT_CH)
    check(always is uncached and torch.equal(request(always), request(uncached)),
          "a refresh_every=1 request is the uncached one, bit for bit")
    res["bf16_record_bit_equal"] = res["bf16_refresh_every_1_bit_equal"] = True
    log("  bf16: record bit-equal to the plain forward; refresh_every=1 bit-equal to uncached")
    return res


def metric_card_vs_cpu(dev) -> dict:
    """14a: PSNR and SSIM of 16 image pairs at 256x256, and InceptionV3's
    features of 4 images grown from 256x256 and 4 shrunk from 512x512 (He
    scaled random weights, so the features neither vanish nor blow up), f32
    card against CPU."""
    from flaxdiff_tpu_torch.metrics import InceptionV3Features, psnr, ssim
    gen = torch.Generator().manual_seed(71)
    target = torch.rand(16, 256, 256, 3, generator=gen) * 2 - 1
    pred = torch.clamp(target + 0.1 * torch.randn(target.shape, generator=gen), -1, 1)
    res = {}
    for name, fn in (("psnr", psnr), ("ssim", ssim)):
        ref = float(fn(pred, target))
        out = float(fn(pred.to(dev), target.to(dev)))
        res[name] = {"card": out, "cpu": ref, "rel_err": abs(out - ref) / abs(ref)}
        log(f"  {name} of 16 pairs at 256x256: card {out:.7g}, CPU {ref:.7g}, rel err "
            f"{res[name]['rel_err']:.3g}")
        check(res[name]["rel_err"] <= 1e-4, f"{name} card vs CPU within 1e-4 relative")
    state = inception_state(72)
    models = [InceptionV3Features(device=where).load_torch_state_dict(state)
              for where in (dev, "cpu")]
    for side in (256, 512):
        x = torch.rand(4, side, side, 3, generator=gen)
        with torch.inference_mode():
            out = models[0](x.to(dev)).cpu()
            ref = models[1](x)
        scale = float(ref.abs().max())
        err = max_err(out, ref)
        res[f"inception_{side}"] = {"err": err, "scale": scale}
        log(f"  Inception features of 4 images {'grown' if side < 299 else 'shrunk'} from "
            f"{side}x{side}: max|ref| {scale:.3g}, max err {err:.3g}")
        check(err <= 1e-4 * scale, f"Inception at {side}: error {err} above {1e-4 * scale}")
    return res


def inception_state(seed: int) -> dict:
    """InceptionV3's weights in pytorch-FID's names, drawn from a seed:
    kernels N(0, 2 / fan_in), BatchNorm statistics near (0, 1)."""
    from flaxdiff_tpu_torch.metrics import InceptionV3Features
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in InceptionV3Features(device="cpu").state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("conv.weight"):
            a = rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[1:]))
        elif name.endswith("running_var"):
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif name.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        state[name] = torch.from_numpy(a.astype(np.float32))
    return state


def cached_serving(dev, key: str, model, cond, uncond, plans: dict) -> dict:
    """14b: one DDIM-25 + CFG 3.0 request in bf16 per plan through the
    pipeline's sampler for that plan: its wall, ms per call, device busy time
    (profiler sum) and idle share, the launches (zeroed just before) against
    the plan's arithmetic, and the trajectory PSNR of its pre-clip endpoint
    (the same initial noise) against the uncached one."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import NoiseSource, get_timestep_spacing
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule

    side, ch = (DIT_RES, DIT_CH)
    pipe = DiffusionInferencePipeline(model, {}, LinearNoiseSchedule(1000),
                                      EpsilonPredictionTransform(), device=dev)
    batch = cond.shape[0]
    x_init = torch.randn(batch, side, side, ch, generator=make_generator(9, dev), device=dev)
    spacing = get_timestep_spacing("linear", STEPS14, 1000, device=dev)
    cond_d, uncond_d = cond.to(dev), uncond.to(dev)
    res, base = {}, None
    for name, plan in plans.items():
        ds = pipe.get_sampler("ddim", GUIDANCE, cache_plan=plan)
        request = lambda steps, seed: ds.generate_samples(
            num_samples=batch, resolution=side, diffusion_steps=steps, channels=ch,
            generator=make_generator(seed, dev), conditioning=cond, unconditional=uncond)
        request(2, 0)              # warm-up: GEMM choices at the cached shapes, allocator
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = request(STEPS14, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        planned = planned_launches(key, model, plan, STEPS14)
        expected = {k: planned.get(k, 0) for k in counts}
        check(counts == routed(expected), f"{key} {name}: launches {counts}, expected {expected}")
        check(tuple(out.shape) == (batch, side, side, ch) and bool(torch.isfinite(out).all()),
              f"{key} {name}: samples {tuple(out.shape)}, finite")
        busy = busy_ms(lambda: request(STEPS14, 1))
        with torch.inference_mode():
            end = ds.run_loop(x_init, spacing, NoiseSource(make_generator(3, dev)), cond_d,
                              uncond_d).float()
        check(bool(torch.isfinite(end).all()), f"{key} {name}: pre-clip endpoint finite")
        if base is None:
            base = end
        row = {"wall_s": wall, "ms_per_call": wall * 1e3 / (STEPS14 + 1), "launches": counts,
               "busy_ms": busy, "idle_share": None if busy is None else 1.0 - busy / (wall * 1e3),
               "psnr_db": trajectory_psnr(end, base), "plan": None if plan is None else repr(plan)}
        res[name] = row
        log(f"  {key} {name}: wall {wall:.3f} s ({row['ms_per_call']:.2f} ms per call), busy "
            + ("not measured" if busy is None else
               f"{busy:.3f} ms ({row['idle_share']:.0%} idle)")
            + f", launches flash {counts['flash_fwd']} / ln_mod {counts['ln_mod']} / gate_res "
            f"{counts['gate_res']}, trajectory PSNR {row['psnr_db']:.2f} dB")
    return res


def cache_serving_paths(dev, state, phase11: dict) -> dict:
    """14b: DiT-B/2 (phase 6's batch 4 and text) under every plan of
    docs/CACHING.md's table, a composed request through the pipeline's
    generate_samples and its diffcache counters, a cached and a composed
    trajectory under sync debug mode "error"; SimpleUDiT and SimpleMMDiT (phase
    11's widths, weights and batch-1 text) uncached and under the composed
    default."""
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.ops.diffcache import DEFAULT_CACHE_PLAN
    from flaxdiff_tpu_torch.ops.spatialcache import DEFAULT_COMPOSED_PLAN
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import NoiseSource, get_timestep_spacing
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule
    from flaxdiff_tpu_torch.telemetry import global_telemetry

    plans = cache_plans14()
    model = SimpleDiT(**DIT, dtype="bfloat16", device=dev)
    model.load_state_dict(state)
    model.eval()
    rng = np.random.default_rng(5)         # phase 6's text
    b = DIT_SERVE_BATCH
    cond = torch.from_numpy(rng.standard_normal((b, TEXT_LEN, TEXT_DIM)).astype(np.float32))
    uncond = torch.zeros(b, TEXT_LEN, TEXT_DIM)
    out = {"simple_dit": cached_serving(dev, "simple_dit", model, cond, uncond, plans)}

    # the entry point with its counters: unconditional, no CFG
    pipe = DiffusionInferencePipeline(model, dict(model.named_parameters()),
                                      LinearNoiseSchedule(1000), EpsilonPredictionTransform(),
                                      device=dev)
    names = ("requests", "spatial_requests", "refresh_steps", "spatial_steps", "reused_steps")
    read = lambda: {n: global_telemetry().counter(f"diffcache/{n}").value for n in names}
    before = read()
    samples = pipe.generate_samples(num_samples=b, resolution=DIT_RES, channels=DIT_CH,
                                    diffusion_steps=STEPS14, sampler="ddim", use_ema=False,
                                    cache_plan=DEFAULT_COMPOSED_PLAN)
    delta = {n: read()[n] - before[n] for n in names}
    counts = DEFAULT_COMPOSED_PLAN.counts(STEPS14)
    check(delta == {"requests": 1, "spatial_requests": 1, "refresh_steps": counts["refresh"],
                    "spatial_steps": counts["spatial"], "reused_steps": counts["reused"]},
          f"the diffcache counters {delta}")
    check(bool(np.isfinite(samples).all()), "the pipeline's composed request finite")
    out["pipeline_counters"] = delta
    log(f"  pipeline.generate_samples(cache_plan=DEFAULT_COMPOSED_PLAN): counters {delta}")

    spacing = get_timestep_spacing("linear", STEPS14, 1000, device=dev)
    x = torch.randn(b, DIT_RES, DIT_RES, DIT_CH, generator=make_generator(4, dev), device=dev)
    cond_d, uncond_d = cond.to(dev), uncond.to(dev)
    for label, plan in (("timestep", DEFAULT_CACHE_PLAN), ("composed", DEFAULT_COMPOSED_PLAN)):
        ds = pipe.get_sampler("ddim", GUIDANCE, cache_plan=plan)
        noise = NoiseSource(make_generator(5, dev))
        with torch.inference_mode():
            ds.run_loop(x, spacing, noise, cond_d, uncond_d)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                end = ds.run_loop(x, spacing, noise, cond_d, uncond_d)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.isfinite(end).all()), f"the {label} trajectory under sync debug")
        log(f"  DDIM-{STEPS14} + CFG under the {label} default plan ran under sync debug mode "
            f"\"error\": no host sync")
    out["sync_debug_clean"] = True
    del model, pipe
    torch.cuda.empty_cache()

    two = {k: plans[k] for k in ("off", "composed_default")}
    for key in ("simple_udit", "simple_mmdit"):
        i = list(FAMILIES11).index(key)
        model = family_model(dev, key, "bfloat16", random_state(family_model("cpu", key),
                                                               30 + i)).eval()
        _, _, text = family_inputs(key, 1, 21)
        out[key] = cached_serving(dev, key, model, torch.from_numpy(text),
                                  torch.zeros(1, TEXT_LEN, TEXT_DIM), two)
        log(f"  {key}: phase 11's uncached request {phase11[key]['wall_s']:.3f} s "
            f"({phase11[key]['ms_per_forward']:.2f} ms per call)")
        del model
        torch.cuda.empty_cache()
    return out


def metrics_paths(dev) -> dict:
    """14c: InceptionV3's features at 299x299 for a batch of 32 (launched and
    as a CUDA graph), FID of 64 generated against 64 real images with its
    sqrtm's share, and the CLI with --val_metrics psnr,ssim,fid."""
    import io
    import tempfile

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.data import get_dataset, iterate_batches
    from flaxdiff_tpu_torch.device import make_generator
    from flaxdiff_tpu_torch.metrics import FIDComputer, fid, make_inception_extractor
    from flaxdiff_tpu_torch.utils import to_unit_float
    from flaxdiff_tpu_torch.ops import launch_counts

    res = {}
    extractor = make_inception_extractor(seed=0, device=dev)
    x = torch.rand(INCEPTION_BATCH, 299, 299, 3, generator=make_generator(74, dev), device=dev)
    with torch.inference_mode():
        launched = time_ms(lambda: extractor.model(x), 5)
        graph = graph_ms(lambda: extractor.model(x), 1, replays=5)
    res["inception"] = {"batch": INCEPTION_BATCH, "ms": launched, "busy_ms": graph,
                        "images_per_s": INCEPTION_BATCH * 1e3 / launched}
    log(f"  InceptionV3 features, batch {INCEPTION_BATCH} at 299x299 f32: {launched:.3f} ms "
        f"launched, {graph:.3f} ms as a CUDA graph ({res['inception']['images_per_s']:.0f} "
        f"images/s)")

    real = next(iterate_batches(get_dataset("synthetic", image_size=FID_SIDE), FID_SAMPLES))
    real = real["sample"]
    # a stand-in generator: the real images, noised
    noisy = (real.astype(np.float32) / 127.5 - 1.0
             + 0.1 * np.random.default_rng(73).standard_normal(real.shape))
    generated = np.clip(noisy, -1.0, 1.0).astype(np.float32)
    sqrtm_s = [0.0]
    plain_sqrtm = fid._sqrtm

    def timed_sqrtm(a):
        t0 = time.perf_counter()
        r = plain_sqrtm(a)
        sqrtm_s[0] += time.perf_counter() - t0
        return r

    fid._sqrtm = timed_sqrtm
    try:
        computer = FIDComputer(extractor, batch_size=INCEPTION_BATCH)
        t0 = time.perf_counter()
        computer.add_real(to_unit_float(real))
        computer.add_generated(to_unit_float(generated))
        torch.cuda.synchronize()
        feats_s = time.perf_counter() - t0
        value = computer.compute()
        total = time.perf_counter() - t0
    finally:
        fid._sqrtm = plain_sqrtm
    check(math.isfinite(value), f"FID {value} finite")
    res["fid"] = {"samples": FID_SAMPLES, "value": value, "total_s": total, "features_s": feats_s,
                  "sqrtm_s": sqrtm_s[0], "sqrtm_share": sqrtm_s[0] / total}
    log(f"  FID of {FID_SAMPLES} noised against {FID_SAMPLES} real images at "
        f"{FID_SIDE}x{FID_SIDE} (seeded random features): {value:.6g}, {total:.3f} s in all, "
        f"features {feats_s:.3f} s, sqrtm {sqrtm_s[0]:.3f} s ({res['fid']['sqrtm_share']:.0%})")

    root = tempfile.mkdtemp(prefix="flaxdiff_cli14_")
    try:
        argv = cli_args(root, CLI14_STEPS, dev) + [
            "--val_every", str(CLI14_VAL_EVERY), "--val_steps", str(CLI14_VAL_STEPS),
            "--val_metrics", "psnr,ssim,fid"]
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = train.main(argv)
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rows = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{") and "val/wall_s" in line]
    for row in rows:
        log(f"  CLI log: {json.dumps(row)}")
    check(len(rows) == 1 and all(math.isfinite(rows[0][f"val/{k}"]) for k in
                                 ("psnr", "ssim", "fid")),
          "the CLI's log shows finite val/psnr, val/ssim and val/fid")
    res["cli"] = {"wall_s": wall, "validation": rows, "launches": counts,
                  "final_loss": hist.get("final_loss")}
    return res


def cache_paths(dev, phase11: dict) -> dict:
    """Phase 14 (see the module docstring)."""
    state = dit14_state()
    out = {}
    log("  14a: card against CPU, f32: the cache modes, cached trajectories, the metrics")
    t0 = time.perf_counter()
    out["card_vs_cpu"] = cache_card_vs_cpu(dev, state)
    torch.cuda.empty_cache()
    out["metrics_card_vs_cpu"] = metric_card_vs_cpu(dev)
    out["a_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"  14b: DDIM-{STEPS14} + CFG {GUIDANCE} in bf16 under docs/CACHING.md's plans")
    t0 = time.perf_counter()
    out["serving"] = cache_serving_paths(dev, state, phase11)
    out["b_s"] = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    log("  14c: InceptionV3, FID, the CLI's --val_metrics")
    t0 = time.perf_counter()
    out["metrics"] = metrics_paths(dev)
    out["c_s"] = time.perf_counter() - t0
    return out


# --- phase 15: the serving subsystem ------------------------------------------------

SERVE15_ROUND, SERVE15_BUCKETS = 10, (1, 2, 4, 8)
SERVE15_REQUESTS, SERVE15_RATE, SERVE15_SEED = 32, 8.0, 15
PROMPTS15 = ["a watercolor of a lighthouse at dawn", "a macro photo of frost on a leaf",
             "an isometric city block at night"]
# the replay's traffic (bench.py:stage_serve's kind of mix at phase 4's size)
MIX15 = [dict(resolution=RESOLUTION, channels=3, guidance_scale=GUIDANCE, use_ema=False,
              diffusion_steps=n, sampler=s, prompts=[p])
         for (n, s), p in zip(((25, "ddim"), (50, "ddim"), (50, "euler_ancestral")), PROMPTS15)]
DOOR15_REQUESTS = 16


def serving15_pipeline(dev, model, side: int, ch: int, schedule, transform):
    """A pipeline over `model` (its own weights as the params) with the hash
    encoder's 77x768 text input: requests carry prompts."""
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline
    from flaxdiff_tpu_torch.inputs import (ConditionalInputConfig, DiffusionInputConfig,
                                           HashTextEncoder)
    ic = DiffusionInputConfig("sample", (side, side, ch), [ConditionalInputConfig(
        HashTextEncoder(features=TEXT_DIM, max_length=TEXT_LEN))])
    params = {k: v.detach() for k, v in model.named_parameters()}
    return DiffusionInferencePipeline(model, params, schedule, transform, input_config=ic,
                                      device=dev)


def serve15(pipe, reqs, telemetry=None, **cfg):
    """Serve `reqs` through one scheduler; the results in request order."""
    from flaxdiff_tpu_torch.serving import SchedulerConfig, ServingScheduler
    from flaxdiff_tpu_torch.telemetry import Telemetry
    sched = ServingScheduler(pipeline=pipe, telemetry=telemetry or Telemetry(),
                             autostart=False, config=SchedulerConfig(**cfg))
    futs = [sched.submit(r) for r in reqs]
    sched.start()
    try:
        return [f.result(timeout=600) for f in futs]
    finally:
        sched.close()


def drive15(submit, workload, speed: float):
    """Submit on the workload's arrival clock (scaled by `speed`); every
    future's result or exception, in workload order."""
    t0 = time.perf_counter()
    futs = []
    for offset, req in workload:
        delay = offset / speed - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        futs.append(submit(req))
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=600))
        except Exception as e:          # noqa: BLE001 — tallied by the caller
            out.append(e)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def preclip():
    """Serve and sample without the final clip to [-1, 1]. The random eps
    UNet's x0 from t = 999 lies far outside it (99.99% of the pixels clip),
    so clipped samples agree in their signs and little else: phase 15's
    comparisons read x0 before the clip."""
    import flaxdiff_tpu_torch.samplers.common as sampler_common
    import flaxdiff_tpu_torch.serving.engine as engine
    saved = sampler_common.clip_images, engine.clip_images
    sampler_common.clip_images = engine.clip_images = lambda x: x
    try:
        yield
    finally:
        sampler_common.clip_images, engine.clip_images = saved


def rel15(out, ref) -> float:
    """max|out - ref| / max(1, max|ref|)."""
    return float(np.abs(out - ref).max() / max(1.0, float(np.abs(ref).max())))


def solo15(pipe, r):
    return pipe.generate_samples(num_samples=r.num_samples, resolution=r.resolution,
                                 channels=r.channels, diffusion_steps=r.diffusion_steps,
                                 sampler=r.sampler, guidance_scale=r.guidance_scale,
                                 prompts=r.prompts, seed=r.seed, use_ema=False,
                                 cache_plan=r.cache_plan)


def serving_identity(dev, pipe) -> dict:
    """15a, on x0 before the clip (`preclip`): each request alone in bucket 1
    (CFG batch 2, the solo call's own batch) bit-equal to the solo
    generate_samples; three requests batched in bucket 4 bit-equal to the solo
    call; multistep DPM at two offsets, the same; one round under sync debug
    "error"."""
    from flaxdiff_tpu_torch.serving import SampleRequest, SamplerProgramEngine, ServingFuture
    from flaxdiff_tpu_torch.telemetry import Telemetry
    reqs = [SampleRequest(**dict(MIX15[i], seed=101 + i)) for i in range(3)]
    ms = [SampleRequest(**dict(MIX15[1], sampler="multistep_dpm", diffusion_steps=n, seed=s))
          for n, s in ((30, 104), (20, 105))]
    name = lambda r: f"{r.sampler}-{r.diffusion_steps}"
    res = {"requests": {name(r): {} for r in reqs + ms}}
    with preclip():
        solos = {r.seed: solo15(pipe, r) for r in reqs + ms}
        ones = serve15(pipe, reqs + ms, round_steps=SERVE15_ROUND, batch_buckets=(1,))
        for r, o in zip(reqs + ms, ones):
            ref = solos[r.seed]
            row = res["requests"][name(r)]
            row.update(bit_equal_solo_bucket1=bool(np.array_equal(o.samples, ref)),
                       max_diff_solo_bucket1=float(np.abs(o.samples - ref).max()),
                       max_abs_x0=float(np.abs(ref).max()),
                       clipped_share=float((np.abs(ref) >= 1.0).mean()))
            log(f"  15a {name(r)} alone in bucket 1: x0 before the clip bit-equal to the solo "
                f"generate_samples {row['bit_equal_solo_bucket1']} (max diff "
                f"{row['max_diff_solo_bucket1']:.3g}, max|x0| {row['max_abs_x0']:.4g}, "
                f"{row['clipped_share']:.2%} of it outside [-1, 1])")
            check(row["bit_equal_solo_bucket1"],
                  f"15a {name(r)}: bucket 1 equals the solo generate_samples bit for bit")
            check(bool(np.isfinite(o.samples).all())
                  and o.samples.shape == (1, RESOLUTION, RESOLUTION, 3),
                  f"15a {name(r)}: samples {o.samples.shape}, finite")

        cfg = dict(round_steps=SERVE15_ROUND, batch_buckets=(4,))
        batched = serve15(pipe, reqs, **cfg)
        for r, o in zip(reqs, batched):
            row = res["requests"][name(r)]
            row.update(bit_equal_solo_bucket4=bool(np.array_equal(o.samples, solos[r.seed])),
                       rel_diff_solo=rel15(o.samples, solos[r.seed]), rounds=o.rounds)
            log(f"  15a {name(r)} batched in bucket 4: {o.rounds} rounds, bit-equal to the solo "
                f"call {row['bit_equal_solo_bucket4']} ({row['rel_diff_solo']:.3g} of max)")
            check(row["bit_equal_solo_bucket4"],
                  f"15a {name(r)}: bucket 4 equals the solo generate_samples bit for bit")

        # multistep DPM: B admitted one round after A, at A's offset 10
        eng = SamplerProgramEngine(pipe, telemetry=Telemetry())

        def run(admit):
            rows, outs, rnd = [], {}, 0
            while rnd in admit or rows:
                if rnd in admit:
                    rows.append(eng.prepare(admit[rnd], ServingFuture(), 0.0, 0.0))
                done, _ = eng.advance(rows, 4, SERVE15_ROUND)
                if done:
                    x0, _ = eng.finalize(done, 4)
                    host = x0.cpu().numpy()
                    for i, r in enumerate(done):
                        outs[r.req.seed] = host[i]
                rows = [r for r in rows if r.remaining > 0]
                rnd += 1
            return outs

        together = run({0: ms[0], 1: ms[1]})
        for r in ms:
            row = res["requests"][name(r)]
            row.update(bit_equal_solo_bucket4=bool(np.array_equal(
                           together[r.seed].reshape(solos[r.seed].shape), solos[r.seed])),
                       rel_diff_solo=rel15(together[r.seed], solos[r.seed]))
            log(f"  15a {name(r)} (admitted at offset "
                f"{0 if r is ms[0] else SERVE15_ROUND}) in bucket 4: bit-equal to the solo call "
                f"{row['bit_equal_solo_bucket4']} ({row['rel_diff_solo']:.3g} of max)")
            check(row["bit_equal_solo_bucket4"],
                  f"15a multistep seed {r.seed}: bucket 4 equals the solo call bit for bit")

    # one round under sync debug "error": prepared before, launched inside
    rows = [eng.prepare(r, ServingFuture(), 0.0, 0.0) for r in reqs[:2]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.advance(rows, 4, SERVE15_ROUND)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    res["sync_debug_round"] = True
    log("  15a one bucket-4 round of two DDIM rows ran under sync debug \"error\"")
    return res


def bucket8_round(engine, phase4: dict) -> dict:
    """One bucket-8 round of 10 DDIM steps: its time as launched (the
    host's enqueue), its wall to completion and its device busy time."""
    from flaxdiff_tpu_torch.serving import SampleRequest, ServingFuture
    reqs = [SampleRequest(**dict(MIX15[1], seed=300 + i)) for i in range(8)]
    sets = [[engine.prepare(r, ServingFuture(), 0.0, 0.0) for r in reqs] for _ in range(6)]
    engine.advance(sets.pop(), 8, SERVE15_ROUND)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.advance(sets.pop(), 8, SERVE15_ROUND)
    launched = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = busy_ms(lambda: engine.advance(sets.pop(), 8, SERVE15_ROUND))
    out = {"launched_ms": launched * 1e3, "wall_ms": wall * 1e3, "busy_ms": busy,
           "idle_share": None if busy is None else 1.0 - busy / (wall * 1e3),
           "ms_per_step": wall * 1e3 / SERVE15_ROUND,
           "phase4_ms_per_forward": phase4["ms_per_forward"],
           "phase4_forward_busy_ms": phase4["breakdown"]["busy_ms"]}
    log(f"  15b one bucket-8 round (8 requests x 10 DDIM steps, CFG batch 16): launched in "
        f"{out['launched_ms']:.3f} ms, wall {out['wall_ms']:.3f} ms "
        f"({out['ms_per_step']:.3f} ms a step), busy "
        + ("not measured" if busy is None else f"{busy:.3f} ms ({out['idle_share']:.0%} idle)")
        + f"; phase 4's solo request {phase4['ms_per_forward']:.3f} ms a step, one CFG forward "
        f"busy {phase4['breakdown']['busy_ms']:.3f} ms")
    return out


def serving_replay(dev, pipe, workload, phase4: dict) -> dict:
    """15b: the seeded Poisson replay twice after prewarm."""
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.serving import SampleRequest, SchedulerConfig, ServingScheduler, replay
    from flaxdiff_tpu_torch.telemetry import Telemetry
    tel = Telemetry()
    sched = ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False,
                             config=SchedulerConfig(round_steps=SERVE15_ROUND,
                                                    batch_buckets=SERVE15_BUCKETS,
                                                    max_inflight=2))
    # one prototype a group: the program keys hold the round length, not
    # the NFE, so one round of each covers every request of the mix
    protos = [SampleRequest(**dict(m, diffusion_steps=SERVE15_ROUND, seed=0))
              for m in (MIX15[0], MIX15[2])]
    warm = sched.prewarm(protos)
    log(f"  15b prewarm: {warm['programs']} programs in {warm['seconds']:.3f} s")
    calls = {"model": 0, "finalize": 0}
    hook = pipe.model.register_forward_pre_hook(
        lambda *_: calls.__setitem__("model", calls["model"] + 1))
    finalize = sched.engine.finalize

    def counted_finalize(*a, **kw):
        calls["finalize"] += 1
        return finalize(*a, **kw)

    sched.engine.finalize = counted_finalize
    sched.start()
    names = ("rounds", "rows_real", "rows_padded", "program_cache_hits",
             "program_cache_misses", "shed", "backpressure_waits", "requests_ok")
    runs = []
    try:
        for i in range(2):
            before = {n: tel.counter(f"serving/{n}").value for n in names}
            if i == 1:
                torch.cuda.synchronize()
                reset_counts()
                calls.update(model=0, finalize=0)
            summary = replay(sched, workload, timeout_s=600)
            d = {n: tel.counter(f"serving/{n}").value - before[n] for n in names}
            lookups = d["program_cache_hits"] + d["program_cache_misses"]
            row = {"summary": summary, "counters": d,
                   "occupancy": d["rows_real"] / max(1.0, d["rows_real"] + d["rows_padded"]),
                   "cache_hit_rate": d["program_cache_hits"] / max(1.0, lookups)}
            runs.append(row)
            lat = summary["latency_ms"]
            log(f"  15b replay {i + 1}: {summary['completed']}/{summary['requests']} completed, "
                f"latency p50 {lat['p50']:.1f} ms p99 {lat['p99']:.1f} ms, "
                f"{summary['throughput_rps']:.3f} requests/s, {summary['samples_per_s']:.3f} "
                f"images/s, occupancy {row['occupancy']:.3f}, cache hit rate "
                f"{row['cache_hit_rate']:.3f} ({int(d['program_cache_misses'])} misses), shed "
                f"{int(d['shed'])}, backpressure waits {int(d['backpressure_waits'])}, "
                f"{int(d['rounds'])} rounds")
            check(summary["completed"] == summary["requests"], f"15b replay {i + 1}: all completed")
        counts = launch_counts()
    finally:
        sched.close()
        hook.remove()
    d = runs[1]["counters"]
    check(d["program_cache_misses"] == 0, "15b: the warm replay built no program")
    model_calls = calls["model"]
    check(model_calls == d["rounds"] * SERVE15_ROUND + calls["finalize"],
          f"15b: {model_calls} model calls = {int(d['rounds'])} rounds x {SERVE15_ROUND} steps "
          f"+ {calls['finalize']} terminal calls")
    expected = {k: PER_FORWARD.get(k, 0) * model_calls for k in counts}
    log(f"  15b warm replay launches {counts}, expected {expected}")
    check(counts == routed(expected), "15b: every model call of the warm replay ran its kernels")
    round8 = bucket8_round(sched.engine, phase4)
    return {"prewarm": warm, "replays": runs, "launches": counts, "model_calls": model_calls,
            "terminal_calls": calls["finalize"], "bucket8_round": round8}


def chaos15(pipe, workload, cfg, speed: float, chaos: bool):
    """`workload` through one scheduler after prewarm, under
    bench.py:stage_serve's FaultPlan when `chaos`, on x0 before the clip:
    (every future's result or exception, the registry's snapshot)."""
    from flaxdiff_tpu_torch import resilience as R
    from flaxdiff_tpu_torch.serving import SampleRequest, ServingScheduler
    from flaxdiff_tpu_torch.telemetry import Telemetry
    tel = Telemetry()
    sched = ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False, config=cfg)
    sched.prewarm([SampleRequest(**dict(m, diffusion_steps=SERVE15_ROUND, seed=0))
                   for m in (MIX15[0], MIX15[2])])
    sched.start()
    plan = R.FaultPlan([R.FaultSpec("serving.round", at=(3,), times=1),
                        R.FaultSpec("serving.fetch", at=(2,), times=1),
                        R.FaultSpec("serving.device_lost", at=(6,), times=1,
                                    error="flag")] if chaos else [], seed=0)
    try:
        with plan.installed(), preclip():
            results, _ = drive15(sched.submit, workload, speed)
    finally:
        sched.close()
    return results, tel.registry.snapshot()


def serving_chaos(dev, pipe, workload) -> dict:
    """15c: bench.py:stage_serve's FaultPlan over 15b's workload in 15b's
    buckets. Every request completes and every fault fires and is
    recovered. The faults' requeues and conviction's probe rounds move a
    request into other buckets, positions and mates; each is held bit for
    bit to its fault-free run and to its solo generate_samples."""
    from flaxdiff_tpu_torch.serving import SchedulerConfig
    # no brownout: after a fault it caps the NFE of the requests admitted in
    # its cooldown (degrade before shed), a different request by design
    cfg = SchedulerConfig(round_steps=SERVE15_ROUND, batch_buckets=SERVE15_BUCKETS,
                          max_inflight=2, brownout=None)
    clean, _ = chaos15(pipe, workload, cfg, 1.0, chaos=False)
    faulted, snap = chaos15(pipe, workload, cfg, 1.0, chaos=True)
    failed = [type(r).__name__ for r in clean + faulted if isinstance(r, Exception)]
    check(not failed, f"15c: every request completed ({failed})")
    with preclip():
        solos = [solo15(pipe, r) for _, r in workload]
    row = {k: snap.get(f"serving/{k}", 0.0) for k in
           ("requeued", "quarantined", "supervisor_rebuilds", "round_faults",
            "fetch_faults", "device_lost", "probe_rounds")}
    row.update(requests=len(workload), buckets=list(SERVE15_BUCKETS),
               bit_equal=sum(bool(np.array_equal(a.samples, b.samples))
                             for a, b in zip(clean, faulted)),
               bit_equal_solo=sum(bool(np.array_equal(b.samples, s))
                                  for b, s in zip(faulted, solos)),
               max_rel_diff_solo=max(rel15(b.samples, s) for b, s in zip(faulted, solos)),
               retried=sum(r.attempts > 0 for r in faulted),
               recovered_p99_ms=float(np.percentile(
                   [r.latency_ms for r in faulted if r.attempts > 0] or [0.0], 99)))
    log(f"  15c chaos in buckets {SERVE15_BUCKETS}: {len(workload)} completed, "
        f"{row['bit_equal']} bit-equal to the fault-free run, {row['bit_equal_solo']} to the "
        f"solo call (x0 within {row['max_rel_diff_solo']:.3g} of max); round faults "
        f"{row['round_faults']:.0f}, fetch faults {row['fetch_faults']:.0f}, device lost "
        f"{row['device_lost']:.0f}; requeued {row['requeued']:.0f}, quarantined "
        f"{row['quarantined']:.0f}, rebuilds {row['supervisor_rebuilds']:.0f}, probe rounds "
        f"{row['probe_rounds']:.0f}, retried {row['retried']}")
    check(row["supervisor_rebuilds"] == 1 and row["round_faults"] >= 1
          and row["fetch_faults"] == 1, "15c: every fault fired and was recovered")
    check(row["bit_equal"] == len(workload),
          "15c: every request bit-equal to its fault-free result")
    check(row["bit_equal_solo"] == len(workload),
          "15c: every request bit-equal to its solo generate_samples")
    return {"bucketed": row}


def serving_frontdoor(dev, pipe, workload) -> dict:
    """15d: two replicas over the pipeline's weights behind the FrontDoor;
    serving.replica_lost kills r0 mid-replay (bench.py:2321's plan)."""
    from flaxdiff_tpu_torch import resilience as R
    from flaxdiff_tpu_torch.serving import (DEAD, FrontDoor, FrontDoorConfig, SchedulerConfig,
                                            ServingFault, build_pool)
    from flaxdiff_tpu_torch.telemetry import Telemetry
    work = workload[:DOOR15_REQUESTS]
    tels, door_tel = [Telemetry(), Telemetry()], Telemetry()
    pool = build_pool([pipe, pipe], scheduler_config=SchedulerConfig(
        round_steps=SERVE15_ROUND, batch_buckets=SERVE15_BUCKETS, max_inflight=2),
        telemetries=tels)
    door = FrontDoor(pool, telemetry=door_tel, config=FrontDoorConfig(max_attempts=3))
    kill_at = max(3, len(work) // 3)
    plan = R.FaultPlan([R.FaultSpec("serving.replica_lost", per_key=True, match="replica:r0:",
                                    at=(kill_at,), times=1, error="flag")], seed=0)
    try:
        with plan.installed():
            results, wall = drive15(door.submit, work, 1.0)
    finally:
        door.close()
    snap = door_tel.registry.snapshot()
    completed = sum(not isinstance(r, Exception) for r in results)
    typed = sum(isinstance(r, ServingFault) for r in results)
    res = {"requests": len(work), "completed": completed, "typed_faults": typed,
           "failovers": snap.get("frontdoor/failovers", 0.0),
           "replica_lost": snap.get("frontdoor/replica_lost", 0.0),
           "pool_exhausted": snap.get("frontdoor/pool_exhausted", 0.0),
           "r0_dead": pool.replicas[0].health() == DEAD, "wall_s": wall,
           "served_by": [t.counter("serving/requests_ok").value for t in tels]}
    log(f"  15d front door: {completed}/{len(work)} completed ({typed} typed faults), r0 killed "
        f"at its submission poll {kill_at}, failovers {res['failovers']:.0f}, served by r0/r1 "
        f"{res['served_by']}, wall {wall:.3f} s")
    check(completed + typed == len(work), "15d: every future resolved")
    check(res["replica_lost"] == 1 and res["r0_dead"], "15d: r0 was lost")
    check(res["failovers"] >= 1, "15d: failover was counted")
    return res


def serving_cached(dev) -> dict:
    """15e: DiT-B/2 under the composed default plan through the scheduler."""
    from flaxdiff_tpu_torch.models import SimpleDiT
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.ops.spatialcache import DEFAULT_COMPOSED_PLAN
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule
    from flaxdiff_tpu_torch.serving import SampleRequest
    from flaxdiff_tpu_torch.telemetry import Telemetry
    model = SimpleDiT(**DIT, dtype="bfloat16", device=dev)
    model.load_state_dict(dit14_state())
    model.eval()
    pipe = serving15_pipeline(dev, model, DIT_RES, DIT_CH, LinearNoiseSchedule(1000),
                              EpsilonPredictionTransform())
    cfg = dict(round_steps=SERVE15_ROUND, batch_buckets=(2,))
    reqs = [SampleRequest(resolution=DIT_RES, channels=DIT_CH, diffusion_steps=STEPS,
                          sampler="ddim", guidance_scale=GUIDANCE, use_ema=False,
                          prompts=[PROMPTS15[(i + j) % 3] for j in range(DIT_SERVE_BATCH)],
                          seed=201 + i, cache_plan=DEFAULT_COMPOSED_PLAN) for i in range(2)]
    serve15(pipe, reqs[:1], **cfg)                 # warm-up: GEMM choices, allocator
    torch.cuda.synchronize()
    tel = Telemetry()
    reset_counts()
    alone = serve15(pipe, reqs[:1], telemetry=tel, **cfg)[0]
    counts = launch_counts()
    planned = planned_launches("simple_dit", model, DEFAULT_COMPOSED_PLAN, STEPS)
    expected = {k: planned.get(k, 0) for k in counts}
    log(f"  15e one composed request alone: launches {counts}, planned {expected}")
    check(counts == routed(expected), "15e: a composed request launches as phase 14's plan implies")
    pair = serve15(pipe, reqs, **cfg)
    alone_b = serve15(pipe, reqs[1:], **cfg)[0]
    solo = solo15(pipe, reqs[0])
    res = {"launches": counts, "planned": expected,
           "bit_equal_alone": [bool(np.array_equal(pair[0].samples, alone.samples)),
                               bool(np.array_equal(pair[1].samples, alone_b.samples))],
           "max_diff_solo": float(np.abs(alone.samples - solo).max()),
           "spatial_steps": tel.counter("serving/spatial_steps").value,
           "refresh_steps": tel.counter("serving/cache_refresh_steps").value,
           "reused_steps": tel.counter("serving/cache_reused_steps").value}
    log(f"  15e two composed requests in bucket 2: bit-equal alone {res['bit_equal_alone']}, "
        f"max |alone - solo generate_samples| {res['max_diff_solo']:.3g}; steps refresh "
        f"{res['refresh_steps']:.0f} / spatial {res['spatial_steps']:.0f} / reuse "
        f"{res['reused_steps']:.0f}")
    check(all(res["bit_equal_alone"]), "15e: each request equals itself alone in bucket 2")
    check(bool(np.isfinite(pair[0].samples).all()), "15e: samples finite")
    return res


def serving_paths(dev, phase4: dict) -> dict:
    """Phase 15: the serving subsystem on phase 4's UNet and phase 6's DiT."""
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.serving import PoissonWorkloadSpec, build_workload
    model, _, _ = serving_model(dev, random_state(Unet(**UNET, device="cpu"), 0))
    pipe = serving15_pipeline(dev, model, RESOLUTION, 3, CosineNoiseSchedule(1000),
                              EpsilonPredictionTransform())
    workload = build_workload(PoissonWorkloadSpec(n_requests=SERVE15_REQUESTS,
                                                  rate_hz=SERVE15_RATE, seed=SERVE15_SEED,
                                                  mix=MIX15))
    out, t = {}, time.perf_counter()
    for key, fn in (("identity", lambda: serving_identity(dev, pipe)),
                    ("replay", lambda: serving_replay(dev, pipe, workload, phase4)),
                    ("chaos", lambda: serving_chaos(dev, pipe, workload)),
                    ("frontdoor", lambda: serving_frontdoor(dev, pipe, workload))):
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
    del model, pipe
    torch.cuda.empty_cache()
    out["cached"] = serving_cached(dev)
    out["cached"]["phase_s"] = time.perf_counter() - t
    return out


# --- phase 16: the packed-shard data feed --------------------------------------------

DATA16_SHARDS, DATA16_PER_SHARD = 4, 128


def data16_images(n: int, side: int, seed: int) -> np.ndarray:
    """[n, side, side, 3] uint8: smooth seeded fields (bilinear from 8x8)
    with a little noise, so PNG's filters and deflate see photo-like rows."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((n, 3, 8, 8), dtype=np.float32) * 255.0)
    fine = torch.nn.functional.interpolate(coarse, size=(side, side), mode="bilinear",
                                           align_corners=False)
    fine = fine.permute(0, 2, 3, 1).numpy() + rng.normal(0.0, 4.0, (n, side, side, 3))
    return fine.clip(0, 255).astype(np.uint8)


def data16_args(checkpoint_dir: str, total_steps: int, dev, pattern: str) -> list:
    args = cli_args(checkpoint_dir, total_steps, dev)
    at = args.index("--dataset")
    return args[:at + 1] + ["packed_shards", "--dataset_path", pattern] + args[at + 2:]


def data_paths(dev, per_step: dict, phase10: dict) -> dict:
    """Phase 16: phase 10's CLI run over packed shards written by the port's
    write_image_dataset (PNG through the port's codec), with one resume."""
    import tempfile

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.data import ShardedPackedRecordSource, write_image_dataset
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.trainer import Checkpointer

    root = tempfile.mkdtemp(prefix="flaxdiff_data_")
    res = {}
    try:
        n = DATA16_SHARDS * DATA16_PER_SHARD
        images = data16_images(n, TRAIN_RES, 16)
        captions = [CLI_PROMPTS[i % 2] for i in range(n)]
        os.makedirs(os.path.join(root, "data"))
        t0 = time.perf_counter()
        for s in range(DATA16_SHARDS):
            part = slice(s * DATA16_PER_SHARD, (s + 1) * DATA16_PER_SHARD)
            write_image_dataset(os.path.join(root, "data", f"shard-{s}.rec"), images[part],
                                captions[part])
        write_s = time.perf_counter() - t0
        pattern = os.path.join(root, "data", "shard-*.rec")
        nbytes = sum(os.path.getsize(os.path.join(root, "data", f)) for f in
                     os.listdir(os.path.join(root, "data")))
        src = ShardedPackedRecordSource(pattern=pattern).get_source()
        check(len(src) == n, f"16: {len(src)} records in {DATA16_SHARDS} shards, {n} written")
        t0 = time.perf_counter()
        decoded = [src[i] for i in range(n)]
        read_s = time.perf_counter() - t0
        check(all(np.array_equal(r["image"], img) for r, img in zip(decoded, images)),
              "16: every record decodes to the image written")
        res["shards"] = {"records": n, "bytes": nbytes, "write_s": write_s,
                         "decoded_records_per_s": n / read_s}
        log(f"  {DATA16_SHARDS} shards of {DATA16_PER_SHARD} PNG images at {TRAIN_RES}x"
            f"{TRAIN_RES}: {nbytes / 2 ** 20:.1f} MiB written in {write_s:.2f} s; the reader "
            f"decodes {n / read_s:.0f} records/s on one host thread")
        del decoded

        whole, resumed = (os.path.join(root, k) for k in ("whole", "resumed"))
        reset_counts()
        t0 = time.perf_counter()
        hist = train.main(data16_args(whole, CLI_STEPS, dev, pattern))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        expected = {k: CLI_STEPS * per_step.get(k, 0) for k in counts}
        check(counts == routed(expected), "16: every forward and backward kernel ran once per "
                                          "call per step")
        check(all(math.isfinite(x) for x in hist["loss"]), "16: every window loss finite")
        steady = [TRAIN_BATCH * 1e3 / ips for ips in hist["imgs_per_sec"][1:]]
        res["fit"] = {"wall_s": wall, "ms_per_step": float(np.median(steady)),
                      "images_per_s": TRAIN_BATCH * 1e3 / float(np.median(steady)),
                      "losses": hist["loss"], "launches": counts,
                      "phase10_images_per_s": phase10["fit"]["images_per_s"]}
        log(f"  fit over packed shards: {res['fit']['ms_per_step']:.3f} ms per step, "
            f"{res['fit']['images_per_s']:.1f} images/s (phase 10's synthetic source "
            f"{phase10['fit']['images_per_s']:.1f}); window losses "
            + " ".join(f"{x:.5f}" for x in hist["loss"]))

        copy_run(whole, resumed, CLI_SAVE_EVERY)
        train.main(data16_args(resumed, CLI_STEPS, dev, pattern))
        a, _ = Checkpointer(whole).restore(CLI_STEPS)
        b, _ = Checkpointer(resumed).restore(CLI_STEPS)
        keys = ("params", "ema", "exp_avg", "exp_avg_sq")
        res["resume"] = {"bit_equal": all(torch.equal(a[k], b[k]) for k in keys),
                         "max_abs_diff": {k: float((a[k] - b[k]).abs().max()) for k in keys}}
        log(f"  resumed from step {CLI_SAVE_EVERY} to {CLI_STEPS}: bit-equal "
            f"{res['resume']['bit_equal']}")
        check(res["resume"]["bit_equal"], "16: the resumed run equals the uninterrupted one")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# --- phase 17: the run's telemetry ------------------------------------------------

# 17a: phase 10's CLI run with every telemetry flag, windows of 8 steps, the
# device phase sampled every 4th step, one device-profile window of 4 steps
# opened through the trainer's profile_trigger (armed at the first window)
TEL17_STEPS, TEL17_LOG_EVERY, TEL17_SAMPLE, TEL17_PROFILE = 32, 8, 4, 4
# 17b: phase 4's served UNet, DDIM-10 requests in buckets 1 and 4
SERVE17_STEPS, SERVE17_ROUND = 10, 10
# 17c: the KL autoencoder at the JAX defaults' widths
AE17 = dict(latent_channels=4, block_channels=(64, 128, 256), layers_per_block=2, norm_groups=8)
AE17_BATCH, AE17_SIDE, AE17_WARMUP, AE17_TIMED, AE17_LR = 8, 256, 3, 10, 1e-4
AE17_CHECK_BATCH, AE17_CHECK_SIDE, AE17_SEED = 2, 64, 17
TEL17_FILES = ("telemetry.jsonl", "goodput.json", "trace.json", "programs.jsonl",
               "devprof.jsonl")


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def telemetry_cli_path(dev, phase10: dict) -> dict:
    """17a (see the module docstring)."""
    import dataclasses
    import tempfile

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.profiling import device_peak_flops, model_flops
    from flaxdiff_tpu_torch.telemetry import read_registry
    from flaxdiff_tpu_torch.trainer import ModelRegistry

    root = tempfile.mkdtemp(prefix="flaxdiff_tel17_")
    res: dict = {}
    make_run = train.make_run
    try:
        run_dir, tel = os.path.join(root, "run"), os.path.join(root, "tel")
        prom, reg, trigger = (os.path.join(root, n) for n in ("m.prom", "registry.json", "go"))
        open(trigger, "w").close()
        fit_wall = []

        def armed(argv):
            run = make_run(argv)
            t = run.trainer
            t.config = dataclasses.replace(t.config, profile_trigger=trigger,
                                           profile_steps=TEL17_PROFILE)
            fit = t.fit

            def timed_fit(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fit(*a, **k)
                finally:
                    fit_wall.append(time.perf_counter() - t0)

            t.fit = timed_fit
            return run

        train.make_run = armed
        args = with_flags(cli_args(run_dir, TEL17_STEPS, dev), log_every=str(TEL17_LOG_EVERY),
                          save_every=str(TEL17_STEPS), telemetry_dir=tel,
                          telemetry_sample_every=str(TEL17_SAMPLE), prometheus_textfile=prom,
                          registry=reg, run_name="phase17")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        hist = train.main(args)
        torch.cuda.synchronize()
        counts = launch_counts()
        per_step = {**PER_FORWARD, **PER_BACKWARD}
        check(counts == routed({k: TEL17_STEPS * per_step.get(k, 0) for k in counts}),
              f"17a: every kernel ran once per call per step under telemetry ({counts})")
        for name in TEL17_FILES:
            path = os.path.join(tel, name)
            check(os.path.exists(path), f"17a: {name} written")
            (_jsonl if name.endswith(".jsonl") else lambda p: json.load(open(p)))(path)
        for path in (prom, reg, os.path.join(run_dir, "train_log.jsonl")):
            check(os.path.exists(path) and os.path.getsize(path) > 0, f"17a: {path} written")
        diag = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "diagnose_run.py"), tel, "--json"], capture_output=True,
            text=True, timeout=120)
        check(diag.returncode == 0, f"17a: scripts/diagnose_run.py --json exits 0 "
                                    f"({diag.stderr[-400:]})")
        report = json.loads(diag.stdout)
        gp = hist["goodput"]
        accounted = gp["productive_s"] + sum(gp["badput_s"].values())
        wall = fit_wall[0]
        check(abs(accounted - wall) <= 0.05 * wall,
              f"17a: productive + badput {accounted:.3f} s within 5% of the fit's {wall:.3f} s")
        peak = device_peak_flops(dev)
        mfus = [m for m in hist["mfu"] if m is not None]
        check(peak is not None and len(mfus) == len(hist["mfu"]) and all(0 < m < 1 for m in mfus),
              f"17a: MFU reported against the card's peak ({peak}) and in (0, 1): {hist['mfu']}")
        rows = read_registry(os.path.join(tel, "programs.jsonl"))
        check([r["kind"] for r in rows] == ["train_step"] and rows[0]["flops_jaxpr"] > 0,
              f"17a: one program row for the train step ({[r['kind'] for r in rows]})")
        # the card's count holds flash's backward products, which autograd
        # runs on its device thread: the same step at batch 1 counted on the
        # CPU, where every product runs on the caller's thread, x the batch
        cpu_run = make_run(with_flags(cli_args(os.path.join(root, "cpu"), 1, "cpu"),
                                      batch_size=1, dtype="float32"))
        stream = cpu_run.batches(0)
        cpu_flops = model_flops(cpu_run.trainer.train_step, next(stream))
        stream.close()
        del cpu_run, stream
        check(rows[0]["flops_jaxpr"] == TRAIN_BATCH * cpu_flops,
              f"17a: the train step's {rows[0]['flops_jaxpr']:.6g} FLOPs on the card equal "
              f"{TRAIN_BATCH} x its {cpu_flops:.6g} at batch 1 on the CPU")
        dev_rows = [r for r in _jsonl(os.path.join(tel, "devprof.jsonl"))
                    if r.get("type") == "devprof"]
        check(len(dev_rows) == 1, f"17a: one device-profile window ({len(dev_rows)})")
        row = dev_rows[0]
        fam_ms = sum(v["ms"] for v in row["families"].values())
        check(abs(fam_ms - row["device_total_ms"]) <= 0.01 * max(row["device_total_ms"], 1e-9),
              f"17a: the window's family sums {fam_ms:.3f} ms equal its kernel total "
              f"{row['device_total_ms']:.3f} ms")
        phases = [r for r in _jsonl(os.path.join(tel, "telemetry.jsonl"))
                  if r.get("type") == "step_phases"]
        split = {k: sum(r.get(k, 0.0) for r in phases)
                 for k in ("host", "device", "data_wait", "checkpoint", "profile", "other")}
        best = ModelRegistry(reg).best_run("loss")
        check(best is not None and best["run"] == "phase17" and best["step"] == TEL17_STEPS,
              "17a: the run is recorded in the registry at its last step")
        windows = [TRAIN_BATCH * 1e3 / ips for ips in hist["imgs_per_sec"]]
        total = max(sum(split.values()), 1e-9)
        res = {"fit_wall_s": wall, "goodput": gp, "accounted_s": accounted,
               "goodput_fraction": gp["productive_s"] / accounted, "window_ms_per_step": windows,
               # the windows after the compile window and the profiled one
               "ms_per_step": float(np.median(windows[2:])),
               "phase10_ms_per_step": phase10["fit"]["ms_per_step"], "mfu": hist["mfu"],
               "peak_flops": peak, "phase_split_s": split,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "devprof": {k: row.get(k) for k in ("status", "device_events", "device_total_ms",
                                                     "device_ms_per_step", "families",
                                                     "top_other_ms", "measured_mfu",
                                                     "roofline_verdict", "steps")},
               "program": {k: rows[0].get(k) for k in ("compile_ms", "flops_jaxpr",
                                                       "measured_mfu", "hbm_peak_bytes")},
               "report_keys": sorted(report), "launches": counts}
        top = sorted(row["families"].items(), key=lambda kv: -kv[1]["ms"])[:5]
        log(f"  17a: {res['ms_per_step']:.3f} ms per step with telemetry (windows "
            + " ".join(f"{x:.3f}" for x in windows) + f"; phase 10 without: "
            f"{res['phase10_ms_per_step']:.3f}), goodput {res['goodput_fraction']:.1%} of "
            f"{accounted:.3f} s (fit wall {wall:.3f} s; badput "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(gp["badput_s"].items()))
            + "), phases " + ", ".join(f"{k} {v / total:.1%}" for k, v in split.items())
            + ", MFU " + " ".join(f"{m:.3f}" for m in mfus) + f" of {peak} FLOP/s, peak "
            f"{res['peak_mem_gib']:.2f} GiB; devprof window {row['status']}, "
            f"{row['device_events']} kernels, {row['device_total_ms']:.3f} ms over "
            f"{row['steps']} steps, measured MFU {row.get('measured_mfu')}; top families "
            + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in top))
    finally:
        train.make_run = make_run
        shutil.rmtree(root, ignore_errors=True)
    return res


def serving_telemetry(dev) -> dict:
    """17b (see the module docstring)."""
    import tempfile

    from flaxdiff_tpu_torch import resilience as R
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.serving import SampleRequest, SchedulerConfig, ServingScheduler
    from flaxdiff_tpu_torch.telemetry import (DeviceProfiler, Telemetry, list_incidents,
                                              read_registry)

    model, _, _ = serving_model(dev, random_state(Unet(**UNET, device="cpu"), 0))
    pipe = serving15_pipeline(dev, model, RESOLUTION, 3, CosineNoiseSchedule(1000),
                              EpsilonPredictionTransform())
    reqs = [SampleRequest(**dict(MIX15[i % 3], diffusion_steps=SERVE17_STEPS, sampler="ddim",
                                 seed=171 + i)) for i in range(4)]
    root = tempfile.mkdtemp(prefix="flaxdiff_serve17_")
    res: dict = {}
    try:
        with R.use_event_log(R.EventLog("phase17")), preclip():
            solos = [solo15(pipe, r) for r in reqs]
            tel = Telemetry.create(os.path.join(root, "tel"))
            prof = DeviceProfiler(tel.devprof_path, window=1, metrics=tel.registry)
            prof.arm()
            cfg = SchedulerConfig(round_steps=SERVE17_ROUND, batch_buckets=(1, 4))
            sched = ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False,
                                     config=cfg, profiler=prof)
            reset_counts()
            futs = [sched.submit(r) for r in reqs[:3]]
            sched.start()
            outs = [f.result(timeout=600) for f in futs]
            outs.append(sched.submit(reqs[3]).result(timeout=600))
            sched.close()
            torch.cuda.synchronize()
            if prof.active():          # a retried window with no round left to close it
                prof.close()
            counts = launch_counts()
            misses = tel.registry.snapshot()["serving/program_cache_misses"]
            rows = read_registry(os.path.join(root, "tel", "programs.jsonl"))
            check(len(rows) == misses and misses >= 2,
                  f"17b: one program row per cache miss ({len(rows)} rows, {misses:.0f} misses)")
            check(all(r["flops_jaxpr"] and r["flops_jaxpr"] > 0 for r in rows),
                  "17b: every program row carries its model FLOPs")
            bit = [bool(np.array_equal(o.samples, s)) for o, s in zip(outs, solos)]
            check(all(bit), f"17b: every request bit-equal to its solo call ({bit})")
            check(all(counts[k] > 0 for k in ("flash_fwd", "geglu", "gn_stats", "gn_norm",
                                               "bi_gemm", "bi_conv")),
                  f"17b: the served route ran its kernels ({counts})")
            res.update(programs=len(rows), misses=misses, bit_equal=sum(bit),
                       kinds=sorted({r["kind"] for r in rows}), launches=counts,
                       devprof=[{k: r.get(k) for k in ("status", "device_events",
                                                       "device_total_ms", "families")}
                                for r in prof.rows],
                       compile_ms={r["kind"] + ":" + r["key"].split(",")[1]: r["compile_ms"]
                                   for r in rows})
            # a forced rebuild: the device lost at the first round
            plan = R.FaultPlan([R.FaultSpec("serving.device_lost", at=(1,), times=1,
                                            error="flag")], seed=0)
            sched = ServingScheduler(pipeline=pipe, telemetry=tel, autostart=False, config=cfg)
            with plan.installed():
                futs = [sched.submit(r) for r in reqs]
                sched.start()
                again = [f.result(timeout=600) for f in futs]
                sched.close()
            tel.close()
            incidents = [os.path.basename(p) for p in list_incidents(os.path.join(root, "tel"))]
            rebuilds = tel.registry.snapshot().get("serving/supervisor_rebuilds", 0)
            check(rebuilds == 1 and incidents == ["incident-001-engine_rebuild.json"],
                  f"17b: one rebuild, one incident bundle ({rebuilds}, {incidents})")
            bit = [bool(np.array_equal(o.samples, s)) for o, s in zip(again, solos)]
            check(all(bit), f"17b: every request across the rebuild bit-equal to its solo call")
            with open(list_incidents(os.path.join(root, "tel"))[0]) as f:
                bundle = json.load(f)
            res.update(incidents=incidents, rebuilds=rebuilds,
                       bundle={"records": len(bundle["records"]), "ledger": len(bundle["ledger"]),
                               "trace_ids": len(bundle["trace_ids"])})
        log(f"  17b: {res['programs']} program rows for {res['misses']:.0f} cache misses "
            f"({res['kinds']}), first-call ms {res['compile_ms']}, {res['bit_equal']} of "
            f"{len(reqs)} requests bit-equal to their solo calls; the armed profiler's window "
            f"{res['devprof']}; a forced rebuild: {res['incidents']} ({res['bundle']})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del model, pipe
    return res


def ae_trainer(dev, dtype=None):
    from flaxdiff_tpu_torch.models import KLAutoEncoder
    from flaxdiff_tpu_torch.trainer import AdamW, AutoEncoderTrainer, AutoEncoderTrainerConfig
    vae = KLAutoEncoder.create(AE17_SEED, **AE17, dtype=dtype, device=dev)
    return AutoEncoderTrainer(vae, AdamW(AE17_LR), AutoEncoderTrainerConfig(kl_weight=1e-6),
                              device=dev)


def autoencoder_training(dev) -> dict:
    """17c (see the module docstring)."""
    from flaxdiff_tpu_torch.models.common import FusedGroupNormSiLU
    from flaxdiff_tpu_torch.ops import launch_counts

    # f32, card against CPU: the loss and every gradient with the same noise
    rng = np.random.default_rng(AE17_SEED)
    x = torch.from_numpy(rng.uniform(-1, 1, (AE17_CHECK_BATCH, AE17_CHECK_SIDE,
                                             AE17_CHECK_SIDE, 3)).astype(np.float32))
    out = {}
    for where in (dev, torch.device("cpu")):
        t = ae_trainer(where)
        noise = torch.from_numpy(rng.standard_normal(t.noise_shape(x)).astype(np.float32)) \
            if where == dev else out[dev][2]
        loss, _, _ = t.loss(x.to(where), noise.to(where))
        out[where] = (float(loss.detach()), t.state.grads(loss).cpu(), noise)
        layout = t.state.layout
    (gl, gg, _), (cl, cg, _) = out[dev], out[torch.device("cpu")]
    rel = abs(gl - cl) / abs(cl)
    worst = max(float((gg[o:o + s.numel()] - cg[o:o + s.numel()]).abs().max())
                / max(float(cg[o:o + s.numel()].abs().max()), 1e-30) for _, o, s in layout)
    log(f"  17c card vs CPU f32, batch {AE17_CHECK_BATCH} at {AE17_CHECK_SIDE}^2: loss {gl:.6f} / "
        f"{cl:.6f} ({rel:.2e} relative), worst gradient {worst:.2e} of its max|g|")
    check(rel <= 1e-5, f"17c: the loss within 1e-5 relative ({rel:.3g})")
    check(worst <= 1e-3, f"17c: every gradient within 1e-3 of its max|g| ({worst:.3g})")

    trainer = ae_trainer(dev, "bfloat16")
    per = sum(isinstance(m, FusedGroupNormSiLU) for m in trainer.state.model.modules())
    batches = [{"sample": torch.from_numpy(np.random.default_rng(i).integers(
        0, 256, (AE17_BATCH, AE17_SIDE, AE17_SIDE, 3), dtype=np.uint8)).to(dev)}
        for i in range(4)]
    losses = [trainer.train_step(batches[i % 4])["loss"] for i in range(AE17_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(AE17_TIMED):
        losses.append(trainer.train_step(batches[i % 4])["loss"])
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / AE17_TIMED
    counts = launch_counts()
    losses = torch.stack(losses).cpu().tolist()
    expected = {k: per * AE17_TIMED if k in ("gn_stats", "gn_norm", "gn_bwd_stats", "gn_bwd_dx")
                else 0 for k in counts}
    check(counts == expected, f"17c: B4-B7 once per GroupNorm call per step ({counts}, "
                              f"expected {expected})")
    check(all(math.isfinite(v) for v in losses), "17c: every loss finite")
    res = {"ms_per_step": ms, "images_per_s": AE17_BATCH * 1e3 / ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "losses": losses,
           "launches": counts, "gn_calls_per_forward": per, "card_vs_cpu":
               {"loss_rel": rel, "worst_grad_of_max": worst}}
    log(f"  17c: KL autoencoder {AE17['block_channels']} at {AE17_SIDE}^2, batch {AE17_BATCH}, "
        f"bf16: {ms:.3f} ms per step, {res['images_per_s']:.1f} images/s, peak "
        f"{res['peak_mem_gib']:.2f} GiB; launches {counts}")
    del trainer
    return res


def telemetry_paths(dev, phase10: dict) -> dict:
    """Phase 17: 17a, 17b, 17c, each with its own phase_s."""
    out, t = {}, time.perf_counter()
    for key, fn in (("cli", lambda: telemetry_cli_path(dev, phase10)),
                    ("serving", lambda: serving_telemetry(dev)),
                    ("autoencoder", lambda: autoencoder_training(dev))):
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return out


# --- phase 18: data, FSDP and sequence parallelism on one card ----------------------

# 18a: phase 10's CLI cell for MESH18_STEPS steps, saving at MESH18_SAVE, with
# and without a one-rank mesh, and a resume under the mesh from MESH18_SAVE
MESH18_STEPS, MESH18_SAVE = 10, 5
MESH18_FLAGS = {"mesh_data": 1, "mesh_fsdp": 1, "mesh_seq": 1}
# 18b: the ring's hop loop over RING18_HOPS sequence shards in one process,
# at UNet-text-256's level-2 self-attention and UNet3D-T2V's level-0 spatial
# self-attention (head dim 80, padded to 128 as the dispatch pads it), and
# one f32 case
RING18_HOPS = 4
RING18_CASES = {"unet_text_256_level2_self": ((2, 4096, 8, 64), BF16),
                "unet3d_t2v_level0_spatial": ((32, 1024, 4, 80), BF16),
                "f32": ((2, 1024, 8, 64), F32)}
# 18c: phase 7's DiT-B/2 step and phase 4's CFG call under C7's backends
C7_STEP_BACKENDS = ("ring", "ulysses")


def one_rank_group(dev) -> None:
    """A one-rank NCCL process group on this card (the CLI and the trainer
    then run their collectives through NCCL)."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)


def mesh18_cli(dev, per_step: dict) -> dict:
    """18a: the CLI's run with the mesh flags on a one-rank NCCL group, bit
    for bit the run without them (every loss; the final params, EMA and
    both moments), and a resume under the mesh bit for bit the
    uninterrupted run."""
    import tempfile

    import torch.distributed as dist

    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.trainer import Checkpointer

    root = tempfile.mkdtemp(prefix="flaxdiff_mesh_")
    res = {}
    args = lambda d: with_flags(cli_args(d, MESH18_STEPS, dev), save_every=MESH18_SAVE,
                                log_every=1)
    meshed = lambda d: with_flags(args(d), **MESH18_FLAGS)

    def ms_per_step(hist):
        # windows of one step; the first holds the warm-up
        return float(np.median([TRAIN_BATCH * 1e3 / ips for ips in hist["imgs_per_sec"][1:]]))

    try:
        plain, mesh, resumed = (os.path.join(root, n) for n in ("plain", "mesh", "resumed"))
        hist_plain = train.main(args(plain))
        one_rank_group(dev)
        try:
            reset_counts()
            hist_mesh = train.main(meshed(mesh))
            torch.cuda.synchronize()
            counts = launch_counts()
            copy_run(mesh, resumed, MESH18_SAVE)
            hist_resumed = train.main(meshed(resumed))
            check(dist.is_initialized(), "the CLI left the caller's process group alone")
        finally:
            dist.destroy_process_group()
        check(counts == routed({k: MESH18_STEPS * per_step.get(k, 0) for k in counts}),
              "the mesh run launched every forward and backward kernel once per call per step")
        final = lambda d: Checkpointer(d).restore(MESH18_STEPS)[0]
        a, b, c = final(plain), final(mesh), final(resumed)
        names = ("params", "ema", "exp_avg", "exp_avg_sq")
        res = {"losses_plain": hist_plain["loss"], "losses_mesh": hist_mesh["loss"],
               "losses_resumed": hist_resumed["loss"],
               "ms_per_step_plain": ms_per_step(hist_plain),
               "ms_per_step_mesh": ms_per_step(hist_mesh), "launches": counts,
               "mesh_diff": {k: float((a[k] - b[k]).abs().max()) for k in names},
               "resume_diff": {k: float((b[k] - c[k]).abs().max()) for k in names}}
        log(f"  losses without / with the mesh: " + " ".join(f"{x:.5f}" for x in hist_plain["loss"])
            + " / " + " ".join(f"{x:.5f}" for x in hist_mesh["loss"]))
        log(f"  {res['ms_per_step_plain']:.3f} ms per step without the mesh, "
            f"{res['ms_per_step_mesh']:.3f} with it (median of steps 2-{MESH18_STEPS}); "
            f"largest differences {res['mesh_diff']}, the resume's {res['resume_diff']}")
        check(hist_mesh["loss"] == hist_plain["loss"] and len(hist_mesh["loss"]) == MESH18_STEPS,
              "every loss of the mesh run equals the run without it")
        check(all(torch.equal(a[k], b[k]) for k in names),
              "the mesh run's params, EMA and moments equal the run without it bit for bit")
        check(hist_resumed["loss"] == hist_mesh["loss"][MESH18_SAVE:]
              and all(torch.equal(b[k], c[k]) for k in names),
              "the resume under the mesh equals the uninterrupted run bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def ring18(dev) -> dict:
    """18b: the ring's hop loop (parallel/ring_attention.py, the in-process
    transport: one process holds the 4 shards) forward and backward, against
    one flash call over the whole sequence and its backward."""
    from flaxdiff_tpu_torch.ops import launch_counts
    from flaxdiff_tpu_torch.ops.flash_attention import (_kernels, flash_delta, padded_head_dim)
    from flaxdiff_tpu_torch.parallel import InProcessTransport, ring_backward, ring_forward

    gen = torch.Generator(device=dev).manual_seed(18)
    transport = InProcessTransport(RING18_HOPS)
    res, launches = {}, {k: 0 for k in launch_counts()}
    for label, ((b, s, h, d), dtype) in RING18_CASES.items():
        width = padded_head_dim(d)
        # the dispatch's zero padding of the head dim, at the true dim's scale
        pad = lambda t: torch.nn.functional.pad(t, (0, width - d))
        q, k, v, do = (pad(torch.randn(b, s, h, d, generator=gen, device=dev, dtype=dtype))
                       for _ in range(4))
        scale = d ** -0.5
        fwd, bwd_dq, bwd_dkv = _kernels(width)
        split = lambda t: list(t.chunk(RING18_HOPS, dim=1))

        def single():
            out, lse = fwd(q, k, v, scale)
            delta = flash_delta(out, do)
            return (out, lse, bwd_dq(q, k, v, do, lse, delta, scale),
                    *bwd_dkv(q, k, v, do, lse, delta, scale))

        def ring():
            outs, lses = ring_forward(split(q), split(k), split(v), transport, scale)
            grads = ring_backward(split(q), split(k), split(v), outs, lses, split(do), transport,
                                  scale)
            return (torch.cat(outs, 1), torch.cat(lses, 2), *(torch.cat(g, 1) for g in grads))

        want = single()
        torch.cuda.synchronize()
        reset_counts()
        got = ring()
        torch.cuda.synchronize()
        if dtype != F32:
            for name, n in launch_counts().items():
                launches[name] += n
        names = ("out", "lse", "dq", "dk", "dv")
        readings = {}
        for name, x, y in zip(names, got, want):
            x, y = x[..., :d] if x.ndim == 4 else x, y[..., :d] if y.ndim == 4 else y
            if name == "lse":
                readings[name] = {"max_abs_err": max_err(x, y)}
            elif dtype == F32:
                readings[name] = compare(x, y, atol=1e-5 * float(y.abs().max()), rtol=1e-5,
                                         rms_rel=1e-5)
            elif name == "out":
                # flash's forward limits (phase 2)
                readings[name] = compare(x, y, atol=4e-3, rtol=BF16_RTOL, rms_rel=1e-2)
            else:
                # flash's backward limits (4e-3 of the largest, RMS 1e-3) for each
                # of the hops: every hop's kernels round their partial gradient
                # to bf16 before the f32 sum, one bf16 rounding a hop where the
                # single call makes one in all (as the JAX package's ring does)
                readings[name] = compare(x, y, atol=RING18_HOPS * 4e-3 * float(y.float().abs().max()),
                                         rtol=BF16_RTOL, rms_rel=RING18_HOPS * 1e-3)
        for name, r in readings.items():
            log(f"  ring {label} {(b, s, h, d)} {dtype}: {name} " + (
                f"max err {r['max_abs_err']:.3g}" if name == "lse" else
                f"least atol {r['least_atol']:.3g} (atol {r['atol']:.3g}), rms rel "
                f"{r['rms_rel']:.3g} (limit {r['rms_rel_limit']:.3g})"))
            if name == "lse":
                check(r["max_abs_err"] <= 1e-4, f"ring {label}: lse within 1e-4 of the single call")
            else:
                check(passes(r), f"ring {label} {name}: {r}")
        del got, want
        case = {"shape": [b, s, h, d], "padded": width, "dtype": str(dtype).split(".")[-1],
                "readings": readings}
        if dtype != F32:
            case["ring_ms"] = graph_ms(ring, 1)
            case["single_ms"] = graph_ms(single, 1)
            log(f"  ring {label}: {RING18_HOPS}-hop loop {case['ring_ms']:.3f} ms device, one flash "
                f"call {case['single_ms']:.3f} ms (forward and backward each)")
        res[label] = case
        del q, k, v, do
        torch.cuda.empty_cache()
    hops2 = 2 * RING18_HOPS * RING18_HOPS      # two bf16 shapes, n shards x n hops
    expected = {k: 0 for k in launches}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        expected[name] = hops2
    log(f"  ring launches {launches}, expected {expected}")
    check(launches == expected, "the hop loop launched each flash kernel once per shard per hop")
    res["launches"] = launches
    return res


def c7_paths(dev) -> dict:
    """18c: phase 7's DiT-B/2 step with backend "ring" and "ulysses" under a
    one-rank mesh, bit for bit "auto" without one (the gate stays shut at
    one seq rank); phase 4's CFG call with "prebuilt" bit for bit "xla",
    and with "performer" finite."""
    import warnings

    import torch.distributed as dist

    from flaxdiff_tpu_torch.models import SimpleDiT, Unet
    from flaxdiff_tpu_torch.parallel import create_mesh
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import LinearNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer, TrainerConfig

    res = {}
    rng = np.random.default_rng(7)
    batch = {"sample": torch.from_numpy(rng.standard_normal(
        (DIT_TRAIN_BATCH, DIT_RES, DIT_RES, DIT_CH)).astype(np.float32)).to(dev),
        "cond": torch.from_numpy(rng.standard_normal(
            (DIT_TRAIN_BATCH, TEXT_LEN, TEXT_DIM)).astype(np.float32)).to(dev)}
    dit_state = random_state(SimpleDiT(**DIT, device="cpu"), 1)

    def dit_step(backend, mesh):
        model = SimpleDiT(**DIT, backend=backend, dtype="bfloat16", device=dev)
        model.load_state_dict(dit_state)
        trainer = DiffusionTrainer(
            model, AdamW(TRAIN_LR), LinearNoiseSchedule(1000), EpsilonPredictionTransform(),
            TrainerConfig(normalize=False, seed=0), null_cond=torch.zeros(1, TEXT_LEN, TEXT_DIM),
            device=dev, mesh=mesh)
        loss = trainer.train_step(batch)
        out = {k: v.clone() for k, v in trainer.state.buffers().items()}
        out["loss"] = loss
        del trainer, model
        return out

    auto = dit_step("auto", None)
    one_rank_group(dev)
    try:
        mesh = create_mesh({"data": 1, "fsdp": 1, "seq": 1, "tensor": 1})
        for backend in C7_STEP_BACKENDS:
            got = dit_step(backend, mesh)
            same = {k: bool(torch.equal(got[k], auto[k])) for k in auto}
            res[f"dit_step_{backend}"] = same
            log(f"  DiT-B/2 step, backend {backend} under a one-rank mesh: bit-equal to auto "
                f"{all(same.values())} (loss {float(got['loss']):.6f})")
            check(all(same.values()), f"the {backend} DiT step equals auto bit for bit: {same}")
            del got
    finally:
        dist.destroy_process_group()
    del auto
    torch.cuda.empty_cache()

    unet_state = random_state(Unet(**UNET, device="cpu"), 0)
    x = torch.from_numpy(rng.standard_normal((SERVE_BATCH, RESOLUTION, RESOLUTION, 3)).astype(
        np.float32)).to(dev)
    t = torch.full((SERVE_BATCH,), 500.0, device=dev)
    ctx = torch.from_numpy(rng.standard_normal((SERVE_BATCH, TEXT_LEN, TEXT_DIM)).astype(
        np.float32)).to(dev)
    ctx[1:] = 0.0                  # the CFG call's conditional and null rows

    def cfg_call(backend):
        cfg = dict(UNET, attention_configs=tuple(
            None if a is None else dict(a, backend=backend) for a in UNET["attention_configs"]))
        model = Unet(**cfg, dtype="bfloat16", device=dev)
        model.load_state_dict(unet_state)
        model.eval()
        with torch.inference_mode(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = model(x, t, ctx)
        torch.cuda.synchronize()
        del model
        return out, caught

    xla, _ = cfg_call("xla")
    prebuilt, caught = cfg_call("prebuilt")
    performer, _ = cfg_call("performer")
    res["prebuilt_equals_xla"] = bool(torch.equal(prebuilt, xla))
    res["prebuilt_warned"] = any("prebuilt" in str(w.message) for w in caught)
    res["performer_finite"] = bool(torch.isfinite(performer).all())
    log(f"  UNet-text-256 CFG call: prebuilt bit-equal to xla {res['prebuilt_equals_xla']} "
        f"(warned {res['prebuilt_warned']}), performer finite {res['performer_finite']} "
        f"(max |out - xla| {max_err(performer, xla):.3g})")
    check(res["prebuilt_equals_xla"] and res["prebuilt_warned"],
          "prebuilt warns and equals xla bit for bit")
    check(res["performer_finite"] and performer.shape == xla.shape, "performer's call is finite")
    return res


def parallel_paths(dev) -> dict:
    """Phase 18 (see the module docstring)."""
    out = {}
    for key, fn in (("mesh_cli", lambda: mesh18_cli(dev, {**PER_FORWARD, **PER_BACKWARD})),
                    ("ring", lambda: ring18(dev)), ("c7", lambda: c7_paths(dev))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


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
    """Device time of one call by kernel family, from torch.profiler, named
    by the package's own classifier (``telemetry.devprof.kernel_family``).
    The profiler's CUPTI tracing sometimes delivers no device events at all;
    this breakdown only explains the busy time measured above, so it is then
    reported as not measured instead of failing the run."""
    from torch.profiler import ProfilerActivity, profile

    from flaxdiff_tpu_torch.telemetry.devprof import summarize_kernels

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
    summary = summarize_kernels((ev.name, ev.time_range.elapsed_us(), None, None)
                                for ev in events)
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])
    by_family = {f: v["us"] / 1e3 for f, v in summary["families"].items()}
    out = {"kernels": summary["device_events"], "ms_by_family": top(by_family, len(by_family)),
           "top_other_ms": {k: v / 1e3 for k, v in top(summary["top_other_us"], 8).items()}}
    log(f"  profiler: {out['kernels']} kernels, {sum(by_family.values()):.3f} ms; "
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
    starts = {}
    stamp = lambda phase: starts.setdefault(phase, time.perf_counter())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    stamp("1")
    log(f"phase 1: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    log(f"  built {lib.name} in {build_s:.1f} s")
    # the packed-record reader and the PNG unfilter (phase 16), with g++
    from flaxdiff_tpu_torch import native
    t1 = time.perf_counter()
    native.library()
    native_build_s = time.perf_counter() - t1
    log(f"  built {native.build().name} in {native_build_s:.1f} s")
    ptxas = log_registers((lib.parent / "build.log").read_text())
    hgmma = log_hgmma(lib)
    install_route_census()

    stamp("2")
    log("phase 2: kernels against their plain versions")
    cases, yardsticks = kernel_cases(dev, peaks(name))
    torch.cuda.empty_cache()

    from flaxdiff_tpu_torch.models import Unet
    unet_state = random_state(Unet(**UNET, device="cpu"), 0)
    stamp("3")
    log("phase 3: full-width UNet, card against CPU")
    model_res = model_checks(dev, unet_state)
    model_res["wide_block"] = wide_block_check(dev, WIDE_LEVEL)
    # the wide kernels' path: UNET3D_LEVEL's block, its launches counted
    model_res["unet3d_block"] = wide_block_check(dev, UNET3D_LEVEL, UNET3D_BLOCK)
    torch.cuda.empty_cache()

    stamp("4")
    log(f"phase 4: DDIM-{STEPS} + CFG {GUIDANCE} at {RESOLUTION}x{RESOLUTION}, bf16")
    traj = main_path(dev, unet_state)
    log(f"trajectory: DDIM-{STEPS} CFG {GUIDANCE} {RESOLUTION}x{RESOLUTION} batch 1 bf16 "
        f"wall {traj['wall_s']:.3f} s ({traj['ms_per_forward']:.2f} ms per forward), "
        f"peak {traj['peak_mem_gib']:.2f} GiB on {smi}")
    torch.cuda.empty_cache()

    stamp("5")
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
    stamp("3b")
    log("phase 3b: full-width DiT-B/2, card against CPU")
    dit_res = dit_model_checks(dev, state)
    torch.cuda.empty_cache()

    stamp("6")
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

    stamp("7")
    log(f"phase 7: DiT-B/2 DiffusionTrainer.train_step, batch {DIT_TRAIN_BATCH} of "
        f"{DIT_RES}x{DIT_RES}x{DIT_CH}, bf16, {WARMUP} + {TIMED} steps")
    dit_train = dit_training_path(dev)
    log(f"DiT training: batch {DIT_TRAIN_BATCH} bf16 {dit_train['ms_per_step']:.3f} ms per step, "
        f"{dit_train['samples_per_s']:.1f} latents/s, peak {dit_train['peak_mem_gib']:.2f} GiB, "
        f"busy {dit_train.get('busy_ms', float('nan')):.3f} ms "
        f"({dit_train.get('idle_share', float('nan')):.0%} idle) on {smi}")

    torch.cuda.empty_cache()

    stamp("8")
    log(f"phase 8: every sampler, {SAMPLER_STEPS} steps + CFG {GUIDANCE} at {RESOLUTION}x{RESOLUTION}, "
        f"bf16")
    t8 = time.perf_counter()
    samplers_res = sampler_paths(dev, unet_state)
    samplers_res["phase_s"] = time.perf_counter() - t8
    for request, r in samplers_res["requests"].items():
        log(f"sampler {request}: {r['model_calls']} calls, wall {r['wall_s']:.3f} s "
            f"({r['ms_per_call']:.2f} ms per call) on {smi}")
    del unet_state
    torch.cuda.empty_cache()

    stamp("9")
    log(f"phase 9: EDM DiffusionTrainer.train_step, batch {TRAIN_BATCH} at "
        f"{TRAIN_RES}x{TRAIN_RES}, bf16, {WARMUP} + {TIMED} steps")
    t9 = time.perf_counter()
    edm_train = edm_training_path(dev)
    edm_train["phase_s"] = time.perf_counter() - t9
    log(f"EDM training: batch {TRAIN_BATCH} {TRAIN_RES}x{TRAIN_RES} bf16 "
        f"{edm_train['ms_per_step']:.3f} ms per step, {edm_train['images_per_s']:.1f} images/s, "
        f"peak {edm_train['peak_mem_gib']:.2f} GiB on {smi}")

    torch.cuda.empty_cache()

    stamp("10")
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

    stamp("11")
    log(f"phase 11: every model family at full width: card against CPU, DDIM-{STEPS11} + CFG "
        f"{GUIDANCE} in bf16, SimpleMMDiT and the hybrid SSM DiT's train steps, remat, the S5 "
        f"scan")
    t11 = time.perf_counter()
    families = family_paths(dev)
    families["phase_s"] = time.perf_counter() - t11
    for key, r in families["serving"].items():
        bd = r["breakdown"]
        log(f"family {key}: DDIM-{STEPS11} CFG {GUIDANCE} batch 1 bf16 wall {r['wall_s']:.3f} s "
            f"({r['ms_per_forward']:.2f} ms per call), one call busy {bd['busy_ms']:.3f} ms as a "
            f"graph ({bd['idle_share']:.0%} idle) on {smi}")
    mm = families["mmdit_training"]
    log(f"SimpleMMDiT training: batch {DIT_TRAIN_BATCH} bf16 {mm['ms_per_step']:.3f} ms per "
        f"step, {mm['samples_per_s']:.1f} latents/s, peak {mm['peak_mem_gib']:.2f} GiB; phase 11 "
        f"{families['phase_s']:.1f} s on {smi}")

    torch.cuda.empty_cache()

    stamp("12")
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

    torch.cuda.empty_cache()

    stamp("13")
    log(f"phase 13: latent video diffusion, UNet3D at ModelScope T2V's widths over SD VAE "
        f"latents: card against CPU, DDIM-{STEPS13} + CFG {GUIDANCE} decoded, training through the "
        f"codec, the CLI with --autoencoder sd_vae")
    t13 = time.perf_counter()
    t2v = t2v_paths(dev)
    t2v["phase_s"] = time.perf_counter() - t13
    ts, tt = t2v["serving"], t2v["training"]
    log(f"T2V serving: DDIM-{STEPS13} CFG {GUIDANCE} batch 1, {T2V_FRAMES} frames {T2V_SIDE}x"
        f"{T2V_SIDE}x4 bf16, wall {ts['wall_s']:.3f} s ({ts['ms_per_forward']:.2f} ms per call), "
        f"SD VAE decode to {T2V_PIXELS}x{T2V_PIXELS} {ts['decode_ms']:.3f} ms, one call busy "
        f"{ts['breakdown']['busy_ms']:.3f} ms as a graph ({ts['breakdown']['idle_share']:.0%} idle)"
        f", peak {ts['peak_mem_gib']:.2f} GiB on {smi}")
    log(f"T2V training: {tt['batch_clips']} clips of {T2V_FRAMES} x {T2V_PIXELS}x{T2V_PIXELS} "
        f"bf16 {tt['ms_per_step']:.3f} ms per step, {tt['clips_per_s']:.2f} clips/s, peak "
        f"{tt['peak_mem_gib']:.2f} GiB; phase 13 {t2v['phase_s']:.1f} s on {smi}")

    torch.cuda.empty_cache()

    stamp("14")
    log(f"phase 14: the training-free caches on DiT-B/2, SimpleUDiT and SimpleMMDiT (card against "
        f"CPU, DDIM-{STEPS14} + CFG {GUIDANCE} under docs/CACHING.md's plans), PSNR, SSIM, FID with "
        f"InceptionV3, the CLI's --val_metrics")
    t14 = time.perf_counter()
    cache = cache_paths(dev, families["serving"])
    cache["phase_s"] = time.perf_counter() - t14
    for key in CACHED_FAMILIES:
        for plan, r in cache["serving"][key].items():
            log(f"cache {key} {plan}: DDIM-{STEPS14} CFG {GUIDANCE} bf16 wall {r['wall_s']:.3f} s "
                f"({r['ms_per_call']:.2f} ms per call), busy "
                + ("not measured" if r["busy_ms"] is None else
                   f"{r['busy_ms']:.3f} ms ({r['idle_share']:.0%} idle)")
                + f", PSNR {r['psnr_db']:.2f} dB on {smi}")
    mt = cache["metrics"]
    log(f"metrics: Inception batch {INCEPTION_BATCH} {mt['inception']['ms']:.3f} ms "
        f"({mt['inception']['busy_ms']:.3f} busy), FID of {FID_SAMPLES} {mt['fid']['total_s']:.3f} s "
        f"(sqrtm {mt['fid']['sqrtm_share']:.0%}); phase 14 {cache['phase_s']:.1f} s on {smi}")

    torch.cuda.empty_cache()

    stamp("15")
    log(f"phase 15: the serving subsystem: phase 4's UNet behind ServingScheduler (bucket "
        f"identity, a seeded Poisson replay twice, chaos, two replicas behind the FrontDoor) and "
        f"DiT-B/2 under the composed plan")
    t15 = time.perf_counter()
    serving = serving_paths(dev, traj)
    serving["phase_s"] = time.perf_counter() - t15
    rp = serving["replay"]["replays"][1]
    r8 = serving["replay"]["bucket8_round"]
    log(f"serving: warm replay of {SERVE15_REQUESTS} requests at {SERVE15_RATE} Hz, latency p50 "
        f"{rp['summary']['latency_ms']['p50']:.1f} ms p99 {rp['summary']['latency_ms']['p99']:.1f} "
        f"ms, {rp['summary']['throughput_rps']:.3f} requests/s, occupancy {rp['occupancy']:.3f}; "
        f"a bucket-8 round {r8['wall_ms']:.1f} ms wall, busy "
        + ("not measured" if r8["busy_ms"] is None else
           f"{r8['busy_ms']:.1f} ms ({r8['idle_share']:.0%} idle)")
        + f"; phase 15 {serving['phase_s']:.1f} s on {smi}")

    torch.cuda.empty_cache()

    stamp("16")
    log(f"phase 16: the packed-shard data feed: phase 10's CLI over {DATA16_SHARDS} shards of "
        f"{DATA16_PER_SHARD} PNG images, a resume")
    t16 = time.perf_counter()
    data = data_paths(dev, {**PER_FORWARD, **PER_BACKWARD}, cli)
    data["phase_s"] = time.perf_counter() - t16
    log(f"data feed: fit over packed shards {data['fit']['images_per_s']:.1f} images/s (phase "
        f"10's synthetic source {cli['fit']['images_per_s']:.1f}), the reader "
        f"{data['shards']['decoded_records_per_s']:.0f} decoded records/s on one host thread; "
        f"phase 16 {data['phase_s']:.1f} s on {smi}")

    stamp("17")
    log(f"phase 17: the run's telemetry: phase 10's CLI with every telemetry flag and a device-"
        f"profile window, phase 4's UNet served under an enabled hub with a forced rebuild, the KL "
        f"autoencoder trainer at {AE17['block_channels']}")
    tel17 = telemetry_paths(dev, cli)
    phase17_s = sum(r["phase_s"] for r in tel17.values())
    log(f"phase 17 {phase17_s:.1f} s (17a {tel17['cli']['phase_s']:.1f}, 17b "
        f"{tel17['serving']['phase_s']:.1f}, 17c {tel17['autoencoder']['phase_s']:.1f}) on {smi}")

    torch.cuda.empty_cache()
    stamp("18")
    log(f"phase 18: data, FSDP and sequence parallelism on one card: phase 10's CLI cell on a "
        f"one-rank NCCL mesh, the ring's {RING18_HOPS}-hop loop at full width, C7's backends")
    par18 = parallel_paths(dev)
    phase18_s = sum(r["phase_s"] for r in par18.values())
    m18 = par18["mesh_cli"]
    log(f"mesh CLI: {m18['ms_per_step_mesh']:.3f} ms per step on a one-rank mesh, "
        f"{m18['ms_per_step_plain']:.3f} without (phase 10's fit {cli['fit']['ms_per_step']:.3f}); "
        + "; ".join(f"ring {k} {v['ring_ms']:.3f} ms against one call {v['single_ms']:.3f}"
                    for k, v in par18["ring"].items() if isinstance(v, dict) and "ring_ms" in v)
        + f"; phase 18 {phase18_s:.1f} s (18a {m18['phase_s']:.1f}, 18b "
        f"{par18['ring']['phase_s']:.1f}, 18c {par18['c7']['phase_s']:.1f}) on {smi}")
    check(phase18_s <= 60.0, f"phase 18 within 60 s: {phase18_s:.1f}")
    stamp("end")
    order = list(starts)
    phase_s = {a: starts[b] - starts[a] for a, b in zip(order, order[1:])}
    log("phase_s " + json.dumps({k: round(v, 1) for k, v in phase_s.items()}))

    cache_launches = lambda key: {k: sum(r["launches"][k] for r in cache["serving"][key].values())
                                  for k in REPLACES}
    paths = {"unet_serving": traj, "unet_training": train, "dit_serving": dit_traj,
             "dit_training": dit_train, "unet3d_block_320": model_res["unet3d_block"],
             "unet_samplers": samplers_res, "unet_edm_training": edm_train,
             "unet_cli": cli, "mmdit_training": families["mmdit_training"],
             "unet_cli_f16": options, "unet3d_t2v_serving": t2v["serving"],
             "unet3d_t2v_training": t2v["training"], "unet_cli_latent": t2v["cli"],
             **{f"{key}_serving": r for key, r in families["serving"].items()},
             **{f"{key}_cached_serving": {"launches": cache_launches(key)}
                for key in CACHED_FAMILIES},
             "unet_cli_val_metrics": cache["metrics"]["cli"],
             "unet_serving_scheduler": serving["replay"],
             "dit_cached_serving_scheduler": serving["cached"],
             "unet_cli_packed_shards": data["fit"],
             "unet_cli_telemetry": tel17["cli"], "unet_serving_telemetry": tel17["serving"],
             "autoencoder_training": tel17["autoencoder"],
             "ring": par18["ring"], "mesh_cli": par18["mesh_cli"]}
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
    record = {"device": name, "nvidia_smi": smi, "build_s": build_s,
              "native_build_s": native_build_s, "ptxas": ptxas,
              "hgmma": hgmma,
              "kernels": kernels, "yardsticks": yardsticks,
              "model": model_res, "trajectory": traj, "training": train, "dit_model": dit_res,
              "dit_trajectory": dit_traj, "dit_training": dit_train,
              "samplers": samplers_res, "edm_training": edm_train, "cli": cli,
              "families": families, "options": options, "t2v": t2v, "cache": cache,
              "serving": serving, "data": data, "telemetry": tel17, "parallel": par18,
              "phase_s": phase_s,
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
