#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flaxdiff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Phases; any failure exits non-zero and prints no result line.
  1. Print the card's name and power limit; build the CUDA kernels from
     flaxdiff_tpu_torch/csrc with nvcc for sm_90a.
  2. Hold each kernel against its plain PyTorch version on the card at the
     shapes of the main path (bf16, plus one f32 case with TF32 off), and time
     kernel, plain version and, for attention, torch's
     scaled_dot_product_attention (a yardstick the port never calls) by their
     device time (CUDA graph replays timed by CUDA events), beside the
     byte/flop bound.
  3. The full-width UNet forward at 64x64 in f32, on the card (kernels) and
     on the CPU (plain versions), with the same random weights; then a short
     DDIM + CFG trajectory the same way.
  4. The main path: DDIM-50 with classifier-free guidance (scale 3.0) at
     256x256, batch 1, bf16, full width. The launch counters, zeroed just
     before, must show every attention, GEGLU and GroupNorm call went through
     the kernels.
The lines before the last are the kernels' JSON record and the card's
name and power limit; the last is {"ok": true, "device": {...}}. With
--record, the full record (every case, the model checks, the trajectory
and its per-call breakdown) is also written to PATH as JSON.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
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
# on the way down and up, cross-only in the middle), 19 res blocks x 2 norms
PER_FORWARD = {"flash_fwd": 9, "geglu": 5, "gn_stats": 38, "gn_norm": 38}

REPLACES = {
    "flash_fwd": "flaxdiff_tpu/ops/flash_attention.py:78",
    "gn_stats": "flaxdiff_tpu/ops/fused_norm.py:58",
    "gn_norm": "flaxdiff_tpu/ops/fused_norm.py:85",
    "geglu": "flaxdiff_tpu/ops/fused_adaln.py:500",
}
# the __global__ functions each wrapper launches, as the profiler names them
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_kernel", "gn_stats": "gn_stats_kernel",
                  "gn_norm": "gn_norm_kernel", "geglu": "geglu_kernel"}
SOURCES = {
    "flash_fwd": "flaxdiff_tpu_torch/csrc/flash_fwd.cu",
    "gn_stats": "flaxdiff_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_norm": "flaxdiff_tpu_torch/csrc/groupnorm_silu.cu",
    "geglu": "flaxdiff_tpu_torch/csrc/geglu.cu",
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
    with torch.cuda.graph(graph):
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


# --- phase 2: kernels against their plain versions --------------------------

def kernel_cases(dev, peak):
    from flaxdiff_tpu_torch.ops import flash_attention, fused_geglu
    from flaxdiff_tpu_torch.ops.flash_attention import flash_attention_plain
    from flaxdiff_tpu_torch.ops.fused_adaln import geglu_plain
    from flaxdiff_tpu_torch.ops.fused_norm import (groupnorm_finalize, groupnorm_normalize,
                                                   groupnorm_normalize_plain, groupnorm_stats,
                                                   groupnorm_stats_plain, rows_per_block)
    bf16_rate, f32_rate, byte_rate = peak
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype: torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    cases = []

    def record(name, shape, dtype, reading, call, plain, flops, nbytes, library=None):
        """Print the readings and check them, then time kernel, plain
        version and library call by device time (CUDA graph replays)."""
        rate = f32_rate if dtype == torch.float32 else bf16_rate
        b_ms, b_by = bound_ms(flops, nbytes, rate, byte_rate)
        dname = str(dtype).replace("torch.", "")
        lse = (f", lse err {reading['lse_err']:.3g} (atol {reading['lse_atol']:g})"
               if "lse_err" in reading else "")
        log(f"  {name} {shape} {dname}: max err {reading['max_abs_err']:.3g}, least atol "
            f"{reading['least_atol']:.3g} (atol {reading['atol']:g} at rtol {reading['rtol']:g}), "
            f"rms rel {reading['rms_rel']:.3g} (limit {reading['rms_rel_limit']}){lse}")
        check(passes(reading), f"{name} {shape} {dname}: {reading}")
        ms = graph_ms(call, 20)
        plain_ms = graph_ms(plain, 3, replays=3)
        library_ms = graph_ms(library, 20) if library is not None else None
        case = dict(name=name, shape=list(shape), dtype=dname, **reading, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
            + (f", sdpa {library_ms:.4f} ms" if library_ms is not None else ""))
        cases.append(case)

    # flash attention [B, Lq, H, D] x [B, Lk, H, D], B*H = 16 (CFG batch 2, 8 heads)
    for lq, lk, dtype in [(4096, 4096, torch.bfloat16), (4096, TEXT_LEN, torch.bfloat16),
                          (1024, 1024, torch.bfloat16), (1024, TEXT_LEN, torch.bfloat16),
                          (1024, 1024, torch.float32)]:
        q, k, v = randn(2, lq, 8, 64, dtype=dtype), randn(2, lk, 8, 64, dtype=dtype), \
            randn(2, lk, 8, 64, dtype=dtype)
        out, lse = flash_attention(q, k, v, return_lse=True)
        ref, ref_lse = flash_attention_plain(q, k, v)
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
        record("flash_fwd", (2, lq, lk, 8, 64), dtype, reading,
               lambda: flash_attention(q, k, v), lambda: flash_attention_plain(q, k, v),
               4.0 * 2 * 8 * lq * lk * 64, esz * 2 * 8 * 64 * (2 * lq + 2 * lk),
               library=sdpa)
        del q, k, v, out, ref

    # GroupNorm + SiLU, G = 8: stats and normalize kernels separately
    for hw, c, dtype in [(256 * 256, 64, torch.bfloat16), (64 * 64, 256, torch.bfloat16),
                         (32 * 32, 1024, torch.bfloat16), (64 * 64, 256, torch.float32)]:
        x = randn(2, hw, c, dtype=dtype) * 2.0 + 0.5
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = randn(c, dtype=torch.float32) * 0.1
        part = groupnorm_stats(x, 8)
        ref_part = groupnorm_stats_plain(x, 8, rows_per_block(hw, c))
        torch.cuda.synchronize()
        # f32 sums of 1024 elements a group and block, in another order; the
        # sums are ~500 and the moments ~4000, so one missed row moves them
        # by 1% or more
        reading = compare(part, ref_part, atol=1e-3, rtol=1e-5, rms_rel=1e-5)
        nblk = part.shape[1]
        esz = x.element_size()
        record("gn_stats", (2, hw, c), dtype, reading, lambda: groupnorm_stats(x, 8),
               lambda: groupnorm_stats_plain(x, 8, rows_per_block(hw, c)),
               3.0 * 2 * hw * c, esz * 2 * hw * c + 4 * 2 * nblk * 2 * 8)
        mean, rstd = groupnorm_finalize(ref_part, hw, c, 1e-6)
        out = groupnorm_normalize(x, mean, rstd, scale, bias, True)
        ref = groupnorm_normalize_plain(x, mean, rstd, scale, bias, True)
        torch.cuda.synchronize()
        # the same f32 math up to FMA contraction and expf against torch's
        # sigmoid: a few f32 ulps, then at most one bf16 rounding apart
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
        reading = compare(out, ref, atol=1e-5, rtol=rtol, rms_rel=1e-3)
        record("gn_norm", (2, hw, c), dtype, reading,
               lambda: groupnorm_normalize(x, mean, rstd, scale, bias, True),
               lambda: groupnorm_normalize_plain(x, mean, rstd, scale, bias, True),
               8.0 * 2 * hw * c, 2 * esz * 2 * hw * c + 8 * c + 8 * 2 * 8)
        del x, out, ref

    # GEGLU over the packed [B, L, 2F] projection
    for rows, f2, dtype in [(4096, 2048, torch.bfloat16), (1024, 4096, torch.bfloat16),
                            (1024, 4096, torch.float32)]:
        proj = randn(2, rows, f2, dtype=dtype) * 2.0
        out, ref = fused_geglu(proj), geglu_plain(proj)
        torch.cuda.synchronize()
        # the same f32 math, tanhf against torch's tanh: a few f32 ulps, then
        # at most one bf16 rounding apart
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
        reading = compare(out, ref, atol=1e-5, rtol=rtol, rms_rel=1e-3)
        esz = proj.element_size()
        record("geglu", (2, rows, f2), dtype, reading,
               lambda: fused_geglu(proj), lambda: geglu_plain(proj),
               12.0 * 2 * rows * f2 // 2, esz * 2 * rows * (f2 + f2 // 2))
        del proj, out, ref
    return cases


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
    del models, gpu, cpu
    return {"forward_64_f32_err": err, "forward_64_f32_scale": scale,
            "ddim3_cfg_32_f32_err": err_traj, "ddim3_clipped_share": saturated}


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
    expected = {k: v * (STEPS + 1) for k, v in PER_FORWARD.items()}
    log(f"  launches {counts}, expected {expected}")
    check(counts == expected, "every attention, GEGLU and GroupNorm call ran its kernel")
    check(tuple(out.shape) == (1, RESOLUTION, RESOLUTION, 3), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "samples finite")
    check(float(out.abs().max()) <= 1.0, "samples clipped to [-1, 1]")
    res = {"wall_s": wall, "forwards": STEPS + 1, "ms_per_forward": wall * 1e3 / (STEPS + 1),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "sample_std": float(out.float().std()), "launches": counts}
    res["breakdown"] = forward_breakdown(model, dev, cond, uncond)
    return res


# kernel-name fragments -> the layer they belong to, first match wins
FAMILIES = list(KERNEL_SYMBOLS.items()) + [
    ("conv", "conv"), ("conv", "fprop"), ("conv", "implicit"),
    ("gemm", "gemm"), ("gemm", "cutlass"), ("gemm", "nvjet"), ("gemm", "sm90_xmma")]


def forward_breakdown(model, dev, cond, uncond):
    """One CFG forward (batch 2 at 256x256): its time as launched from
    Python (CUDA events) beside its device busy time (the same forward
    replayed as a CUDA graph); the difference is the share of the forward
    the card sits idle. Then, where torch.profiler sees the card, the
    device time by kernel family."""
    x = torch.randn(2, RESOLUTION, RESOLUTION, 3, device=dev)
    t = torch.full((2,), 500.0, device=dev)
    ctx = torch.cat([cond, uncond]).to(dev)
    call = lambda: model(x, t, ctx)
    with torch.inference_mode():
        fwd_ms = time_ms(call, 10)
        busy = graph_ms(call, 1, replays=10)
    out = {"forward_ms": fwd_ms, "busy_ms": busy, "idle_share": 1.0 - busy / fwd_ms}
    log(f"  one CFG forward: {fwd_ms:.3f} ms launched from Python, device busy "
        f"{busy:.3f} ms as a CUDA graph ({out['idle_share']:.0%} idle)")
    out.update(family_profile(call))
    return out


def family_profile(call) -> dict:
    """Device time of one call by kernel family, from torch.profiler. The
    profiler's CUPTI tracing sometimes delivers no device events at all; this
    breakdown only explains the busy time measured above, so it is then
    reported as not measured instead of failing the run."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            log("  " + line.strip())

    log("phase 2: kernels against their plain versions")
    cases = kernel_cases(dev, peaks(name))
    torch.cuda.empty_cache()

    from flaxdiff_tpu_torch.models import Unet
    state = random_state(Unet(**UNET, device="cpu"), 0)
    log("phase 3: full-width UNet, card against CPU")
    model_res = model_checks(dev, state)
    torch.cuda.empty_cache()

    log(f"phase 4: DDIM-{STEPS} + CFG {GUIDANCE} at {RESOLUTION}x{RESOLUTION}, bf16")
    traj = main_path(dev, state)
    log(f"trajectory: DDIM-{STEPS} CFG {GUIDANCE} {RESOLUTION}x{RESOLUTION} batch 1 bf16 "
        f"wall {traj['wall_s']:.3f} s ({traj['ms_per_forward']:.2f} ms per forward), "
        f"peak {traj['peak_mem_gib']:.2f} GiB on {smi}")

    kernels = []
    for kname in REPLACES:
        mine = [c for c in cases if c["name"] == kname]
        head = mine[0]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": traj["launches"][kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"], "cases": mine})
    record = {"device": name, "nvidia_smi": smi, "build_s": build_s, "kernels": kernels,
              "model": model_res, "trajectory": traj}
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
