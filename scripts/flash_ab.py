#!/usr/bin/env python3
"""Time and check one checkout's version of a kernel on the card.

    python3 scripts/flash_ab.py CHECKOUT
        [--kernel fwd|dq|gn_stats|gn_norm|gn_bwd_stats|gn_bwd_dx] [--sass]

Builds CHECKOUT's CUDA kernels (into CHECKOUT/build/kernels), holds the
chosen kernel against its plain version at chip_smoke.py's phase-2 shapes
(plus two larger ones for the forward) under phase 2's limits, and prints
each case's device time per call (CUDA graph replays, chip_smoke.graph_ms)
beside its readings. ``fwd`` is the flash forward (B1), ``dq`` the flash dq
backward (B2), ``gn_stats`` GroupNorm's statistics (B4) at the UNet's
serving and training shapes, ``gn_norm`` its normalize + SiLU pass (B5),
``gn_bwd_stats`` and ``gn_bwd_dx`` its backward statistics (B6) and dx
(B7) passes at the UNet train step's shapes. With
``--sass``, also prints each instantiation of the kernel in the built
library (cuobjdump -sass): its instruction count and the instructions of
each loop body (from a backward branch's target to the branch). To compare
two versions on one card, run them in one command in the order old, new,
new, old.
"""
import argparse
import inspect
import os
import re
import shutil
import subprocess
import sys
import time

import torch

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# (batch, lq, lk, heads, dtype), heads of 64
FWD_CASES = [(2, 4096, 4096, 8, BF16), (2, 4096, 77, 8, BF16), (2, 1024, 1024, 8, BF16),
             (2, 1024, 77, 8, BF16), (2, 1024, 1024, 8, F32), (8, 256, 256, 12, BF16),
             (4, 4096, 4096, 8, BF16), (2, 1000, 1000, 8, F16)]
DQ_CASES = [(16, 1024, 1024, 8, BF16), (16, 1024, 77, 8, BF16), (16, 256, 256, 8, BF16),
            (16, 256, 77, 8, BF16), (2, 1024, 1024, 8, F32), (32, 256, 256, 12, BF16)]
# (batch, HW, C, dtype), 8 groups: shapes one CFG call of the UNet at 256^2 normalizes
GN_CASES = [(2, 65536, 64, BF16), (2, 16384, 128, BF16), (2, 4096, 256, BF16),
            (2, 1024, 1024, BF16), (2, 4096, 256, F32)]
# (batch, HW, C, dtype), 8 groups: shapes one UNet train step at batch 16, 128^2
# differentiates
GN_BWD_CASES = [(16, 16384, 64, BF16), (16, 4096, 128, BF16), (16, 1024, 256, BF16),
                (16, 256, 1024, BF16), (16, 1024, 256, F32)]
SYMBOLS = {"fwd": "flash_fwd_", "dq": "flash_bwd_dq_", "gn_stats": "gn_stats_kernel",
           "gn_norm": "gn_norm_kernel", "gn_bwd_stats": "gn_bwd_stats_kernel",
           "gn_bwd_dx": "gn_bwd_dx_kernel"}


def stats_rows(fn, b, hw, c, backward: bool) -> int:
    """The checkout's rows of a statistics block: rows_per_block(b, hw, c)
    for both passes; older checkouts have rows_per_block(hw, c) for the
    forward and bwd_rows_per_block(b, hw, c), or the forward's, for the
    backward."""
    if len(inspect.signature(fn.rows_per_block).parameters) == 3:
        return fn.rows_per_block(b, hw, c)
    rule = getattr(fn, "bwd_rows_per_block", None)
    return rule(b, hw, c) if backward and rule else fn.rows_per_block(hw, c)


def flash_fwd_cases(cs, randn):
    from flaxdiff_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    for b, lq, lk, h, dtype in FWD_CASES:
        q, k, v = (randn(b, n, h, 64, dtype=dtype) for n in (lq, lk, lk))
        out, lse = flash_fwd(q, k, v)
        ref, ref_lse = flash_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        r = (cs.compare(out, ref, 4e-3, cs.BF16_RTOL, 1e-2) if dtype != F32
             else cs.compare(out, ref, 1e-5, 1e-5, 1e-5))
        r.update(lse_err=cs.max_err(lse, ref_lse), lse_atol=1e-4)
        ms = cs.graph_ms(lambda: flash_fwd(q, k, v), 20)
        flops = 4.0 * b * h * lq * lk * 64
        yield ((b, lq, lk, h, str(dtype)[6:]), ms, r,
               f", {flops / ms / 1e9:.1f} TFLOP/s, lse {r['lse_err']:.3g}")


def flash_dq_cases(cs, randn):
    from flaxdiff_tpu_torch.ops.flash_attention import (flash_bwd_dq, flash_bwd_dq_plain,
                                                        flash_delta, flash_fwd)
    for b, lq, lk, h, dtype in DQ_CASES:
        q, k, v = (randn(b, n, h, 64, dtype=dtype) for n in (lq, lk, lk))
        do = randn(b, lq, h, 64, dtype=dtype)
        out, lse = flash_fwd(q, k, v)
        delta = flash_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta)
        ref = flash_bwd_dq_plain(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        atol, rtol, rms = (4e-3, cs.BF16_RTOL, 1e-3) if dtype != F32 else (1e-5, 1e-5, 1e-5)
        r = cs.compare(dq, ref, atol * float(ref.float().abs().max()), rtol, rms)
        ms = cs.graph_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta), 20)
        flops = 3 * 2.0 * b * h * lq * lk * 64
        yield (b, lq, lk, h, str(dtype)[6:]), ms, r, f", {flops / ms / 1e9:.1f} TFLOP/s"


def gn_stats_cases(cs, randn):
    """The statistics kernel (B4) under chip_smoke.py's phase-2 limits."""
    from flaxdiff_tpu_torch.ops import fused_norm as fn
    for b, hw, c, dtype in GN_CASES + GN_BWD_CASES:
        x = randn(b, hw, c, dtype=dtype) * 2.0 + 0.5
        part = fn.groupnorm_stats(x, 8)
        ref = fn.groupnorm_stats_plain(x, 8, stats_rows(fn, b, hw, c, backward=False))
        torch.cuda.synchronize()
        r = cs.compare(part, ref, 1e-3, 1e-5, 1e-5)
        ms = cs.graph_ms(lambda: fn.groupnorm_stats(x, 8), 20)
        nbytes = x.element_size() * x.numel()
        yield (b, hw, c, str(dtype)[6:]), ms, r, f", {nbytes / ms / 1e6:.0f} GB/s"


def gn_norm_cases(cs, randn):
    from flaxdiff_tpu_torch.ops import fused_norm as fn
    from flaxdiff_tpu_torch.ops.fused_norm import (groupnorm_finalize, groupnorm_normalize,
                                                   groupnorm_normalize_plain,
                                                   groupnorm_stats_plain)
    for b, hw, c, dtype in GN_CASES:
        x = randn(b, hw, c, dtype=dtype) * 2.0 + 0.5
        scale = randn(c, dtype=F32).abs() + 0.5
        bias = randn(c, dtype=F32) * 0.1
        rows = stats_rows(fn, b, hw, c, backward=False)
        mean, rstd = groupnorm_finalize(groupnorm_stats_plain(x, 8, rows), hw, c, 1e-6)
        out = groupnorm_normalize(x, mean, rstd, scale, bias, True)
        ref = groupnorm_normalize_plain(x, mean, rstd, scale, bias, True)
        torch.cuda.synchronize()
        r = cs.compare(out, ref, 1e-5, cs.BF16_RTOL if dtype == BF16 else 1e-5, 1e-3)
        ms = cs.graph_ms(lambda: groupnorm_normalize(x, mean, rstd, scale, bias, True), 20)
        nbytes = 2 * x.element_size() * x.numel()
        yield (b, hw, c, str(dtype)[6:]), ms, r, f", {nbytes / ms / 1e6:.0f} GB/s"


def gn_bwd_cases(kernel):
    """The backward statistics (B6) or dx (B7) cases, under chip_smoke.py's
    phase-2 limits."""
    def cases(cs, randn):
        from flaxdiff_tpu_torch.ops import fused_norm as fn
        for b, hw, c, dtype in GN_BWD_CASES:
            x = randn(b, hw, c, dtype=dtype) * 2.0 + 0.5
            g = randn(b, hw, c, dtype=dtype)
            scale = randn(c, dtype=F32).abs() + 0.5
            bias = randn(c, dtype=F32) * 0.1
            mean, rstd = fn.groupnorm_finalize(
                fn.groupnorm_stats_plain(x, 8, stats_rows(fn, b, hw, c, backward=False)), hw, c,
                1e-6)
            rows = stats_rows(fn, b, hw, c, backward=True)
            args = (x, g, mean, rstd, scale, bias)
            gs_ref, cs_ref = fn.groupnorm_bwd_stats_plain(*args, True, rows)
            esz, n = x.element_size(), b * hw * c
            if kernel == "gn_bwd_stats":
                gs, csum = fn.groupnorm_bwd_stats(*args, True)
                torch.cuda.synchronize()
                read = [cs.compare(o, r, 1e-6 * float(r.abs().max()), 1e-5, 1e-6)
                        for o, r in ((gs, gs_ref), (csum, cs_ref))]
                # the reading nearer its limit, passing only if both do
                r = dict(max(read, key=lambda d: d["least_atol"] / d["atol"]),
                         ok=all(cs.passes(d) for d in read))
                ms = cs.graph_ms(lambda: fn.groupnorm_bwd_stats(*args, True), 20)
            else:
                s, _, _ = fn.groupnorm_bwd_finalize(gs_ref, cs_ref, hw)
                dx = fn.groupnorm_bwd_dx(*args, s, True)
                ref = fn.groupnorm_bwd_dx_plain(*args, s, True)
                torch.cuda.synchronize()
                r = cs.compare(dx, ref, 1e-5, cs.BF16_RTOL if dtype == BF16 else 1e-5, 1e-3)
                ms = cs.graph_ms(lambda: fn.groupnorm_bwd_dx(*args, s, True), 20)
            nbytes = (2 if kernel == "gn_bwd_stats" else 3) * esz * n
            yield (b, hw, c, str(dtype)[6:]), ms, r, f", {nbytes / ms / 1e6:.0f} GB/s"
    return cases


CASES = {"fwd": flash_fwd_cases, "dq": flash_dq_cases, "gn_stats": gn_stats_cases,
         "gn_norm": gn_norm_cases,
         "gn_bwd_stats": gn_bwd_cases("gn_bwd_stats"), "gn_bwd_dx": gn_bwd_cases("gn_bwd_dx")}


def sass_loops(lib: str, symbol: str) -> list:
    """(function, instructions, [loop body sizes]) for each function of the
    library whose mangled name holds `symbol`; '' when cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return []
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, name, instrs, labels = [], None, [], {}

    def close():
        if name and symbol in name:
            loops = []
            for addr, text in instrs:
                m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", text)
                if not m:
                    continue
                tgt = m.group(1)
                tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
                if tgt is not None and tgt < addr:
                    loops.append((addr - tgt) // 16 + 1)
            funcs.append((name, len(instrs), loops))

    pending = []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, instrs, labels, pending = m.group(1), [], {}, []
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if ins and name:
            addr = int(ins.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            instrs.append((addr, ins.group(2)))
    close()
    return funcs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkout")
    parser.add_argument("--kernel", choices=sorted(CASES), default="fwd")
    parser.add_argument("--sass", action="store_true",
                        help="print the kernel's SASS instruction and loop-body counts")
    args = parser.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from flaxdiff_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype: torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    lines = []
    for shape, ms, r, note in CASES[args.kernel](cs, randn):
        lines.append(f"{args.kernel} {shape}: {ms:.4f} ms, least atol {r['least_atol']:.3g}, "
                     f"rms {r['rms_rel']:.3g}{note}, ok {r.get('ok', cs.passes(r))}")
    print(f"== {root} (build {build_s:.1f} s)")
    print("\n".join(lines), flush=True)
    if args.sass:
        for fn, n, loops in sass_loops(str(lib), SYMBOLS[args.kernel]):
            print(f"  sass {fn}: {n} instructions, loop bodies {loops}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
