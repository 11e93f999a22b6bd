#!/usr/bin/env python3
"""Time and check one checkout's flash forward kernel on the card.

    python3 scripts/flash_ab.py CHECKOUT

Builds CHECKOUT's CUDA kernels (into CHECKOUT/build/kernels), holds the
forward kernel against its plain version at chip_smoke.py's phase-2 shapes
plus two larger ones, and prints each case's device time per call (CUDA
graph replays, chip_smoke.graph_ms) beside its readings. To compare two
versions on one card, run them in one command in the order old, new, new,
old.
"""
import argparse
import os
import sys
import time

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkout")
    args = parser.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from flaxdiff_tpu_torch.ops import _build
    from flaxdiff_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype: torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    lines = []
    for b, lq, lk, h, dtype in cs.FLASH_FWD_CASES + [(4, 4096, 4096, 8, torch.bfloat16),
                                                      (2, 1000, 1000, 8, torch.float16)]:
        q, k, v = (randn(b, n, h, 64, dtype=dtype) for n in (lq, lk, lk))
        out, lse = flash_fwd(q, k, v)
        ref, ref_lse = flash_fwd_plain(q, k, v)
        torch.cuda.synchronize()
        r = (cs.compare(out, ref, 4e-3, cs.BF16_RTOL, 1e-2) if dtype != torch.float32
             else cs.compare(out, ref, 1e-5, 1e-5, 1e-5))
        r.update(lse_err=cs.max_err(lse, ref_lse), lse_atol=1e-4)
        ms = cs.graph_ms(lambda: flash_fwd(q, k, v), 20)
        lines.append(f"flash_fwd {(b, lq, lk, h, str(dtype)[6:])}: {ms:.4f} ms, least atol "
                     f"{r['least_atol']:.3g}, rms {r['rms_rel']:.3g}, lse {r['lse_err']:.3g}, "
                     f"ok {cs.passes(r)}")
    print(f"== {root} (build {build_s:.1f} s)")
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
