"""The served route's cost on the card, for one checkout of the repository:
phase 4's DDIM-50 + CFG request at 256x256 (wall, one CFG call's time as
launched and its device busy time, launches) and one bucket-8 round of phase
15b (8 requests x 10 DDIM steps, CFG batch 16: wall and busy ms a step);
then the host's microseconds a bi_linear and a bi_conv2d call take to launch
at a shape whose kernel runs faster than the host launches it (beside the
kernel's device time), the host share of the served route's 6426 bi
launches a request.

    PYTHONPATH=. python3 scripts/bi_cost.py TREE [--launch-only] [--wrappers-of OLD]
                                             [--out FILE]

TREE is a checkout (`.` for the working tree; an older commit unpacked with
`git archive` into a git-ignored directory); its chip_smoke.py and package
are imported and its kernels built into TREE/build/kernels. To compare two
checkouts on one card, run them in one call in turns: old, new, new, old.
The host's pace wanders between processes by more than a small change to a
wrapper costs, so `--wrappers-of OLD` also times OLD's
`ops/batch_invariant.py` wrappers, loaded into TREE's package (TREE's
kernels; the two must take the same C entry points), in turns with TREE's
own in one process. Needs CUDA.
"""
import argparse
import json
import os
import sys
import time


def host_us(calls: dict, loop: int = 500, reps: int = 20) -> dict:
    """Host microseconds of each call as launched: the least over `reps`
    loops of `loop` calls, each followed by one sync. The calls take turns
    loop by loop, so the host's pace, which wanders between loops, weighs on
    each alike; the least is the call's own cost."""
    import torch
    for call in calls.values():
        for _ in range(20):
            call()
    torch.cuda.synchronize()
    least = {k: float("inf") for k in calls}
    for _ in range(reps):
        for key, call in calls.items():
            t0 = time.perf_counter()
            for _ in range(loop):
                call()
            least[key] = min(least[key], (time.perf_counter() - t0) * 1e6 / loop)
            torch.cuda.synchronize()
    return least


def old_wrappers(tree: str):
    """`tree`'s ``ops/batch_invariant.py`` as a module of the running
    package, so its relative imports resolve to the running package's
    ``_build`` and library."""
    import importlib.util
    name = "flaxdiff_tpu_torch.ops._old_batch_invariant"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tree, "flaxdiff_tpu_torch", "ops", "batch_invariant.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def launch_costs(cs, dev, old=None) -> dict:
    """host_us and the device time (CUDA graph replays) of the time
    embedding's bi_linear and a small 3x3 bi_conv2d, in bf16 under inference
    mode, as the served route calls them; and, where the checkout's library
    takes a route code, host_us of its C entry points called directly on the
    mma.sync route and on the wgmma route (three tensor maps a launch), which
    separates the launcher's cost from the wrapper's. `old`: another
    checkout's wrappers (``old_wrappers``), timed in the same turns."""
    import torch
    from flaxdiff_tpu_torch.ops import _build
    from flaxdiff_tpu_torch.ops import batch_invariant as bi
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)
    x, w, b = randn(2, 1, 512), randn(512, 512) * 512 ** -0.5, randn(512)
    xc, bc = randn(2, 8, 8, 64), randn(64)
    wc = (randn(64, 64, 3, 3) * 576 ** -0.5).contiguous(memory_format=torch.channels_last)
    gemm, conv = "bi_linear [2,1,512]x512", "bi_conv2d [2,8^2,64->64] 3x3"
    wrapped = {gemm: lambda: bi.bi_linear(x, w, b),
               conv: lambda: bi.bi_conv2d(xc, wc, bc, (1, 1), ((1, 1), (1, 1)))}
    if old is not None:
        wrapped[gemm + " (old)"] = lambda: old.bi_linear(x, w, b)
        wrapped[conv + " (old)"] = lambda: old.bi_conv2d(xc, wc, bc, (1, 1), ((1, 1), (1, 1)))
    direct = {}
    if hasattr(bi, "ROUTES"):
        lib, code, stream = _build.library(), _build.dtype_code(x), _build.stream_handle(dev)
        out, outc = torch.empty(2, 512, **_like(x)), torch.empty(2, 8, 8, 64, **_like(x))
        ptrs = [t.data_ptr() for t in (x, w, b, out)]
        ptrs_c = [t.data_ptr() for t in (xc, wc, bc, outc)]
        for route in (bi.MMA, bi.gemm_route(512, 512, x.dtype)):
            direct[f"C bi_gemm {bi.ROUTES[route]}"] = (
                lambda r=route: lib.bi_gemm(*ptrs, 2, 512, 512, code, r, stream))
        for route in (bi.MMA, bi.conv_route(64, 64, 3, 3, (1, 1), x.dtype)):
            direct[f"C bi_conv {bi.ROUTES[route]}"] = (
                lambda r=route: lib.bi_conv(*ptrs_c, 2, 8, 8, 64, 8, 8, 64, 3, 3, 1, 1, 1, 1,
                                            code, r, stream))
    for key, call in direct.items():
        _build.check(call(), key)
    with torch.inference_mode():
        return {"host_us_a_call": host_us({**wrapped, **direct}),
                "device_us_a_call": {k: cs.graph_ms(c, 20) * 1e3 for k, c in wrapped.items()}}


def _like(t) -> dict:
    return {"dtype": t.dtype, "device": t.device}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree")
    parser.add_argument("--launch-only", action="store_true",
                        help="read the host's and the card's time a bi call only")
    parser.add_argument("--wrappers-of", dest="old", metavar="OLD",
                        help="also time checkout OLD's bi wrappers in this process")
    parser.add_argument("--out", help="append the readings here as one JSON line")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("bi_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.ops import _build
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.serving import SamplerProgramEngine
    from flaxdiff_tpu_torch.telemetry import Telemetry
    assert cs.__file__.startswith(tree), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    if hasattr(cs, "install_route_census"):
        cs.install_route_census()
    build_s = time.perf_counter() - t0
    row = {"tree": args.tree, "device": torch.cuda.get_device_name(0), "build_s": build_s}
    old = old_wrappers(os.path.abspath(args.old)) if args.old else None
    if args.launch_only:
        return emit({**row, **launch_costs(cs, dev, old)}, args.out)
    state = cs.random_state(Unet(**cs.UNET, device="cpu"), 0)
    traj = cs.main_path(dev, state)
    model, _, _ = cs.serving_model(dev, state)
    pipe = cs.serving15_pipeline(dev, model, cs.RESOLUTION, 3, CosineNoiseSchedule(1000),
                                 EpsilonPredictionTransform())
    round8 = cs.bucket8_round(SamplerProgramEngine(pipe, telemetry=Telemetry()), traj)
    row.update({"request_wall_s": traj["wall_s"], "ms_per_forward": traj["ms_per_forward"],
                "forward_launched_ms": traj["breakdown"]["forward_ms"],
                "forward_busy_ms": traj["breakdown"]["busy_ms"],
                "launches": {k: v for k, v in traj["launches"].items() if v},
                "round8_wall_ms_per_step": round8["ms_per_step"],
                "round8_busy_ms_per_step": (None if round8["busy_ms"] is None
                                            else round8["busy_ms"] / cs.SERVE15_ROUND),
                **launch_costs(cs, dev, old)})
    return emit(row, args.out)


def emit(row: dict, out) -> int:
    print(json.dumps(row), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
