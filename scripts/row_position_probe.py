"""Does a sample's result depend on its batch on the card? (fault C6)

    PYTHONPATH=. python3 scripts/row_position_probe.py [--out probe.json]
        [--no-serving]

layers: phase 4's UNet-text-256 served model (bf16, a CFG call is 2 rows a
    request) takes 8 requests' rows (batch 16) once, with the inputs of every
    module and of the two kernel ops between them (attention, B1; GEGLU, B8)
    recorded. Each then runs again on the same per-sample inputs at batch 2,
    4, 8 and 16 and at 16 in three other orders (reversed, halves swapped,
    shuffled), and each sample's output is compared with the same sample at
    batch 2, position 0. Modules are the leaves (Dense, ConvLayer, the fused
    GroupNorm + SiLU (B4, B5), LayerNorm, the Fourier embedding) and the
    composites, whose readings cover the elementwise ops between leaves.
    Routes: the library (F.linear, F.conv2d: autograd off, outside inference
    mode) under each candidate setting (cuDNN deterministic off and on, cuBLAS's
    reduced-precision bf16 reductions on and off; TF32 off and cuDNN's
    benchmark off throughout, as in the port), and the batch-invariant kernels
    (inference mode, the served route). Prints, per route and setting, every
    layer that moved with its largest difference.
serving: whole requests through chip_smoke.py phase 15's scheduler on x0
    before the clip: one request at position 0 of buckets 1, 2, 4 and 8
    against the solo generate_samples (the bucket's size varies, the position
    does not), eight requests in bucket 8 in three orders (the positions vary,
    the bucket does not), and the bf16 solo call against the f32 model's (the
    yardstick of bf16 itself).
Needs CUDA.
"""
import argparse
import json
import os
import sys
from collections import defaultdict

import torch

import chip_smoke as cs

BATCH = 16      # 8 requests' CFG rows
SETTINGS = {
    "library, cudnn.deterministic off, bf16 reduced-precision reductions on (torch's defaults)":
        dict(deterministic=False, reduced=True),
    "library, cudnn.deterministic on": dict(deterministic=True, reduced=True),
    "library, bf16 reduced-precision reductions off": dict(deterministic=False, reduced=False),
    "library, both": dict(deterministic=True, reduced=False),
}


def record_calls(model, x, t, ctx):
    """Run the model once in inference mode, keeping the arguments of every
    module call and of the attention and GEGLU ops."""
    from flaxdiff_tpu_torch.models import attention as attn_mod
    calls = []
    names = {m: n for n, m in model.named_modules() if n}

    def hook(module, args, kwargs):
        if module in names:
            calls.append((names[module], module, args, kwargs))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in names]
    originals = attn_mod.dot_product_attention, attn_mod.fused_geglu

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            calls.append((f"{name} #{sum(c[0].startswith(name) for c in calls)}", fn, args,
                          kwargs))
            return fn(*args, **kwargs)
        return recorded

    attn_mod.dot_product_attention = wrap("op:attention (B1)", originals[0])
    attn_mod.fused_geglu = wrap("op:geglu (B8)", originals[1])
    try:
        with torch.inference_mode():
            model(x, t, ctx)
    finally:
        attn_mod.dot_product_attention, attn_mod.fused_geglu = originals
        for h in handles:
            h.remove()
    return calls


def select(value, idx):
    """`value` with every tensor of leading dim BATCH taken at rows `idx`."""
    if isinstance(value, torch.Tensor):
        return value[idx] if value.dim() and value.shape[0] == BATCH else value
    if isinstance(value, (list, tuple)):
        return type(value)(select(v, idx) for v in value)
    if isinstance(value, dict):
        return {k: select(v, idx) for k, v in value.items()}
    return value


def first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    return next(o for o in out if isinstance(o, torch.Tensor))


def layer_readings(calls, dev):
    """{layer: (largest difference, samples moved)} for every call whose
    output moved: each sample against itself at batch 2, position 0."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    variants = {f"batch {b}": list(range(b)) for b in (2, 4, 8, BATCH)}
    variants["reversed"] = list(range(BATCH - 1, -1, -1))
    variants["halves swapped"] = list(range(BATCH // 2, BATCH)) + list(range(BATCH // 2))
    variants["shuffled"] = torch.randperm(BATCH, generator=gen).tolist()
    moved = {}
    for name, fn, args, kwargs in calls:
        run = lambda idx: first_tensor(fn(*select(args, torch.tensor(idx, device=dev)),
                                          **select(kwargs, torch.tensor(idx, device=dev))))
        ref = [run([i, (i + 1) % BATCH])[0] for i in range(BATCH)]
        worst, count = 0.0, 0
        for idx in variants.values():
            out = run(idx)
            for j, i in enumerate(idx):
                d = float((out[j].float() - ref[i].float()).abs().max())
                if d > 0 or bool((out[j] != ref[i]).any()):
                    worst, count = max(worst, d), count + 1
        if count:
            moved[name] = (worst, count)
    return moved


def layer_cases(dev, state):
    model, cond, uncond = cs.serving_model(dev, state)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(BATCH, cs.RESOLUTION, cs.RESOLUTION, 3, device=dev, generator=gen)
    t = torch.linspace(20.0, 980.0, BATCH, device=dev)
    text = torch.randn(BATCH // 2, cs.TEXT_LEN, cs.TEXT_DIM, device=dev, generator=gen)
    ctx = torch.cat([text, uncond.to(dev).expand(BATCH // 2, -1, -1)])
    calls = record_calls(model, x, t, ctx)
    kinds = defaultdict(int)
    for name, fn, _, _ in calls:
        kinds[type(fn).__name__ if isinstance(fn, torch.nn.Module) else name] += 1
    print(f"layers: {len(calls)} calls recorded at batch {BATCH}: "
          + ", ".join(f"{k} {v}" for k, v in sorted(kinds.items())), flush=True)
    results = {}
    routes = [(label, cfg, torch.no_grad) for label, cfg in SETTINGS.items()]
    routes.append(("batch-invariant kernels (inference mode)",
                   dict(deterministic=False, reduced=True), torch.inference_mode))
    for label, cfg, mode in routes:
        torch.backends.cudnn.deterministic = cfg["deterministic"]
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = cfg["reduced"]
        with mode():
            moved = layer_readings(calls, dev)
        torch.cuda.synchronize()
        by_kind = defaultdict(int)
        for name in moved:
            fn = next(f for n, f, _, _ in calls if n == name)
            by_kind[type(fn).__name__ if isinstance(fn, torch.nn.Module) else name] += 1
        print(f"{label}: {len(moved)} of {len(calls)} calls moved"
              + (" (" + ", ".join(f"{k} {v}" for k, v in sorted(by_kind.items())) + ")"
                 if moved else ""), flush=True)
        for name, (worst, count) in sorted(moved.items(), key=lambda kv: -kv[1][0])[:40]:
            print(f"    {name}: largest difference {worst:.4g}, {count} sample readings moved",
                  flush=True)
        results[label] = {"calls": len(calls), "moved": {k: list(v) for k, v in moved.items()},
                          "moved_by_kind": dict(by_kind)}
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    del calls, model
    torch.cuda.empty_cache()
    return results


def serving_cases(dev, state):
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.serving import SampleRequest
    model, _, _ = cs.serving_model(dev, state)
    pipe = cs.serving15_pipeline(dev, model, cs.RESOLUTION, 3, CosineNoiseSchedule(1000),
                                 EpsilonPredictionTransform())
    kinds = [dict(cs.MIX15[1]), dict(cs.MIX15[2]),
             dict(cs.MIX15[1], sampler="multistep_dpm", diffusion_steps=30)]
    out = {}

    def serve(reqs, bucket):
        return [o.samples for o in cs.serve15(pipe, reqs, round_steps=cs.SERVE15_ROUND,
                                              batch_buckets=(bucket,))]

    def show(what, got, ref):
        equal = bool((got == ref).all())
        print(f"{what}: bit-equal {equal}, x0 max diff {float(abs(got - ref).max()):.4g} = "
              f"{cs.rel15(got, ref):.3g} of max (max|x0| {float(abs(ref).max()):.4g})", flush=True)
        out[what] = {"bit_equal": equal, "rel": cs.rel15(got, ref)}

    with cs.preclip():
        for kind in kinds:
            label = f"{kind['sampler']}-{kind['diffusion_steps']}"
            reqs = [SampleRequest(**dict(kind, seed=300 + i)) for i in range(8)]
            solo = cs.solo15(pipe, reqs[0])
            for bucket in (1, 2, 4, 8):
                show(f"{label} at position 0 of bucket {bucket} against the solo call",
                     serve(reqs[:bucket], bucket)[0], solo)
            ref = serve(reqs, 8)
            for order, perm in (("reversed", list(range(7, -1, -1))),
                                ("halves swapped", list(range(4, 8)) + list(range(4))),
                                ("shuffled", [3, 6, 0, 5, 2, 7, 1, 4])):
                moved = serve([reqs[i] for i in perm], 8)
                for j, i in enumerate(perm):
                    show(f"{label} seed {300 + i} in bucket 8, position {i} -> {j} ({order})",
                         moved[j], ref[i])
        model32 = Unet(**cs.UNET, device=dev)
        model32.load_state_dict(state)
        model32.eval()
        pipe32 = cs.serving15_pipeline(dev, model32, cs.RESOLUTION, 3,
                                       CosineNoiseSchedule(1000), EpsilonPredictionTransform())
        for kind in kinds:
            r = SampleRequest(**dict(kind, seed=300))
            show(f"{kind['sampler']}-{kind['diffusion_steps']} solo bf16 against f32",
                 cs.solo15(pipe, r), cs.solo15(pipe32, r))
    moved = [k for k, v in out.items() if "against f32" not in k and not v["bit_equal"]]
    print(f"serving: {len(moved)} whole-request readings moved", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write every reading here as JSON")
    parser.add_argument("--no-serving", action="store_true", help="the layer readings only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("row_position_probe: no CUDA device", file=sys.stderr)
        return 2
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    _build.build()
    _build.library()
    print(torch.cuda.get_device_name(0), flush=True)
    state = cs.random_state(Unet(**cs.UNET, device="cpu"), 0)
    record = {"device": torch.cuda.get_device_name(0), "layers": layer_cases(dev, state)}
    if not args.no_serving:
        record["serving"] = serving_cases(dev, state)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
