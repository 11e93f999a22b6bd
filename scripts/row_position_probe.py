"""Does a row's result depend on its position in the batch on the card?

    PYTHONPATH=. python3 scripts/row_position_probe.py

The serving scheduler batches requests into rounds, and a request's rows
land at whatever position its round gives them. This probe measures, on
the card in bf16 with TF32 off:
  gemm  F.linear at the UNet's GEMM shapes (text projections 16 x 77 rows,
        the levels' token projections), rows permuted and the batch's halves
        swapped against the same rows computed in place, with and without
        cuBLAS's reduced-precision bf16 reductions
  conv  the UNet's 3x3 convolutions (channels-last) at batch 16: samples
        changed when the batch's halves swap, and over 5 repeats of the same
        call, with cudnn.deterministic off and on
  serving whole requests through chip_smoke.py phase 15's scheduler, x0
        before the clip: one request at position 0 of buckets 1, 2, 4 and 8
        against the solo generate_samples (the bucket's size varies, the
        position does not), eight requests in bucket 8 in three orders (the
        positions vary, the bucket does not), and the bf16 solo call
        against the f32 model's (the yardstick of bf16 itself)
Prints one line per case. Needs CUDA.
"""
import sys

import torch

import chip_smoke as cs


def gemm_cases(dev, gen):
    for (m, k, n) in [(16 * 77, 768, 512), (16 * 1024, 256, 256), (16 * 4096, 128, 128),
                      (16 * 1024, 512, 2048), (2 * 77, 768, 512), (8 * 1024, 256, 768)]:
        x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        w = torch.randn(n, k, device=dev, generator=gen).bfloat16()
        perm = torch.randperm(m, device=dev, generator=gen)
        h = m // 2
        for reduced in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
            full = torch.nn.functional.linear(x, w)
            permuted = torch.nn.functional.linear(x[perm], w)
            swapped = torch.nn.functional.linear(torch.cat([x[h:], x[:h]]), w)
            print(f"gemm [{m},{k}]x[{k},{n}] reduced-precision reductions {reduced}: rows "
                  f"differing permuted {int((permuted != full[perm]).any(1).sum())}, halves "
                  f"swapped {int((swapped != torch.cat([full[h:], full[:h]])).any(1).sum())}",
                  flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True


def conv_cases(dev, gen):
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        for (c_in, c_out, hw) in [(64, 64, 256), (128, 128, 128), (256, 256, 64),
                                  (512, 512, 32), (256, 512, 32), (512, 256, 64)]:
            conv = torch.nn.Conv2d(c_in, c_out, 3, padding=1).to(dev).bfloat16().to(
                memory_format=torch.channels_last)
            x = torch.randn(16, c_in, hw, hw, device=dev, generator=gen).bfloat16().to(
                memory_format=torch.channels_last)
            with torch.no_grad():
                ref = conv(x)
                repeat = sum(int((conv(x) != ref).flatten(1).any(1).sum()) for _ in range(5))
                swapped = conv(torch.cat([x[8:], x[:8]]))
            swapped = torch.cat([swapped[8:], swapped[:8]])
            print(f"conv {c_in}->{c_out} at {hw}x{hw}, batch 16, cudnn.deterministic {det}: "
                  f"samples differing over 5 repeats {repeat}, halves swapped "
                  f"{int((swapped != ref).flatten(1).any(1).sum())}", flush=True)
    torch.backends.cudnn.deterministic = False


def serving_cases(dev):
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.serving import SampleRequest
    state = cs.random_state(Unet(**cs.UNET, device="cpu"), 0)
    model, _, _ = cs.serving_model(dev, state)
    pipe = cs.serving15_pipeline(dev, model, cs.RESOLUTION, 3, CosineNoiseSchedule(1000),
                                 EpsilonPredictionTransform())
    kinds = [dict(cs.MIX15[1]), dict(cs.MIX15[2]),
             dict(cs.MIX15[1], sampler="multistep_dpm", diffusion_steps=30)]

    def serve(reqs, bucket):
        return [o.samples for o in cs.serve15(pipe, reqs, round_steps=cs.SERVE15_ROUND,
                                              batch_buckets=(bucket,))]

    def show(what, out, ref):
        print(f"{what}: bit-equal {bool((out == ref).all())}, x0 max diff "
              f"{float(abs(out - ref).max()):.4g} = {cs.rel15(out, ref):.3g} of max "
              f"(max|x0| {float(abs(ref).max()):.4g}); clipped samples differ in "
              f"{float((out.clip(-1, 1) != ref.clip(-1, 1)).mean()):.3%} of pixels", flush=True)

    with cs.preclip():
        for kind in kinds:
            label = f"{kind['sampler']}-{kind['diffusion_steps']}"
            reqs = [SampleRequest(**dict(kind, seed=300 + i)) for i in range(8)]
            solo = cs.solo15(pipe, reqs[0])
            for bucket in (1, 2, 4, 8):
                # the bucket's size varies, the request stays at position 0
                show(f"{label} at position 0 of bucket {bucket} (mates {bucket - 1}) against "
                     f"the solo call", serve(reqs[:bucket], bucket)[0], solo)
            # the bucket stays 8, the positions move
            ref = serve(reqs, 8)
            for order, perm in (("reversed", list(range(7, -1, -1))),
                                ("halves swapped", list(range(4, 8)) + list(range(4)))):
                moved = serve([reqs[i] for i in perm], 8)
                for j, i in enumerate(perm):
                    show(f"{label} seed {300 + i} in bucket 8, position {i} -> {j} ({order})",
                         moved[j], ref[i])
        # the yardstick of bf16 itself: the solo call in bf16 against f32
        model32 = Unet(**cs.UNET, device=dev)
        model32.load_state_dict(state)
        model32.eval()
        pipe32 = cs.serving15_pipeline(dev, model32, cs.RESOLUTION, 3,
                                       CosineNoiseSchedule(1000), EpsilonPredictionTransform())
        for kind in kinds:
            r = SampleRequest(**dict(kind, seed=300))
            show(f"{kind['sampler']}-{kind['diffusion_steps']} solo bf16 against f32",
                 cs.solo15(pipe, r), cs.solo15(pipe32, r))


def main() -> int:
    if not torch.cuda.is_available():
        print("row_position_probe: no CUDA device", file=sys.stderr)
        return 2
    from flaxdiff_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build()
    _build.library()
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    gemm_cases(dev, gen)
    conv_cases(dev, gen)
    serving_cases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
