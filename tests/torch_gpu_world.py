"""The two-rank NCCL world of ``tests/test_torch_gpu.py`` (one card a rank):
the ring across two cards against one flash call, and an {fsdp: 2} step of a
small UNet against one rank's step on the global batch. Started by
``torch_world.spawn(..., backend="nccl")``; each rank writes its verdicts."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import run_worker  # noqa: E402


def _ring(rank, world, outdir):
    from flaxdiff_tpu_torch.ops.attention import dot_product_attention
    from flaxdiff_tpu_torch.parallel import create_mesh, use_mesh
    dev = torch.device("cuda", rank)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(2, 512, 4, 64, generator=gen, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    want = [t.detach() for t in (q, k, v)]
    ref = [t.clone().requires_grad_() for t in want]
    out_ref = dot_product_attention(*ref)
    grads_ref = torch.autograd.grad(out_ref, ref, do)
    mesh = create_mesh({"seq": world})
    ts = [t.clone().requires_grad_() for t in want]
    with use_mesh(mesh):
        out = dot_product_attention(*ts, backend="ring")
    grads = torch.autograd.grad(out, ts, do)
    ok = [float((out.float() - out_ref.float()).abs().max()) <= 4e-3 + 2 ** -7 * float(
        out_ref.float().abs().max())]
    for g, r in zip(grads, grads_ref):
        ok.append(float((g.float() - r.float()).abs().max())
                  <= world * 4e-3 * float(r.float().abs().max()) + 2 ** -7 * float(
                      r.float().abs().max()))
    np.save(os.path.join(outdir, f"ring_{rank}.npy"), np.array(ok))


def _fsdp(rank, world, outdir):
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.parallel import create_mesh
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, TrainState, TrainStepConfig, make_train_step
    dev = torch.device("cuda", rank)
    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8, in_channels=3, context_dim=16)
    step = make_train_step(CosineNoiseSchedule(1000), EpsilonPredictionTransform(),
                           TrainStepConfig(normalize=False), null_cond=torch.zeros(1, 8, 16,
                                                                                   device=dev))
    rng = np.random.default_rng(9)
    glob = [(torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32)).to(dev),
             torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32)).to(dev),
             torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(np.float32)).to(dev),
             torch.from_numpy(rng.integers(0, 1000, 4).astype(np.int32)).to(dev))
            for _ in range(2)]

    def run(mesh, rows):
        torch.manual_seed(0)
        state = TrainState(Unet(**cfg, device=dev), AdamW(1e-4), 0.999, mesh=mesh)
        for x, c, noise, t in glob:
            step(state, {"sample": x[rows], "cond": c[rows]}, noise[rows], t[rows],
                 torch.zeros(4, dtype=torch.bool, device=dev)[rows])
        return state.gather(state.params)

    mesh = create_mesh({"fsdp": world})
    sharded = run(mesh, slice(rank * 4 // world, (rank + 1) * 4 // world))
    whole = run(None, slice(None))
    np.save(os.path.join(outdir, f"fsdp_{rank}.npy"),
            np.array([float((sharded - whole).abs().max()) <= 3e-4]))


if __name__ == "__main__":
    run_worker({"ring": _ring, "fsdp": _fsdp})
