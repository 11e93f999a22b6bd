"""The served route's cost on the card, for one checkout of the repository:
phase 4's DDIM-50 + CFG request at 256x256 (wall, one CFG call's time as
launched and its device busy time, launches) and one bucket-8 round of phase
15b (8 requests x 10 DDIM steps, CFG batch 16: wall and busy ms a step).

    PYTHONPATH=. python3 scripts/bi_cost.py TREE [--out FILE]

TREE is a checkout (`.` for the working tree; an older commit unpacked with
`git archive` into a git-ignored directory); its chip_smoke.py and package
are imported and its kernels built into TREE/build/kernels. To compare two
checkouts on one card, run them in one call in turns: old, new, new, old.
Needs CUDA.
"""
import argparse
import json
import os
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree")
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
    state = cs.random_state(Unet(**cs.UNET, device="cpu"), 0)
    traj = cs.main_path(dev, state)
    model, _, _ = cs.serving_model(dev, state)
    pipe = cs.serving15_pipeline(dev, model, cs.RESOLUTION, 3, CosineNoiseSchedule(1000),
                                 EpsilonPredictionTransform())
    round8 = cs.bucket8_round(SamplerProgramEngine(pipe, telemetry=Telemetry()), traj)
    row = {"tree": args.tree, "device": torch.cuda.get_device_name(0), "build_s": build_s,
           "request_wall_s": traj["wall_s"], "ms_per_forward": traj["ms_per_forward"],
           "forward_launched_ms": traj["breakdown"]["forward_ms"],
           "forward_busy_ms": traj["breakdown"]["busy_ms"],
           "launches": {k: v for k, v in traj["launches"].items() if v},
           "round8_wall_ms_per_step": round8["ms_per_step"],
           "round8_busy_ms_per_step": (None if round8["busy_ms"] is None
                                       else round8["busy_ms"] / cs.SERVE15_ROUND)}
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
