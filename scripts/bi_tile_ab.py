"""Times each tile of one checkout's batch-invariant convolution on the card:
bi_conv on every wgmma route the checkout's ROUTES names, at phase 2's
16-bit shapes that the wgmma loop takes (chip_smoke.BI_CONV_CASES) and at
the served UNet's other deep 3x3 convs (DEEP_CONVS), each at the case's
batch (phase 4's CFG call) and at 8x it (a bucket-8 CFG round), and the f32
conv_out on the narrow route. The route codes go to the library directly, so
one build times every tile; each reading (device ms of one call, CUDA graph
replays) is one JSON line, beside the route the checkout's conv_route would
pick.

    PYTHONPATH=. python3 scripts/bi_tile_ab.py TREE LABEL [--narrow-only] [--out FILE]

TREE is a checkout (`.` for the working tree; another unpacked with `git
archive` into a git-ignored directory), built into TREE/build/kernels. To
compare two checkouts on one card, run them in one call in turns: old, new,
new, old. Needs CUDA.
"""
import argparse
import json
import os
import sys

# the served UNet-text-256's deep 3x3 convs that phase 2 does not time (batch,
# side, Cin, Cout, kernel, stride, padding): level 3's up path (1024 -> 512 at
# 32^2, K 9216), level 3's upsample conv and level 2's up path (512 -> 256 at
# 64^2, K 4608)
DEEP_CONVS = [(2, 32, 1024, 512, 3, 1, "SAME"), (2, 64, 512, 256, 3, 1, "SAME")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree")
    parser.add_argument("label")
    parser.add_argument("--narrow-only", action="store_true", help="time conv_out's route only")
    parser.add_argument("--out", help="append the readings here, one JSON line each")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("bi_tile_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flaxdiff_tpu_torch.ops import _build
    from flaxdiff_tpu_torch.ops import batch_invariant as bi
    assert cs.__file__.startswith(tree), cs.__file__
    dev = torch.device("cuda")
    lib = _build.library()
    wgmma = [] if args.narrow_only else [c for c, n in bi.ROUTES.items() if n.startswith("wgmma")]
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *shape, dtype: torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    device = torch.cuda.get_device_name(0)
    out_f = open(args.out, "a") if args.out else None

    def emit(row):
        row.update(tree=args.label, device=device)
        print(json.dumps(row), flush=True)
        if out_f:
            out_f.write(json.dumps(row) + "\n")

    cases = cs.BI_CONV_CASES + [case + (torch.bfloat16,) for case in DEEP_CONVS]
    for batch, side, cin, cout, ksz, stride, pad, dtype in cases:
        default = bi.conv_route(cin, cout, ksz, ksz, (stride, stride), dtype)
        codes = ([default] if default == bi.NARROW
                 else wgmma if bi.ROUTES[default].startswith("wgmma") else [])
        for b in ((batch, 8 * batch) if codes else ()):
            x = randn(b, side, side, cin, dtype=dtype)
            w = (randn(cout, cin, ksz, ksz, dtype=dtype) * (cin * ksz * ksz) ** -0.5).contiguous(
                memory_format=torch.channels_last)
            bias, p = randn(cout, dtype=dtype), (ksz - 1) // 2
            out = torch.empty(b, side, side, cout, dtype=dtype, device=dev)
            for code in codes:
                call = lambda: _build.check(lib.bi_conv(
                    x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b, side, side,
                    cin, side, side, cout, ksz, ksz, 1, 1, p, p, _build.dtype_code(x), code,
                    _build.stream_handle(dev)), "bi_conv")
                emit(dict(kind="conv", shape=[b, side, cin, cout, ksz], dtype=str(dtype)[6:],
                          route=bi.ROUTES[code], default=bi.ROUTES[default],
                          ms=cs.graph_ms(call, 20)))
            del x, w, out
    if out_f:
        out_f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
