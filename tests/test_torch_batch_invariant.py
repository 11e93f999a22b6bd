"""Fault C6: a sample's bits do not depend on its batch on the served route.

Under inference mode the port's Dense and ConvLayer run ``bi_linear`` and
``bi_conv2d`` (``flaxdiff_tpu_torch/ops/batch_invariant.py``). Their plain
versions, which the CPU runs, make one library call per sample: each sample
gets the same bits at batch 1, 2, 4 and 8 and in any order, and agrees with
one ``F.linear`` / ``F.conv2d`` over the batch to 1e-6 x max|ref| (the same
f32 math, another blocking). Through the layers they agree with the JAX
package's Dense and ConvLayer to 1e-5 x max|ref|. The kernels themselves run
on the card only (tests/test_torch_gpu.py, chip_smoke.py phase 2); which
variant each call takes there (``gemm_route``, ``conv_route``) is a pure
function of the layer's shape, tested here, as is that the wrappers hand it
to the library unchanged at every batch.
"""
import inspect
import re
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

import chip_smoke
from flaxdiff_tpu.models.common import ConvLayer as JaxConvLayer
from flaxdiff_tpu_torch.models import SimpleDiT, Unet, common
from flaxdiff_tpu_torch.models.common import ConvLayer, Dense
from flaxdiff_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from flaxdiff_tpu_torch.ops import batch_invariant as bi
from flaxdiff_tpu_torch.ops.batch_invariant import bi_conv2d, bi_linear

LIB_TOL = 1e-6      # against one library call over the batch, times max|ref|
JAX_TOL = 1e-5      # against the JAX layer, times max|ref|
# (kernel, stride, padding, side): 3x3 SAME, stride 2 SAME on an even side
# (pads 0 low, 1 high), 1x1, a 2x2 patch embedding at stride 2, VALID
CONVS = [(3, 1, "SAME", 9), (3, 2, "SAME", 10), (1, 1, "SAME", 7), (2, 2, "VALID", 8)]


def _rng(seed):
    return np.random.default_rng(seed)


def _linear_operands(seed=0, batch=8):
    rng = _rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, 13, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 48)).astype(np.float32) / 7)
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    return x, w, b


def _conv_operands(k, cin=8, cout=12, side=9, seed=1, batch=8):
    rng = _rng(seed)
    x = torch.from_numpy(rng.standard_normal((batch, side, side, cin)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(np.float32) / 5)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x, w, b


def _same(side, k, stride):
    return common._same_padding(side, k, stride)


def _assert_close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err, bound = np.abs(out - ref).max(), tol * np.abs(ref).max()
    assert err <= bound, f"max error {err:.3g} above {bound:.3g}"


def _ops():
    x, w, b = _linear_operands()
    yield "linear", x, lambda t: bi_linear(t, w, b), lambda t: F.linear(t, w, b)
    for k, stride, pad, side in CONVS:
        cx, cw, cb = _conv_operands(k, side=side)
        p = _same(side, k, stride) if pad == "SAME" else (0, 0)
        xc = lambda t, p=p: F.pad(t, (0, 0, p[0], p[1], p[0], p[1])).permute(0, 3, 1, 2)
        yield (f"conv{k}x{k}/{stride}/{pad}", cx,
               lambda t, w=cw, b=cb, s=stride, p=p: bi_conv2d(t, w, b, (s, s), (p, p)),
               lambda t, w=cw, b=cb, s=stride, f=xc: F.conv2d(f(t), w, b, stride=s).permute(
                   0, 2, 3, 1))


@pytest.mark.parametrize("case", range(1 + len(CONVS)))
def test_plain_versions_give_each_sample_the_same_bits_in_any_batch(case):
    name, x, op, _ = list(_ops())[case]
    ref = op(x)
    for b in (1, 2, 4):
        assert torch.equal(op(x[:b]), ref[:b]), (name, b)
    for perm in (torch.arange(7, -1, -1), torch.tensor([3, 6, 0, 5, 2, 7, 1, 4])):
        assert torch.equal(op(x[perm]), ref[perm]), name


@pytest.mark.parametrize("case", range(1 + len(CONVS)))
def test_plain_versions_agree_with_one_library_call(case):
    name, x, op, library = list(_ops())[case]
    _assert_close(op(x), library(x), LIB_TOL)


def test_cpu_tensors_count_no_launch():
    reset_launch_counts()
    for _, x, op, _ in _ops():
        op(x)
    counts = launch_counts()
    assert counts["bi_gemm"] == counts["bi_conv"] == 0


def test_dense_under_inference_mode_matches_jax_dense(monkeypatch):
    x, _, _ = _linear_operands(batch=3)
    rng = _rng(3)
    kernel = rng.standard_normal((48, 40)).astype(np.float32) / 7
    bias = rng.standard_normal(40).astype(np.float32)
    ref = fnn.Dense(40).apply({"params": {"kernel": jnp.asarray(kernel),
                                          "bias": jnp.asarray(bias)}}, jnp.asarray(x.numpy()))
    dense = Dense(48, 40)
    dense.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                           "bias": torch.from_numpy(bias)})
    routed = []
    monkeypatch.setattr(common, "bi_linear", lambda *a: routed.append(1) or bi_linear(*a))
    with torch.inference_mode():
        out = dense(x)
    assert routed == [1], "inference mode takes bi_linear"
    _assert_close(out.numpy(), np.asarray(ref), JAX_TOL)
    with torch.no_grad():
        dense(x)
    assert routed == [1], "autograd's route stays F.linear"


@pytest.mark.parametrize("k,stride,pad,side", CONVS)
def test_conv_layer_under_inference_mode_matches_jax_conv_layer(monkeypatch, k, stride, pad,
                                                                side):
    x, _, _ = _conv_operands(k, side=side, batch=3)
    rng = _rng(4)
    kernel = rng.standard_normal((k, k, 8, 12)).astype(np.float32) / 5
    bias = rng.standard_normal(12).astype(np.float32)
    jax_layer = JaxConvLayer("conv", 12, (k, k), strides=stride, padding=pad)
    ref = jax.jit(jax_layer.apply)(
        {"params": {"Conv_0": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}},
        jnp.asarray(x.numpy()))
    layer = ConvLayer(8, 12, (k, k), stride, padding=pad)
    assert layer.batch_invariant_kernel == "bi_conv"
    layer.load_state_dict({"weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                           "bias": torch.from_numpy(bias)})
    routed = []
    monkeypatch.setattr(common, "bi_conv2d", lambda *a: routed.append(1) or bi_conv2d(*a))
    with torch.inference_mode():
        out = layer(x)
    assert routed == [1], "inference mode takes bi_conv2d"
    _assert_close(out.numpy(), np.asarray(ref), JAX_TOL)


def test_grouped_transposed_and_dilated_convolutions_keep_the_library():
    """C6's rest: these routes have no batch-invariant kernel."""
    assert ConvLayer(8, 8, groups=8).batch_invariant_kernel is None
    assert ConvLayer(8, 8, dilation=2).batch_invariant_kernel is None
    assert ConvLayer(8, 8, conv_type="conv_transpose").batch_invariant_kernel is None
    separable = ConvLayer(8, 12, conv_type="separable")
    assert separable.batch_invariant_kernel is None
    assert separable.depthwise.batch_invariant_kernel is None
    assert separable.pointwise.batch_invariant_kernel == "bi_conv"


# --- the route: which kernel variant a call runs on the card ---------------------------

# phase 2's cases (chip_smoke.BI_GEMM_CASES, BI_CONV_CASES) and the route
# each must take: the served 16-bit shapes the wgmma loop, conv_out the
# narrow f32 kernel; the kept kernels only K 100, conv_in's 3 channels, the
# stride-2 downsample, DiT's 4-channel patch embedding and the f32 GEMM
GEMM_CASE_ROUTES = ["wgmma_128x128", "wgmma_128x128", "wgmma_128x128", "wgmma_128x128",
                    "wgmma_128x128", "wgmma_128x128", "wgmma_128x128", "wgmma_128x128",
                    "wgmma_128x128", "mma", "wgmma_128x128", "fma"]
CONV_CASE_ROUTES = ["wgmma_128x64", "wgmma_128x128", "wgmma_128x128", "wgmma_128x128", "mma",
                    "mma", "wgmma_128x128", "narrow", "wgmma_128x128", "wgmma_128x128", "mma"]


@pytest.mark.parametrize("case", range(len(GEMM_CASE_ROUTES)))
def test_phase2_gemm_cases_take_their_route(case):
    assert len(chip_smoke.BI_GEMM_CASES) == len(GEMM_CASE_ROUTES)
    _, _, k, n, dtype = chip_smoke.BI_GEMM_CASES[case]
    assert bi.ROUTES[bi.gemm_route(n, k, dtype)] == GEMM_CASE_ROUTES[case]


@pytest.mark.parametrize("case", range(len(CONV_CASE_ROUTES)))
def test_phase2_conv_cases_take_their_route(case):
    assert len(chip_smoke.BI_CONV_CASES) == len(CONV_CASE_ROUTES)
    _, _, cin, cout, k, stride, _, dtype = chip_smoke.BI_CONV_CASES[case]
    route = bi.conv_route(cin, cout, k, k, (stride, stride), dtype)
    assert bi.ROUTES[route] == CONV_CASE_ROUTES[case]


def _served_layers(model):
    """(kind, route name, what) of every Dense and batch-invariant ConvLayer
    of `model` as served: bf16 unless the layer fixes its dtype."""
    for name, mod in model.named_modules():
        dt = getattr(mod, "dtype", None) or torch.bfloat16
        if isinstance(mod, Dense):
            n, k = mod.weight.shape
            yield "dense", bi.ROUTES[bi.gemm_route(n, k, dt)], (name, n, k, dt)
        elif isinstance(mod, ConvLayer) and mod.batch_invariant_kernel:
            cout, cin, kh, kw = mod.weight.shape
            yield ("conv", bi.ROUTES[bi.conv_route(cin, cout, kh, kw, mod.strides, dt)],
                   (name, cin, cout, kh, kw, mod.strides, dt))


@pytest.mark.parametrize("family", ["unet", "simple_dit"])
def test_every_served_layer_takes_the_wgmma_loop_or_a_named_kept_kernel(family):
    """The served UNet-text-256 (phase 4) and DiT-B/2 (phase 6) at their full
    widths, built on the meta device: every 16-bit Dense and every 16-bit
    conv at stride 1 over a multiple of 64 channels runs on wgmma; conv_out
    (f32, 3 outputs) on the narrow kernel; the rest are the kept kernels the
    route names (conv_in, the stride-2 downsample, the patch embedding on
    mma.sync, DiT's f32 output layer on FMA)."""
    model = (Unet(**chip_smoke.UNET, device="meta") if family == "unet"
             else SimpleDiT(**chip_smoke.DIT, device="meta"))
    layers = list(_served_layers(model))
    assert len(layers) > 50
    for kind, route, what in layers:
        dt = what[-1]
        if kind == "dense":
            assert route.startswith("wgmma") if dt != torch.float32 else route == "fma", what
        else:
            _, cin, cout, _, _, strides, _ = what
            if dt == torch.float32:
                assert route == "narrow", what
            elif strides == (1, 1) and cin % 64 == 0:
                assert route.startswith("wgmma"), what
            else:
                assert route == "mma", what
    if family == "unet":
        assert [r for _, r, w in layers if w[0] == "conv_out"] == ["narrow"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_k_or_n_not_a_multiple_of_8_keeps_the_mma_kernel(dtype):
    assert bi.gemm_route(70, 100, dtype) == bi.MMA
    assert bi.gemm_route(70, 64, dtype) == bi.MMA
    assert bi.gemm_route(64, 100, dtype) == bi.MMA
    assert bi.gemm_route(72, 64, dtype) == bi.WGMMA_128X128
    assert bi.gemm_route(64, 64, dtype) == bi.WGMMA_128X128
    assert bi.conv_route(32, 64, 3, 3, (1, 1), dtype) == bi.MMA
    assert bi.conv_route(64, 3, 3, 3, (1, 1), dtype) == bi.MMA
    assert bi.conv_route(64, 64, 3, 3, (2, 2), dtype) == bi.MMA
    assert bi.gemm_route(512, 512, torch.float32) == bi.FMA
    assert bi.conv_route(64, 16, 3, 3, (1, 1), torch.float32) == bi.FMA


def test_route_functions_take_no_row_count_and_no_batch():
    assert list(inspect.signature(bi.gemm_route).parameters) == ["n", "k", "dtype"]
    assert list(inspect.signature(bi.conv_route).parameters) == [
        "cin", "cout", "kh", "kw", "stride", "dtype"]


def test_route_codes_match_the_kernels_enum():
    """ROUTES' codes are csrc/bi_wgmma.cuh's BiRoute values, name for name."""
    header = (Path(bi.__file__).resolve().parents[1] / "csrc" / "bi_wgmma.cuh").read_text()
    enum = {m.group(1).lower(): int(m.group(2))
            for m in re.finditer(r"kRoute(\w+) = (\d+)", header)}
    assert enum == {name.replace("_", ""): code for code, name in bi.ROUTES.items()}


class _Library:
    """Records each call of the C entry points; returns success."""

    def __init__(self):
        self.calls = []

    def bi_gemm(self, *args):
        self.calls.append(("bi_gemm", args))
        return 0

    def bi_conv(self, *args):
        self.calls.append(("bi_conv", args))
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda *t: None)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    return lib


# (Dense in, out), (ConvLayer cin, cout, kernel, stride) of the served UNet,
# and the 16-bit dtypes the served route runs in
SEAM_LINEARS = [(256, 2048), (768, 512), (100, 70)]
SEAM_CONVS = [(512, 512, 3, 1), (64, 64, 3, 1), (3, 64, 3, 1), (64, 64, 3, 2), (64, 3, 3, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
def test_wrappers_pass_the_route_code_whatever_the_batch(library, dtype):
    """bi_linear and bi_conv2d hand the C entry points gemm_route's and
    conv_route's code for one layer at batch 1, 2, 8 and 16 alike (meta
    tensors reach the library call through the stubbed seam)."""
    for k, n in SEAM_LINEARS:
        w = torch.empty(n, k, dtype=dtype, device="meta")
        b = torch.empty(n, dtype=dtype, device="meta")
        for batch in (1, 2, 8, 16):
            library.calls.clear()
            bi_linear(torch.empty(batch, 77, k, dtype=dtype, device="meta"), w, b)
            (name, args), = library.calls
            assert name == "bi_gemm" and args[4:7] == (batch * 77, n, k)
            assert args[-2] == bi.gemm_route(n, k, dtype), (k, n, batch)
    for cin, cout, ksz, stride in SEAM_CONVS:
        w = torch.empty(cout, cin, ksz, ksz, dtype=dtype, device="meta")
        pad = _same(16, ksz, stride)
        for batch in (1, 2, 8, 16):
            library.calls.clear()
            bi_conv2d(torch.empty(batch, 16, 16, cin, dtype=dtype, device="meta"), w, None,
                      (stride, stride), (pad, pad))
            (name, args), = library.calls
            assert name == "bi_conv" and args[4] == batch
            assert args[-2] == bi.conv_route(cin, cout, ksz, ksz, (stride, stride), dtype)
