"""Fault C6: a sample's bits do not depend on its batch on the served route.

Under inference mode the port's Dense and ConvLayer run ``bi_linear`` and
``bi_conv2d`` (``flaxdiff_tpu_torch/ops/batch_invariant.py``). Their plain
versions, which the CPU runs, make one library call per sample: each sample
gets the same bits at batch 1, 2, 4 and 8 and in any order, and agrees with
one ``F.linear`` / ``F.conv2d`` over the batch to 1e-6 x max|ref| (the same
f32 math, another blocking). Through the layers they agree with the JAX
package's Dense and ConvLayer to 1e-5 x max|ref|. The kernels themselves run
on the card only (tests/test_torch_gpu.py, chip_smoke.py phase 2).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu.models.common import ConvLayer as JaxConvLayer
from flaxdiff_tpu_torch.models import common
from flaxdiff_tpu_torch.models.common import ConvLayer, Dense
from flaxdiff_tpu_torch.ops import launch_counts, reset_launch_counts
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
