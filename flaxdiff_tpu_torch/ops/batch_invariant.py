"""Batch-invariant linear and convolution: a sample's result does not depend
on the batch it is computed in (its size, the sample's position, the other
samples), so a served request replays bit for bit in any bucket.

- ``bi_linear(x, w, b)``: y = x W^T + b over the last axis; the kernel
  ``csrc/bi_gemm.cu`` on the card.
- ``bi_conv2d(x_nhwc, w, b, stride, padding)``: a convolution over NHWC
  input with explicit (low, high) zero padding per spatial axis; the
  implicit-GEMM kernel ``csrc/bi_conv.cu`` on the card.

Neither replaces a TPU kernel: the JAX package leaves Dense and Conv to XLA.
The port's ``Dense`` and ``ConvLayer`` take them under
``torch.inference_mode`` (every serving path: the sampler's loop and the
scheduler's rounds), where cuBLAS's and cuDNN's algorithm choice made a row's
bits follow its batch (fault C6, ROADMAP.md). Training keeps ``F.linear`` and
``F.conv2d``. Each kernel keeps one f32 sum per output over k in a fixed
order, with a tile shape that never depends on the row count
(``csrc/bi_wgmma.cuh``, ``csrc/bi_mma.cuh``).

Which kernel variant a call runs (its route) is picked here, by
``gemm_route(n, k, dtype)`` and ``conv_route(cin, cout, kh, kw, stride,
dtype)``: pure functions of the weight's shape, the convolution's
per-sample geometry and the dtype, which take no row count and no batch, so
a sample solo and in any bucket takes one route. The C entry points take the
route's code and return an error for a code that does not fit the call; a
wrapper raises on it and never falls back to another variant.

The plain versions, which run for CPU tensors, make one ``F.linear`` or
``F.conv2d`` call per sample along the leading batch axis: each sample runs
at the batch-1 shape, so MKL and oneDNN take the same path whatever the
bucket, and the CPU is batch-invariant too. A CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .. import profiling

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

# The kernel variants (codes shared with csrc/bi_wgmma.cuh's BiRoute)
MMA, FMA, NARROW, WGMMA_128X128, WGMMA_128X64 = range(5)
ROUTES = {MMA: "mma", FMA: "fma", NARROW: "narrow", WGMMA_128X128: "wgmma_128x128",
          WGMMA_128X64: "wgmma_128x64"}
HALF = (torch.bfloat16, torch.float16)
# the narrow f32 convolution's shared memory (W and one input row segment of
# 128 output pixels, csrc/bi_conv.cu narrow_smem_bytes) stays within this
# (NARROW_SMEM_MAX there)
NARROW_SMEM = 96 * 1024


def gemm_route(n: int, k: int, dtype: torch.dtype) -> int:
    """The variant ``bi_linear`` runs for x [*, k] W^T, W [n, k]: bf16 and
    f16 take the wgmma loop where TMA can tile the operands (k and n
    multiples of 8), on 128 x 128 tiles; other 16-bit shapes take mma.sync,
    f32 the FMA kernel."""
    if dtype not in HALF:
        return FMA
    if k % 8 or n % 8:
        return MMA
    return WGMMA_128X128


def _narrow_smem_bytes(cin: int, cout: int, kh: int, kw: int) -> int:
    cp = 4 if cout <= 4 else 8
    return 4 * (kh * kw * cin * cp + (128 + kw - 1) * (cin + 4))


def conv_route(cin: int, cout: int, kh: int, kw: int, stride: Sequence[int],
               dtype: torch.dtype) -> int:
    """The variant ``bi_conv2d`` runs for a conv of cin -> cout channels, a
    kh x kw kernel and `stride`: bf16 and f16 at stride 1 with cin a
    multiple of 64 and cout of 8 take the wgmma loop, on 128 x 128 tiles,
    128 x 64 up to 64 outputs (the UNet's level 0); other 16-bit convs
    (conv_in, a stride, a patch embedding) take mma.sync. f32 to at most 8 channels at stride 1 (the UNet's conv_out)
    takes the narrow direct kernel, other f32 convs the FMA kernel."""
    unit = tuple(stride) == (1, 1)
    if dtype not in HALF:
        narrow = (unit and cout <= 8 and cin % 4 == 0
                  and _narrow_smem_bytes(cin, cout, kh, kw) <= NARROW_SMEM)
        return NARROW if narrow else FMA
    if not unit or cin % 64 or cout % 8:
        return MMA
    return WGMMA_128X64 if cout <= 64 else WGMMA_128X128


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself, or a copy where its data does not start on 16 bytes (TMA's
    and the 16-byte loads' alignment; the copy changes no bit of a result)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bi_linear_plain(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear`` one sample of the leading axis at a time."""
    if x.dim() < 2:
        return F.linear(x, w, b)
    return torch.stack([F.linear(xi, w, b) for xi in x.unbind(0)])


def _check_dtypes(*tensors: Optional[torch.Tensor]) -> None:
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) != 1:
        raise ValueError(f"operands of one dtype expected, got {sorted(map(str, dtypes))}")


def bi_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b. x: [..., K] contiguous, w: [N, K], b: [N] or None, one
    dtype (bf16, f16 or f32) -> [..., N]."""
    if w.dim() != 2 or x.shape[-1] != w.shape[1] or (b is not None and b.shape != w.shape[:1]):
        raise ValueError(f"bi_linear: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {None if b is None else tuple(b.shape)}")
    _check_dtypes(x, w, b)
    if profiling.live_counters:
        with profiling.count_product(2.0 * x.numel() * w.shape[0]):
            return _bi_linear(x, w, b)
    return _bi_linear(x, w, b)


def _bi_linear(x, w, b):
    if x.device.type == "cpu":
        return bi_linear_plain(x, w, b)
    _build.require_cuda(x, w, *([] if b is None else [b]))
    if not (x.is_contiguous() and w.is_contiguous() and (b is None or b.is_contiguous())):
        raise ValueError("bi_linear needs contiguous operands")
    n, k = w.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    if m >= 2 ** 31 - 256:
        raise ValueError(f"bi_linear: {m} rows, the kernel takes fewer than 2^31")
    x, w = _aligned(x), _aligned(w)
    err = _build.library().bi_gemm(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), m, n, k,
        _build.dtype_code(x), gemm_route(n, k, x.dtype), _build.stream_handle(x.device))
    _build.check(err, "bi_gemm")
    bi_linear.launches += 1
    return out


bi_linear.launches = 0


def conv_output_size(size: int, k: int, stride: int, pad: Tuple[int, int]) -> int:
    return (size + pad[0] + pad[1] - k) // stride + 1


def bi_conv2d_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                    stride: Sequence[int], padding: Padding) -> torch.Tensor:
    """``F.conv2d`` one sample at a time: x [B, H, W, Cin] -> [B, OH, OW, Cout]."""
    (pt, pb), (pl, pr) = padding
    outs = []
    for xi in x.unbind(0):
        xi = xi[None]
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xi, pad = F.pad(xi, (0, 0, pl, pr, pt, pb)), (0, 0)
        outs.append(F.conv2d(xi.permute(0, 3, 1, 2), w, b, stride=tuple(stride),
                             padding=pad).permute(0, 2, 3, 1))
    return torch.cat(outs)


def bi_conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              stride: Sequence[int], padding: Padding) -> torch.Tensor:
    """A convolution, no groups, no dilation. x: [B, H, W, Cin] contiguous;
    w: [Cout, Cin, KH, KW] (torch's layout; channels-last memory saves the
    kernel a copy); b: [Cout] or None; stride (sh, sw); padding ((top,
    bottom), (left, right)) -> [B, OH, OW, Cout]."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"bi_conv2d: x {tuple(x.shape)} (NHWC), w {tuple(w.shape)} (OIHW)")
    if b is not None and b.shape != w.shape[:1]:
        raise ValueError(f"bi_conv2d: bias {tuple(b.shape)} for {w.shape[0]} outputs")
    _check_dtypes(x, w, b)
    if profiling.live_counters:
        with profiling.count_product(_conv_flops(x, w, stride, padding)):
            return _bi_conv2d(x, w, b, stride, padding)
    return _bi_conv2d(x, w, b, stride, padding)


def _conv_flops(x, w, stride, padding) -> float:
    """2 x output elements x input channels x kernel taps."""
    oh = conv_output_size(x.shape[1], w.shape[2], stride[0], padding[0])
    ow = conv_output_size(x.shape[2], w.shape[3], stride[1], padding[1])
    return 2.0 * x.shape[0] * max(oh, 0) * max(ow, 0) * w.numel()


def _bi_conv2d(x, w, b, stride, padding):
    if x.device.type == "cpu":
        return bi_conv2d_plain(x, w, b, stride, padding)
    _build.require_cuda(x, w, *([] if b is None else [b]))
    if not x.is_contiguous() or (b is not None and not b.is_contiguous()):
        raise ValueError("bi_conv2d needs a contiguous NHWC input and bias")
    batch, h, wd, cin = x.shape
    cout, _, kh, kw = w.shape
    (pt, pb), (pl, pr) = padding
    sh, sw = stride
    oh, ow = conv_output_size(h, kh, sh, (pt, pb)), conv_output_size(wd, kw, sw, (pl, pr))
    if oh <= 0 or ow <= 0:
        raise ValueError(f"bi_conv2d: empty output {oh}x{ow}")
    if batch > 65535:
        raise ValueError(f"bi_conv2d: batch {batch}, the kernel's grid takes at most 65535")
    wk = w.contiguous(memory_format=torch.channels_last)   # [Cout, KH, KW, Cin] in memory
    out = torch.empty(batch, oh, ow, cout, dtype=x.dtype, device=x.device)
    if batch == 0:
        return out
    x, wk = _aligned(x), _aligned(wk)
    err = _build.library().bi_conv(
        x.data_ptr(), wk.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        batch, h, wd, cin, oh, ow, cout, kh, kw, sh, sw, pt, pl, _build.dtype_code(x),
        conv_route(cin, cout, kh, kw, (sh, sw), x.dtype), _build.stream_handle(x.device))
    _build.check(err, "bi_conv")
    bi_conv2d.launches += 1
    return out


bi_conv2d.launches = 0
