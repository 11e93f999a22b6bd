"""InceptionV3's pool3 features for FID (counterpart of
``flaxdiff_tpu/metrics/inception.py``, the FID variant of Szegedy et al.
2015 that pytorch-FID standardises on).

``InceptionV3Features`` takes images [N, H, W, 3] in [0, 1] and returns
[N, 2048]: resized to 299x299 as ``jax.image.resize(..., "bilinear")`` does
(a triangle kernel widened when it shrinks, weights renormalised at the
edges: one host-built matrix per axis, two matmuls), mapped to [-1, 1], then
the conv tower (each conv bias-free, an inference BatchNorm with eps 1e-3,
ReLU; average pools not counting padding) and a global mean. The module
tree carries pytorch-FID's names, so its state dict loads directly
(``load_torch_state_dict``); ``load_inception_params`` also takes the
flax-path npz of ``scripts/convert_inception_weights.py``. Without weights
the network is drawn from a seed (lecun-normal kernels, as flax inits them):
a fixed random-feature extractor for relative comparisons, not standard FID.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, make_generator, resolve_device

_Pad = Tuple[int, int]
# the pytorch-FID state dict's classifier head and auxiliary tower, not on
# the pool3 path
_SKIP_PREFIXES = ("fc.", "AuxLogits.")


@functools.lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of ``jax.image.resize``'s "bilinear"
    method along one axis (antialiased, its f32 arithmetic): sample i sits
    at (i + 0.5) / scale - 0.5, the triangle kernel is widened by 1 / scale
    when shrinking, each column is renormalised to sum 1, and samples
    outside the input get none."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """x [N, C, H, W] f32 -> [N, C, *size]; an axis already at its size is
    left alone, as in JAX."""
    h, w = size
    if x.shape[2] != h:
        wh = torch.from_numpy(resize_weights(x.shape[2], h)).to(x.device)
        x = torch.matmul(wh.T, x)
    if x.shape[3] != w:
        ww = torch.from_numpy(resize_weights(x.shape[3], w)).to(x.device)
        x = torch.matmul(x, ww)
    return x


class _BatchNorm(nn.Module):
    """Inference BatchNorm (pytorch-FID's names, no batch counter)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=1e-3)


class BasicConv(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3, inference) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: int = 1,
                 padding: _Pad = (0, 0), device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False, device=device)
        self.bn = _BatchNorm(cout, device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_same(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, device=None):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, (1, 1), device=device)
        self.branch5x5_1 = BasicConv(cin, 48, (1, 1), device=device)
        self.branch5x5_2 = BasicConv(48, 64, (5, 5), padding=(2, 2), device=device)
        self.branch3x3dbl_1 = BasicConv(cin, 64, (1, 1), device=device)
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=(1, 1), device=device)
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), padding=(1, 1), device=device)
        self.branch_pool = BasicConv(cin, pool_features, (1, 1), device=device)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_same(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, (3, 3), stride=2, device=device)
        self.branch3x3dbl_1 = BasicConv(cin, 64, (1, 1), device=device)
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=(1, 1), device=device)
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), stride=2, device=device)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, device=None):
        super().__init__()
        row, col = dict(padding=(0, 3), device=device), dict(padding=(3, 0), device=device)
        self.branch1x1 = BasicConv(cin, 192, (1, 1), device=device)
        self.branch7x7_1 = BasicConv(cin, c7, (1, 1), device=device)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), **row)
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), **col)
        self.branch7x7dbl_1 = BasicConv(cin, c7, (1, 1), device=device)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), **col)
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), **row)
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), **col)
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), **row)
        self.branch_pool = BasicConv(cin, 192, (1, 1), device=device)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_same(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, (1, 1), device=device)
        self.branch3x3_2 = BasicConv(192, 320, (3, 3), stride=2, device=device)
        self.branch7x7x3_1 = BasicConv(cin, 192, (1, 1), device=device)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3), device=device)
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0), device=device)
        self.branch7x7x3_4 = BasicConv(192, 192, (3, 3), stride=2, device=device)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)],
                         dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_kind: str = "avg", device=None):
        super().__init__()
        self.pool_kind = pool_kind   # the FID variant max-pools in the last block
        self.branch1x1 = BasicConv(cin, 320, (1, 1), device=device)
        self.branch3x3_1 = BasicConv(cin, 384, (1, 1), device=device)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch3x3dbl_1 = BasicConv(cin, 448, (1, 1), device=device)
        self.branch3x3dbl_2 = BasicConv(448, 384, (3, 3), padding=(1, 1), device=device)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1), device=device)
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0), device=device)
        self.branch_pool = BasicConv(cin, 192, (1, 1), device=device)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _avg_same(x) if self.pool_kind == "avg" else F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3Features(nn.Module):
    """Images [N, H, W, 3] in [0, 1] -> pool3 features [N, 2048] in f32.
    Weights drawn from `seed` (lecun-normal kernels; BatchNorm scale 1, bias
    0, mean 0, var 1) until loaded."""

    def __init__(self, resize_input: bool = True, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), stride=2, device=dev)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3), device=dev)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3), padding=(1, 1), device=dev)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, (1, 1), device=dev)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3), device=dev)
        self.Mixed_5b = InceptionA(192, 32, dev)
        self.Mixed_5c = InceptionA(256, 64, dev)
        self.Mixed_5d = InceptionA(288, 64, dev)
        self.Mixed_6a = InceptionB(288, dev)
        self.Mixed_6b = InceptionC(768, 128, dev)
        self.Mixed_6c = InceptionC(768, 160, dev)
        self.Mixed_6d = InceptionC(768, 160, dev)
        self.Mixed_6e = InceptionC(768, 192, dev)
        self.Mixed_7a = InceptionD(768, dev)
        self.Mixed_7b = InceptionE(1280, "avg", dev)
        self.Mixed_7c = InceptionE(2048, "max", dev)
        gen = make_generator(seed, "cpu")
        with torch.no_grad():
            for conv in (m for m in self.modules() if isinstance(m, nn.Conv2d)):
                # flax's lecun_normal: a normal truncated at 2 std (values
                # beyond drawn again), rescaled to variance 1 / fan_in
                w = torch.randn(conv.weight.shape, generator=gen)
                out = w.abs() > 2.0
                while bool(out.any()):
                    w[out] = torch.randn(int(out.sum()), generator=gen)
                    out = w.abs() > 2.0
                conv.weight.copy_(w * (1.0 / conv.weight[0].numel()) ** 0.5 / 0.87962566103423978)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        if self.resize_input and tuple(x.shape[2:]) != (299, 299):
            x = resize_bilinear(x, (299, 299))
        x = 2.0 * x - 1.0          # [0, 1] -> [-1, 1], pytorch-FID's normalisation
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.mean(dim=(2, 3))

    def load_torch_state_dict(self, state) -> "InceptionV3Features":
        """Load pytorch-FID's state dict (names as this module's; the fc head,
        AuxLogits and BatchNorm batch counters are skipped). Every expected
        weight must be there with its shape, and nothing else, or it
        raises."""
        state = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                 for k, v in state.items()
                 if not k.startswith(_SKIP_PREFIXES) and not k.endswith("num_batches_tracked")}
        own = self.state_dict()
        missing = sorted(set(own) - set(state))
        unused = sorted(set(state) - set(own))
        mismatched = [f"{k}: file {tuple(state[k].shape)} vs model {tuple(own[k].shape)}"
                      for k in sorted(set(own) & set(state))
                      if tuple(state[k].shape) != tuple(own[k].shape)]
        if missing or unused or mismatched:
            raise ValueError(f"inception weight load: missing {missing[:5]}, unused "
                             f"{unused[:5]}, mismatched {mismatched[:5]}")
        self.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
        return self


def load_inception_params(model: InceptionV3Features, params_file: str) -> InceptionV3Features:
    """Load weights from `params_file`: a pytorch-FID checkpoint (``.pt`` /
    ``.pth``), an npz of its names, or the flax-path npz that
    ``scripts/convert_inception_weights.py`` writes ("params/<mod>/conv/
    kernel", "batch_stats/<mod>/bn/mean", ...)."""
    if params_file.endswith(".npz"):
        with np.load(params_file) as npz:
            state = {k: npz[k] for k in npz.files}
        if any("/" in k for k in state):
            from ..convert import flax_tree, inception_state_dict_from_flax
            state = inception_state_dict_from_flax(flax_tree(state))
    else:
        state = torch.load(params_file, map_location="cpu", weights_only=True)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
    return model.load_torch_state_dict(state)


def make_inception_extractor(params_file: Optional[str] = None, seed: int = 0,
                             device: DeviceLike = None):
    """`extractor(images) -> [N, 2048]` features on `device`, for
    ``FIDComputer``. Images are [N, H, W, 3] in [0, 1] (uint8 is divided by
    255), numpy or tensor; a video [N, F, H, W, C] counts its frames as
    samples. Without `params_file` the weights are drawn from `seed`. The
    network is the extractor's ``model``."""
    dev = resolve_device(device)
    model = InceptionV3Features(seed=seed, device=dev)
    if params_file is not None:
        load_inception_params(model, params_file)

    @torch.inference_mode()
    def extractor(images) -> torch.Tensor:
        images = torch.as_tensor(images).to(dev)
        if images.ndim == 5:
            images = images.reshape((-1,) + tuple(images.shape[2:]))
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        return model(images)

    extractor.model = model
    return extractor
