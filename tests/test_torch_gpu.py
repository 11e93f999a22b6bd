"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and skip without one. The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""
import pytest
import torch

from flaxdiff_tpu_torch.ops import (flash_attention, fused_geglu, fused_groupnorm_silu,
                                    groupnorm_normalize, groupnorm_stats, launch_counts,
                                    reset_launch_counts)
from flaxdiff_tpu_torch.ops.flash_attention import flash_attention_plain
from flaxdiff_tpu_torch.ops.fused_adaln import geglu_plain

pytestmark = pytest.mark.gpu

# (atol, rtol) per element. bf16/f16: rtol is one output ulp relative to the
# value (2^-7, 2^-10), atol covers p rounded to the input dtype against a
# running (kernel) or final (plain) row max
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2.0 ** -7),
       torch.float16: (5e-4, 2.0 ** -10)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lq,lk,d", [(200, 77, 64), (64, 64, 32), (130, 190, 128)])
def test_flash_kernel_matches_plain(cuda, dtype, lq, lk, d):
    q = _randn(cuda, 2, lq, 3, d, dtype=dtype, seed=1)
    k = _randn(cuda, 2, lk, 3, d, dtype=dtype, seed=2)
    v = _randn(cuda, 2, lk, 3, d, dtype=dtype, seed=3)
    out, lse = flash_attention(q, k, v, return_lse=True)
    ref, ref_lse = flash_attention_plain(q, k, v)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_flash_kernel_takes_strided_projection_views(cuda):
    proj = _randn(cuda, 2, 100, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (t.view(2, 100, 4, 64) for t in proj.split(4 * 64, dim=-1))
    out = flash_attention(q, k, v)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [((2, 300, 128), 8), ((1, 7, 9, 48), 4),
                                          ((2, 16, 1024), 32)])
def test_groupnorm_silu_kernels_match_plain(cuda, dtype, shape, groups):
    x = _randn(cuda, *shape, dtype=dtype) * 3.0 + 1.0
    c = shape[-1]
    w = _randn(cuda, c, seed=4) * 0.1 + 1.0
    b = _randn(cuda, c, seed=5) * 0.1
    out = fused_groupnorm_silu(x, w, b, groups=groups)
    ref = fused_groupnorm_silu(x.cpu(), w.cpu(), b.cpu(), groups=groups)
    # the statistics are summed in another order on the CPU; then the same
    # f32 math, at most one output rounding apart
    torch.testing.assert_close(out.float().cpu(), ref.float(), atol=1e-5, rtol=TOL[dtype][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_kernel_matches_plain(cuda, dtype):
    for shape in [(2, 50, 256), (3, 7, 2 * 13)]:   # 16-byte and scalar paths
        p = _randn(cuda, *shape, dtype=dtype) * 2.0
        torch.testing.assert_close(fused_geglu(p).float(), geglu_plain(p).float(),
                                   atol=1e-5, rtol=TOL[dtype][1])


def test_each_wrapper_counts_its_launches(cuda):
    reset_launch_counts()
    q = _randn(cuda, 1, 64, 2, 64)
    flash_attention(q, q, q)
    fused_groupnorm_silu(_randn(cuda, 1, 16, 32), torch.ones(32, device=cuda),
                         torch.zeros(32, device=cuda), groups=4)
    fused_geglu(_randn(cuda, 1, 4, 64))
    torch.cuda.synchronize()
    assert launch_counts() == {"flash_fwd": 1, "gn_stats": 1, "gn_norm": 1, "geglu": 1}


def test_kernels_raise_on_what_they_cannot_take(cuda):
    q = _randn(cuda, 1, 16, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    x = _randn(cuda, 1, 16, 2 * 64)[..., 1:65]      # one-element offset: misaligned
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(x.view(1, 16, 1, 64), x.view(1, 16, 1, 64), x.view(1, 16, 1, 64))
    h = _randn(cuda, 1, 8, 8, 32).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_groupnorm_silu(h, torch.ones(32, device=cuda), torch.zeros(32, device=cuda),
                             groups=4)
    with pytest.raises(TypeError):
        fused_geglu(_randn(cuda, 1, 4, 8).double())
    # the two kernel wrappers on their own, given a strided [1, 16, 32] view
    x = _randn(cuda, 1, 32, 16).transpose(1, 2)
    stats = torch.zeros(1, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_stats(x, 4)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm_normalize(x, stats, stats + 1.0, torch.ones(32, device=cuda),
                            torch.zeros(32, device=cuda), True)


def test_tiny_unet_forward_card_matches_cpu(cuda):
    from flaxdiff_tpu_torch.models import Unet
    cfg = dict(output_channels=3, emb_features=32, feature_depths=(32, 64),
               attention_configs=(None, {"heads": 2, "dim_head": 32}), num_res_blocks=1,
               norm_groups=8, context_dim=24)
    cpu = Unet(**cfg, device="cpu").eval()
    with torch.no_grad():
        for t in cpu.state_dict().values():
            t.copy_(torch.randn_like(t) * 0.2 if t.ndim < 2
                    else torch.randn_like(t) / t[0].numel() ** 0.5)
    gpu = Unet(**cfg, device=cuda).eval()
    gpu.load_state_dict(cpu.state_dict())
    x, t, c = torch.randn(2, 16, 16, 3), torch.tensor([3.0, 700.0]), torch.randn(2, 5, 24)
    with torch.inference_mode():
        ref = cpu(x, t, c)
        out = gpu(x.to(cuda), t.to(cuda), c.to(cuda)).cpu()
    torch.testing.assert_close(out, ref, atol=1e-4 * max(1.0, float(ref.abs().max())), rtol=0)
