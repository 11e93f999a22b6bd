"""The port stands alone: it never imports jax, flax or the JAX package,
and its entry points refuse to fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "flaxdiff_tpu_torch"
FORBIDDEN = ("jax", "flax", "flaxdiff_tpu")


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_entry_points_default_to_cuda():
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.samplers import DDIMSampler, DiffusionSampler
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Unet(feature_depths=(8,), norm_groups=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionSampler(lambda x, t, c: x, CosineNoiseSchedule(10),
                         EpsilonPredictionTransform(), DDIMSampler())
    assert Unet(feature_depths=(8,), norm_groups=2, device="cpu") is not None
    from flaxdiff_tpu_torch.models import SimpleDiT
    dit = dict(patch_size=2, emb_features=16, num_layers=1, num_heads=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimpleDiT(**dit)
    assert SimpleDiT(**dit, device="cpu") is not None
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer
    model = Unet(feature_depths=(8,), norm_groups=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionTrainer(model, AdamW(1e-4), CosineNoiseSchedule(10),
                         EpsilonPredictionTransform())
    assert DiffusionTrainer(model, AdamW(1e-4), CosineNoiseSchedule(10),
                            EpsilonPredictionTransform(), device="cpu") is not None


def test_fit_pipeline_and_cli_default_to_cuda(tmp_path):
    """The fit loop's upload, the inference pipeline and the training CLI
    take CUDA unless given the CPU: without a card they raise, never fall
    back (fit runs on its trainer's device, which defaults the same way)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from flaxdiff_tpu_torch import train
    from flaxdiff_tpu_torch.data import prefetch_to_device
    from flaxdiff_tpu_torch.inference import DiffusionInferencePipeline, build_model
    from flaxdiff_tpu_torch.models import Unet
    from flaxdiff_tpu_torch.predictors import EpsilonPredictionTransform
    from flaxdiff_tpu_torch.schedulers import CosineNoiseSchedule
    from flaxdiff_tpu_torch.trainer import AdamW, DiffusionTrainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--checkpoint_dir", str(tmp_path / "run"), "--total_steps", "1"])
    config = {"model": {"name": "unet", "feature_depths": [8], "norm_groups": 2}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffusionInferencePipeline.from_config(config, params={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("unet", feature_depths=(8,), norm_groups=2)
    assert DiffusionInferencePipeline.from_config(config, params={}, device="cpu") is not None
    # fit's upload goes to the trainer's device: a CUDA one cannot be made
    # here, and prefetch_to_device raises on a CUDA target without a card
    with pytest.raises((RuntimeError, AssertionError)):
        prefetch_to_device(iter([{"sample": torch.zeros(1)}]), "cuda")
    trainer = DiffusionTrainer(Unet(feature_depths=(8,), norm_groups=2, device="cpu"),
                               AdamW(1e-4), CosineNoiseSchedule(10), EpsilonPredictionTransform(),
                               device="cpu")
    hist = trainer.fit(iter([{"sample": torch.zeros(1, 8, 8, 3, dtype=torch.uint8)}]),
                       total_steps=1)
    assert hist["steps"] == [1] and trainer.state.params.device.type == "cpu"


def test_cuda_tensors_never_take_the_plain_path():
    """Without a card a CUDA tensor cannot exist, so the wrappers' device
    check is exercised with a meta tensor: anything not on the CPU must go
    to the kernel or raise, never to the plain version."""
    from flaxdiff_tpu_torch.ops import flash_attention, fused_geglu, fused_groupnorm_silu
    meta = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(meta(1, 8, 2, 64), meta(1, 8, 2, 64), meta(1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fused_geglu(meta(1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fused_groupnorm_silu(meta(1, 8, 16), meta(16), meta(16), groups=4)


def test_backward_kernels_never_take_the_plain_path():
    """The backward wrappers follow the same rule: a tensor not on the CPU
    goes to the kernel or raises."""
    from flaxdiff_tpu_torch.ops import (flash_bwd_dkv, flash_bwd_dq, geglu_bwd,
                                        groupnorm_bwd_dx, groupnorm_bwd_stats)
    meta = lambda *s: torch.empty(*s, device="meta")
    q, rows = meta(1, 8, 2, 64), meta(1, 2, 8)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, rows, rows)
    x, stats, c = meta(1, 8, 16), meta(1, 4), meta(16)
    with pytest.raises(ValueError, match="CUDA"):
        groupnorm_bwd_stats(x, x, stats, stats, c, c, True)
    with pytest.raises(ValueError, match="CUDA"):
        groupnorm_bwd_dx(x, x, stats, stats, c, c, meta(1, 2, 4), True)
    with pytest.raises(ValueError, match="CUDA"):
        geglu_bwd(meta(1, 8, 16), meta(1, 8, 8))


def _cpu_inputs(name):
    """CPU inputs that require grad, at a small size, for each forward kernel."""
    gen = torch.Generator().manual_seed(0)
    leaf = lambda *s: torch.randn(*s, generator=gen).requires_grad_()
    if name.startswith("flash_fwd"):
        d = 320 if name == "flash_fwd_wide" else 32   # head dims above 256: the wide kernels
        return (leaf(1, 8, 2, d), leaf(1, 5, 2, d), leaf(1, 5, 2, d)), {}
    if name == "geglu":
        return (leaf(1, 8, 16),), {}
    if name == "ln_mod":
        return (leaf(1, 8, 16), leaf(1, 1, 16), leaf(1, 1, 16)), {}
    if name == "gate_res":
        return (leaf(1, 8, 16), leaf(1, 1, 16), leaf(1, 8, 16)), {}
    return (leaf(1, 8, 16), leaf(16), leaf(16)), {"groups": 4}


def test_differentiable_ops_record_their_function():
    """Every forward kernel with a backward, reached through its
    differentiable op on CPU inputs that require grad, records the port's
    autograd Function: the gradient takes the explicit backward (the plain
    versions here, the backward kernels on the card), never autograd of the
    plain forward, and nothing cuts the graph."""
    from flaxdiff_tpu_torch import ops
    # forward kernel -> (the differentiable op that launches it, the Function
    # whose backward runs the backward kernels)
    differentiable = {
        "flash_fwd": (ops.flash_attention, ops.FlashAttentionFn),
        "flash_fwd_wide": (ops.flash_attention, ops.FlashAttentionFn),
        "gn_stats": (ops.fused_groupnorm_silu, ops.GroupNormSiLUFn),
        "gn_norm": (ops.fused_groupnorm_silu, ops.GroupNormSiLUFn),
        "geglu": (ops.fused_geglu, ops.GEGLUFn),
        "ln_mod": (ops.fused_ln_modulate, ops.LNModulateFn),
        "gate_res": (ops.fused_gate_residual, ops.GateResidualFn),
    }
    assert set(differentiable) == {k for k in ops.KERNEL_WRAPPERS if "bwd" not in k}
    for name, (op, function) in differentiable.items():
        args, kwargs = _cpu_inputs(name)
        out = op(*args, **kwargs)
        assert isinstance(out.grad_fn, function._backward_cls), (name, out.grad_fn)
        grads = torch.autograd.grad(out.sum(), args)
        assert all(g is not None and torch.isfinite(g).all() for g in grads), name
