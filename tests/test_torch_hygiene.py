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
