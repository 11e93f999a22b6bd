"""Kernels of the port and their plain PyTorch versions.

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors; it counts its launches in ``.launches``. The
differentiable ops (``flash_attention``, ``fused_groupnorm_silu``,
``fused_geglu``, ``fused_ln_modulate``/``fused_ln_modulate2``,
``fused_gate_residual``) are ``torch.autograd.Function``s over those
wrappers, whose backward runs the backward kernels.
"""
from __future__ import annotations

from .attention import dot_product_attention
from .flash_attention import (FlashAttentionFn, flash_attention, flash_bwd_dkv,
                              flash_bwd_dkv_wide, flash_bwd_dq, flash_bwd_dq_wide, flash_fwd,
                              flash_fwd_wide)
from .fused_adaln import (GateResidualFn, GEGLUFn, LNModulateFn, fused_gate_residual,
                          fused_geglu, fused_ln_modulate, fused_ln_modulate2, gate_residual_bwd,
                          gate_residual_fwd, geglu_bwd, geglu_fwd, ln_modulate_bwd,
                          ln_modulate_fwd)
from .fused_norm import (GroupNormSiLUFn, fused_groupnorm_silu, groupnorm_bwd_dx,
                         groupnorm_bwd_stats, groupnorm_normalize, groupnorm_stats)

# kernel name -> the wrapper that launches it
KERNEL_WRAPPERS = {
    "flash_fwd": flash_fwd,
    "flash_bwd_dq": flash_bwd_dq,
    "flash_bwd_dkv": flash_bwd_dkv,
    "flash_fwd_wide": flash_fwd_wide,
    "flash_bwd_dq_wide": flash_bwd_dq_wide,
    "flash_bwd_dkv_wide": flash_bwd_dkv_wide,
    "gn_stats": groupnorm_stats,
    "gn_norm": groupnorm_normalize,
    "gn_bwd_stats": groupnorm_bwd_stats,
    "gn_bwd_dx": groupnorm_bwd_dx,
    "geglu": geglu_fwd,
    "geglu_bwd": geglu_bwd,
    "ln_mod": ln_modulate_fwd,
    "ln_mod_bwd": ln_modulate_bwd,
    "gate_res": gate_residual_fwd,
    "gate_res_bwd": gate_residual_bwd,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["dot_product_attention", "flash_attention", "flash_bwd_dkv", "flash_bwd_dkv_wide",
           "flash_bwd_dq", "flash_bwd_dq_wide", "flash_fwd", "flash_fwd_wide",
           "fused_gate_residual", "fused_geglu", "fused_groupnorm_silu",
           "fused_ln_modulate", "fused_ln_modulate2", "gate_residual_bwd", "gate_residual_fwd",
           "geglu_bwd", "geglu_fwd", "groupnorm_bwd_dx", "groupnorm_bwd_stats",
           "groupnorm_normalize", "groupnorm_stats", "ln_modulate_bwd", "ln_modulate_fwd",
           "FlashAttentionFn", "GateResidualFn", "GEGLUFn", "GroupNormSiLUFn", "LNModulateFn",
           "KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]
