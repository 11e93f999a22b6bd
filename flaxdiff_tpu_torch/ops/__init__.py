"""Kernels of the port and their plain PyTorch versions.

Every kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors; it counts its launches in ``.launches``.
"""
from __future__ import annotations

from .attention import dot_product_attention
from .flash_attention import flash_attention
from .fused_adaln import fused_geglu
from .fused_norm import fused_groupnorm_silu, groupnorm_normalize, groupnorm_stats

# kernel name -> the wrapper that launches it
KERNEL_WRAPPERS = {
    "flash_fwd": flash_attention,
    "gn_stats": groupnorm_stats,
    "gn_norm": groupnorm_normalize,
    "geglu": fused_geglu,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["dot_product_attention", "flash_attention", "fused_geglu",
           "fused_groupnorm_silu", "groupnorm_normalize", "groupnorm_stats",
           "KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]
