"""The monitored train step's health aux (counterpart of the in-graph half of
``flaxdiff_tpu/telemetry/numerics.py``): global and per-module gradient
norms, parameter norms, update ratios and non-finite counts, and the loss,
computed on the device over the train state's flat buffers.

A module is a top-level child of the model. Its parameters are one
contiguous range of the flat layout (``named_parameters`` walks a module's
subtree whole), so the per-module reductions are segment reductions over
those ranges, a few launches for all of them. The modules carry the JAX
model's top-level names (``time_proj`` is ``TimeProjection_0``), so the aux
has the JAX step's keys.

The anomaly detector and its actions other than ``warn`` are ROADMAP.md
A14's second half; nothing here acts on the aux.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..convert import _RENAME

# the converter's flax -> torch renames, reversed
_JAX_NAMES = {torch_name: flax_name for flax_name, torch_name in _RENAME.items() if torch_name}


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """The monitored step's options. `per_module`: the per-module breakdown
    (a flat-params run has none in the JAX package, so the trainer turns it
    off there); `skip_nonfinite`: gate the update on the global verdict
    (the ``skip_step`` action)."""

    per_module: bool = True
    skip_nonfinite: bool = False


def segment_norms(flat: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
    """The L2 norm of each consecutive segment of `flat` (f32), one
    multi-tensor reduction over views of it."""
    return torch.stack(torch._foreach_norm(list(torch.split(flat, list(lengths)))))


def segment_nonfinite_counts(flat: torch.Tensor, lengths: Sequence[int]) -> torch.Tensor:
    """Non-finite elements of each consecutive segment (int32): the L1
    norms of the 0/1 indicator, exact while a segment holds under 2^24."""
    bad = (~torch.isfinite(flat)).float()
    return torch.stack(torch._foreach_norm(list(torch.split(bad, list(lengths))), 1)).round() \
        .to(torch.int32)


def tree_l2_norm(flat: torch.Tensor) -> torch.Tensor:
    """The global L2 norm of a flat buffer, in f32."""
    return torch.linalg.vector_norm(flat.float())


def tree_nonfinite_count(flat: torch.Tensor) -> torch.Tensor:
    """Non-finite elements of a flat buffer, an int32 on its device."""
    return (~torch.isfinite(flat)).sum(dtype=torch.int32)


def module_segments(layout: Sequence[Tuple[str, int, torch.Size]]) -> List[Tuple[str, int, int]]:
    """``(jax_name, offset, length)`` of each top-level module's range of
    the flat layout, in buffer order; together they tile it."""
    out: List[Tuple[str, int, int]] = []
    for name, off, shape in layout:
        top = name.split(".")[0]
        top = _JAX_NAMES.get(top, top)
        if out and out[-1][0] == top:
            out[-1] = (top, out[-1][1], off + shape.numel() - out[-1][1])
        else:
            if any(t == top for t, _, _ in out):
                raise ValueError(f"module {top}'s parameters are not contiguous in the layout")
            out.append((top, off, shape.numel()))
    return out


def numerics_aux(loss: torch.Tensor, grads: torch.Tensor, params_before: torch.Tensor,
                 params_after: torch.Tensor,
                 modules: Optional[Sequence[Tuple[str, int, int]]] = None,
                 eps: float = 1e-12) -> Dict[str, object]:
    """The aux the monitored step returns, every leaf a device scalar:
    ``loss``, ``grad_norm``, ``param_norm`` (after), ``update_norm``,
    ``update_ratio`` = ||after - before|| / (||before|| + eps) and
    ``grad_nonfinite``; with `modules` (``module_segments``) also
    ``module/<name>/{grad_norm, grad_nonfinite, param_norm, update_ratio}``
    (numerics.py:118-160)."""
    delta = params_after - params_before
    update_norm = tree_l2_norm(delta)
    aux: Dict[str, object] = {
        "loss": loss.detach().float(),
        "grad_norm": tree_l2_norm(grads),
        "param_norm": tree_l2_norm(params_after),
        "update_norm": update_norm,
        "update_ratio": update_norm / (tree_l2_norm(params_before) + eps),
        "grad_nonfinite": tree_nonfinite_count(grads),
    }
    if modules:
        lengths = [n for _, _, n in modules]     # they tile the layout
        g_norm = segment_norms(grads, lengths)
        g_bad = segment_nonfinite_counts(grads, lengths)
        p_norm = segment_norms(params_after, lengths)
        ratio = segment_norms(delta, lengths) / (segment_norms(params_before, lengths) + eps)
        aux["module"] = {name: {"grad_norm": g_norm[i], "grad_nonfinite": g_bad[i],
                                "param_norm": p_norm[i], "update_ratio": ratio[i]}
                         for i, (name, _, _) in enumerate(modules)}
    return aux


def flatten_aux(aux: Dict[str, object], prefix: str = "numerics") -> Dict[str, float]:
    """Device aux -> ``{"numerics/grad_norm": ..., "numerics/module/<m>/<stat>":
    ...}`` on the host, in one device-to-host copy: the one wait a cadence
    step pays."""
    keys, vals = [], []
    for key, val in aux.items():
        if key == "module":
            for mod, stats in val.items():
                for stat, v in stats.items():
                    keys.append(f"{prefix}/module/{mod}/{stat}")
                    vals.append(v)
        else:
            keys.append(f"{prefix}/{key}")
            vals.append(val)
    host = torch.stack([torch.as_tensor(v).double().reshape(()) for v in vals]).cpu().tolist()
    return dict(zip(keys, host))
