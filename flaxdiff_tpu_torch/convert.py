"""flax -> torch parameter conversion for every ported model.

The torch modules carry the flax module names, so conversion is a rename of
flax's auto-named wrappers plus a re-layout of each leaf:

  nn.Conv kernel HWIO                  -> weight OIHW (a depthwise kernel,
                                          I = 1, becomes [C, 1, kh, kw])
  nn.ConvTranspose kernel HWIO         -> weight [I, O, kh, kw], flipped in
                                          kh and kw (flax correlates with
                                          the kernel as it is, torch's
                                          conv_transpose2d with it flipped)
  nn.Dense kernel (in, out)            -> weight (out, in)
  to_q/to_k/to_v kernel (C, H, D)      -> weight (H*D, C); bias (H, D) -> (H*D)
  to_out kernel (H, D, C)              -> weight (C, H*D)
  GroupNorm/LayerNorm/RMSNorm scale    -> weight; bias -> bias
  PositionalEncoding pos_encoding      -> pos_encoding
  S5 log_A_real, A_imag, B_re, B_im,   -> the same, as they are
  C_re, C_im, D, log_dt

The Fourier frequencies are not a flax parameter (the JAX models draw them
from a fixed key in ``setup``), so the caller passes them, or the port's
table of the same draws fills them (``models/common.py``).

Any tree of the params' structure converts the same way: gradients, and the
AdamW moments of ``train_state_from_flax``.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

# flax's auto names -> the torch attribute names (None: the level is dropped,
# its parameters belong to the enclosing torch module)
_RENAME = {
    "FourierEmbedding_0": "time_embed",
    "TimeProjection_0": "time_proj",
    "Dense_0": "dense_0",
    "Dense_1": "dense_1",
    "ConvLayer_0": "conv",
    "Conv_0": None,
    "SeparableConv_0": None,
    "ConvTranspose_0": None,
}

# the S5 layer's parameters, copied as they are
_S5_LEAVES = {"log_A_real", "A_imag", "B_re", "B_im", "C_re", "C_im", "D", "log_dt"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.array(value, dtype=np.float32)


def _leaf(parent: str, name: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "pos_encoding" or name in _S5_LEAVES:
        return name, a
    if name == "scale":
        return "weight", a
    if name == "bias":
        return "bias", a.reshape(-1)
    if name != "kernel":
        raise KeyError(f"unexpected flax leaf {name!r}")
    if a.ndim == 4 and parent == "ConvTranspose_0":
        return "weight", a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if a.ndim == 4:
        return "weight", a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return "weight", a.T
    if a.ndim == 3 and parent == "to_out":
        return "weight", a.reshape(-1, a.shape[-1]).T
    if a.ndim == 3:
        return "weight", a.reshape(a.shape[0], -1).T
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def state_dict_from_flax(model: nn.Module, params: Mapping,
                         fourier_freqs: Optional[np.ndarray] = None) -> dict[str, torch.Tensor]:
    """A state dict for `model` (a ported model, or one of its modules) from
    the parameter tree of its JAX counterpart (numpy or jax leaves). Given
    the FourierEmbedding frequencies, it fills the model's ``...freqs``
    buffer with them; without, it holds no buffer."""
    state = {}
    for path, a in _flatten(params):
        mods = [_RENAME.get(m, m) for m in path[:-1]]
        key, w = _leaf(path[-2] if len(path) > 1 else "", path[-1], a)
        state[".".join([m for m in mods if m is not None] + [key])] = \
            torch.from_numpy(np.ascontiguousarray(w))
    if fourier_freqs is not None:
        key = next(name for name, _ in model.named_buffers() if name.endswith("freqs"))
        state[key] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(fourier_freqs, dtype=np.float32)))
    return state


def train_state_from_flax(flax_state: Any, model: nn.Module, tx: Any):
    """A port ``TrainState`` for ``model`` (any ported model) from a JAX
    ``TrainState`` with an ``optax.adamw`` optimizer: params and
    EMA through ``state_dict_from_flax``, adamw's ``mu``/``nu`` as the moments
    and its ``count`` as the step. ``tx`` is the port's ``AdamW``."""
    from .trainer.train_state import TrainState

    adam = [s for s in flax_state.opt_state if hasattr(s, "mu") and hasattr(s, "nu")]
    if len(adam) != 1:
        raise ValueError("want an optax adamw state with one mu/nu pair")
    state = TrainState(model, tx, ema_decay=None if flax_state.ema_params is None else 0.999)
    for flat, tree in ((state.params, flax_state.params), (state.exp_avg, adam[0].mu),
                       (state.exp_avg_sq, adam[0].nu), (state.ema, flax_state.ema_params)):
        if flat is not None:
            flat.copy_(state.flatten(state_dict_from_flax(model, tree)))
    state.step = int(np.asarray(adam[0].count))
    state.count.fill_(state.step)
    return state
