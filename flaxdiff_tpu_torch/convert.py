"""flax -> torch parameter conversion for the UNet.

The torch modules carry the flax module names, so conversion is a rename of
flax's auto-named wrappers plus a re-layout of each leaf:

  nn.Conv kernel HWIO                  -> weight OIHW
  nn.Dense kernel (in, out)            -> weight (out, in)
  to_q/to_k/to_v kernel (C, H, D)      -> weight (H*D, C); bias (H, D) -> (H*D)
  to_out kernel (H, D, C)              -> weight (C, H*D)
  GroupNorm/LayerNorm scale, bias      -> weight, bias

The Fourier frequencies are not a flax parameter (the JAX model draws them
from a fixed key in ``setup``), so the caller passes them.
"""
from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch

# flax's auto names -> the torch attribute names (None: the level is dropped,
# its parameters belong to the enclosing torch module)
_RENAME = {
    "FourierEmbedding_0": "time_embed",
    "TimeProjection_0": "time_proj",
    "Dense_0": "dense_0",
    "Dense_1": "dense_1",
    "ConvLayer_0": "conv",
    "Conv_0": None,
}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value, dtype=np.float32)


def _leaf(parent: str, name: str, a: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "scale":
        return "weight", a
    if name == "bias":
        return "bias", a.reshape(-1)
    if name != "kernel":
        raise KeyError(f"unexpected flax leaf {name!r}")
    if a.ndim == 4:
        return "weight", a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return "weight", a.T
    if a.ndim == 3 and parent == "to_out":
        return "weight", a.reshape(-1, a.shape[-1]).T
    if a.ndim == 3:
        return "weight", a.reshape(a.shape[0], -1).T
    raise ValueError(f"unexpected kernel rank {a.ndim}")


def unet_state_dict_from_flax(params: Mapping, fourier_freqs: np.ndarray
                              ) -> dict[str, torch.Tensor]:
    """A torch ``Unet`` state dict from the JAX ``Unet``'s params tree
    (numpy or jax leaves) and its FourierEmbedding frequencies."""
    state = {}
    for path, a in _flatten(params):
        mods = [_RENAME.get(m, m) for m in path[:-1]]
        key, w = _leaf(path[-2] if len(path) > 1 else "", path[-1], a)
        state[".".join([m for m in mods if m is not None] + [key])] = \
            torch.from_numpy(np.ascontiguousarray(w))
    state["time_embed.freqs"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(fourier_freqs, dtype=np.float32)))
    return state
