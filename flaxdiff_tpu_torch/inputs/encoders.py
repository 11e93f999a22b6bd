"""Conditioning encoders (counterpart of ``flaxdiff_tpu/inputs/encoders.py``).

Only the offline ``HashTextEncoder`` is ported: its md5 tokenizer and
masked-mean mixing are the JAX package's. Its embedding table there is
``jax.random.normal(PRNGKey(0), (vocab, features))`` (encoders.py:131), a
threefry draw torch cannot reproduce, so the port's encoder takes its table
as an argument and otherwise draws one from a seeded ``torch.Generator``.
The training CLI saves the table it trained with beside the checkpoints
(``hash_table.npy``) so that inference encodes prompts with the same one;
``scripts/export_flax_checkpoint.py`` writes the JAX table there.

CLIP needs downloaded weights (ROADMAP.md A5); the audio encoders come with
video (A9).
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


class HashTokenizer:
    """Deterministic, vocabulary-free tokenizer: md5 word hashing; id 0 pads,
    1 marks the empty string (flaxdiff_tpu/inputs/encoders.py:95-121)."""

    def __init__(self, vocab_size: int, model_max_length: int):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length

    def _word_id(self, word: str) -> int:
        h = hashlib.md5(word.encode("utf-8")).digest()
        return 2 + int.from_bytes(h[:4], "little") % (self.vocab_size - 2)

    def __call__(self, data: Sequence[str], max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        max_length = max_length or self.model_max_length
        ids = np.zeros((len(data), max_length), dtype=np.int32)
        mask = np.zeros((len(data), max_length), dtype=np.int32)
        for i, text in enumerate(data):
            words = str(text).lower().split()[:max_length] or ["<empty>"]
            toks = [1] if words == ["<empty>"] else [self._word_id(w) for w in words]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class HashTextEncoder:
    """Offline text encoder: token embeddings from a fixed table plus 0.1 x
    their masked mean, masked ([B, max_length, features] f32 on the CPU;
    flaxdiff_tpu/inputs/encoders.py:124-182). `table` ([vocab, features])
    defaults to a standard normal draw from a ``torch.Generator`` seeded
    with 0."""

    key = "text"

    def __init__(self, vocab_size: int = 4096, features: int = 64, max_length: int = 77,
                 table: "np.ndarray | torch.Tensor | None" = None):
        self.vocab_size, self.features, self.max_length = vocab_size, features, max_length
        self.tokenizer = HashTokenizer(vocab_size, max_length)
        if table is None:
            table = torch.randn((vocab_size, features), generator=torch.Generator().manual_seed(0))
        self.table = torch.from_numpy(np.array(table, dtype=np.float32))
        if tuple(self.table.shape) != (vocab_size, features):
            raise ValueError(f"table {tuple(self.table.shape)}, want {(vocab_size, features)}")

    def tokenize(self, data: Sequence[str]) -> Dict[str, np.ndarray]:
        return self.tokenizer(data)

    def encode_from_tokens(self, tokens: Dict[str, np.ndarray]) -> torch.Tensor:
        emb = self.table[torch.as_tensor(tokens["input_ids"]).long()]
        mask = torch.as_tensor(tokens["attention_mask"])[..., None].to(emb.dtype)
        ctx = (emb * mask).sum(dim=1, keepdim=True) / (mask.sum(dim=1, keepdim=True) + 1e-6)
        return emb * mask + 0.1 * ctx

    def __call__(self, data: Sequence[str]) -> torch.Tensor:
        return self.encode_from_tokens(self.tokenize(data))

    def serialize(self) -> Dict[str, Any]:
        """The JAX package's keys, so either package reads the config."""
        return {"type": "hash", "vocab_size": self.vocab_size, "features": self.features,
                "max_length": self.max_length}

    @staticmethod
    def deserialize(config: Dict[str, Any], table=None) -> "HashTextEncoder":
        return HashTextEncoder(vocab_size=config["vocab_size"], features=config["features"],
                               max_length=config["max_length"], table=table)


def _not_ported(name: str, item: str):
    class NotPorted:
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(f"the {name} encoder is not ported: ROADMAP.md {item}")

        @staticmethod
        def deserialize(config, table=None):
            raise NotImplementedError(f"the {name} encoder is not ported: ROADMAP.md {item}")

    NotPorted.__name__ = name
    return NotPorted


CLIPTextEncoder = _not_ported("CLIPTextEncoder", "A5")
MelAudioEncoder = _not_ported("MelAudioEncoder", "A9")

# the JAX registry's keys (flaxdiff_tpu/inputs/encoders.py), none dropped
CONDITIONAL_ENCODERS_REGISTRY: Dict[str, Any] = {
    "clip": CLIPTextEncoder,
    "hash": HashTextEncoder,
    "text": CLIPTextEncoder,
    "mel_audio": MelAudioEncoder,
    "audio": MelAudioEncoder,
}
