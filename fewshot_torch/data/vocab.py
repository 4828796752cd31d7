"""Vocabulary: token<->id mapping with reserved specials.

Port of ``fewshot/data/vocab.py``: the same specials and the same JSON file,
so a vocab written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from pathlib import Path

PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<pad>", "<s>", "</s>", "<unk>"]


class Vocab:
    def __init__(self, tokens: list[str]):
        if tokens[: len(SPECIALS)] != SPECIALS:
            raise ValueError("vocab must start with the reserved specials")
        self.tokens = list(tokens)
        self.index = {t: i for i, t in enumerate(self.tokens)}
        if len(self.index) != len(self.tokens):
            raise ValueError("vocab contains duplicate tokens")

    def __len__(self) -> int:
        return len(self.tokens)

    def encode(self, toks: list[str]) -> list[int]:
        idx = self.index
        return [idx.get(t, UNK) for t in toks]

    def decode(self, ids) -> list[str]:
        return [self.tokens[int(i)] for i in ids
                if int(i) not in (PAD, BOS, EOS)]

    @classmethod
    def build(cls, counter: Counter, max_size: int) -> "Vocab":
        """Top-(max_size - 4) tokens by count, ties broken alphabetically."""
        n_keep = max(0, max_size - len(SPECIALS))
        most = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))[:n_keep]
        return cls(SPECIALS + [t for t, _ in most])

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.tokens))

    @classmethod
    def load(cls, path: str | Path) -> "Vocab":
        return cls(json.loads(Path(path).read_text()))

    def content_hash(self) -> str:
        """Stable hash of the token list (detects vocab/corpus mismatch)."""
        h = hashlib.sha256("\x00".join(self.tokens).encode())
        return h.hexdigest()[:16]
