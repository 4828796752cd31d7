"""Real (query, key) pairs of the episodic transformer's attention."""

from __future__ import annotations

import numpy as np


def prefix_pairs(support_len: np.ndarray) -> np.ndarray:
    """[B] causal pairs among the real positions of each episode's prefix
    (its K support songs laid end to end, pads between them masked)."""
    s = support_len.astype(np.int64)
    before = np.cumsum(s, axis=1) - s
    return (s * before + s * (s + 1) // 2).sum(axis=1)


def query_pairs(support_len: np.ndarray, query_len: np.ndarray) -> int:
    """Pairs of the query songs' real input positions (t < len - 1): each
    sees the episode's real prefix and its own real positions up to t."""
    prefix = support_len.astype(np.int64).sum(axis=1)           # [B]
    q = np.maximum(query_len.astype(np.int64) - 1, 0)           # [B, Q]
    return int((q * prefix[:, None] + q * (q + 1) // 2).sum())


def decode_pairs(support_len: np.ndarray, tokens: np.ndarray) -> int:
    """Pairs of decoding `tokens` [R] tokens in each row after a prefix of
    support_len [R, K]: token i sees the real prefix and i + 1 slots."""
    prefix = support_len.astype(np.int64).sum(axis=1)
    n = tokens.astype(np.int64)
    return int((n * prefix + n * (n + 1) // 2).sum())
