"""Model FLOPs: the products a step or a sampling call needs, from the
shapes (every position a backbone runs over) and, for attention, the real
(query, key) pairs; the backward is twice the forward, with nothing
recomputed."""

from __future__ import annotations

import numpy as np

from portbench.counts.attention import decode_pairs, prefix_pairs, \
    query_pairs


def lstm_token(spec: dict) -> int:
    """One position through every LSTM layer: [x, h] (in + H) x 4H."""
    e, h = spec["embed_dim"], spec["hidden_dim"]
    ins = [e] + [h] * (spec["num_layers"] - 1)
    return sum(2 * (i + h) * 4 * h for i in ins)


def block_token(spec: dict) -> int:
    """One position through one transformer block's projections and MLP."""
    e, f = spec["embed_dim"], spec["embed_dim"] * spec["mlp_ratio"]
    return 2 * e * 3 * e + 2 * e * e + 2 * 2 * e * f


def kv_token(spec: dict) -> int:
    """One prefix position's keys and values in the last layer."""
    return 2 * spec["embed_dim"] * 2 * spec["embed_dim"]


def head_token(spec: dict, vocab: int) -> int:
    e = spec["embed_dim"]
    d = spec["hidden_dim"] if spec["model"] == "lstm" else e
    return 2 * (d * e if d != e else 0) + 2 * e * vocab


def _prefix(spec: dict, support_len: np.ndarray) -> int:
    """The transformer's prefix: full blocks below the last layer, the last
    layer's keys and values, causal attention below the last layer."""
    rows, k = support_len.shape
    p = rows * k * spec["max_len"]
    layers, e = spec["num_layers"], spec["embed_dim"]
    return (p * ((layers - 1) * block_token(spec) + kv_token(spec))
            + (layers - 1) * 4 * e * int(prefix_pairs(support_len).sum()))


def train_step(spec: dict, vocab: int, support_len: np.ndarray,
               query_len: np.ndarray) -> int:
    """Forward + backward of one step over episodes with these lengths."""
    b, k = support_len.shape
    q, l = query_len.shape[1], spec["max_len"]
    rows_q = b * q * (l - 1)
    if spec["model"] == "lstm":
        fwd = (b * k * l + rows_q) * lstm_token(spec)
    else:
        fwd = (_prefix(spec, support_len)
               + rows_q * spec["num_layers"] * block_token(spec)
               + spec["num_layers"] * 4 * spec["embed_dim"]
               * query_pairs(support_len, query_len))
    return 3 * (fwd + rows_q * head_token(spec, vocab))


def sample_call(spec: dict, vocab: int, support_len: np.ndarray,
                tokens: np.ndarray) -> int:
    """Forward of one sampling call: rows with support_len [R, K] whose
    returned token counts are tokens [R]."""
    rows, k = support_len.shape
    n = int(tokens.sum())
    if spec["model"] == "lstm":
        prime = rows * k * spec["max_len"] * lstm_token(spec)
        per = n * lstm_token(spec)
    else:
        prime = _prefix(spec, support_len)
        per = (n * spec["num_layers"] * block_token(spec)
               + spec["num_layers"] * 4 * spec["embed_dim"]
               * decode_pairs(support_len, tokens))
    return prime + per + n * head_token(spec, vocab)
