"""Model FLOPs: the products a step or a sampling call needs, from the
shapes (every position a backbone runs over) and, for attention, the real
(query, key) pairs; the backward is twice the forward, with nothing
recomputed.  The backbone's part comes from its module
(backbones/<model>.py, ``train_flops`` and ``sample_flops``), which builds
on the per-position counts below; the head's part is added here."""

from __future__ import annotations

import numpy as np

from portbench import cells
from portbench.counts.attention import prefix_pairs


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
    d = cells.backbone(spec["model"]).width(spec)
    return 2 * (d * e if d != e else 0) + 2 * e * vocab


def prefix_flops(spec: dict, support_len: np.ndarray) -> int:
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
    b = support_len.shape[0]
    q, l = query_len.shape[1], spec["max_len"]
    rows_q = b * q * (l - 1)
    fwd = cells.backbone(spec["model"]).train_flops(spec, support_len,
                                                    query_len)
    return 3 * (fwd + rows_q * head_token(spec, vocab))


def sample_call(spec: dict, vocab: int, support_len: np.ndarray,
                tokens: np.ndarray) -> int:
    """Forward of one sampling call: rows with support_len [R, K] whose
    returned token counts are tokens [R]."""
    n = int(tokens.sum())
    fwd = cells.backbone(spec["model"]).sample_flops(spec, support_len,
                                                     tokens)
    return fwd + n * head_token(spec, vocab)
