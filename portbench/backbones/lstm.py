"""The episodic LSTM: ``num_layers`` layers of ``hidden_dim``, TF gate
order, its input the embedding.  Program side (see __init__.py)."""

from __future__ import annotations

import numpy as np
from torch import nn

from portbench.counts.flops import lstm_token
from portbench.inputs import glorot

MODEL = "lstm"

# the recurrence kernels' route takes H % 128 == 0; the tiny head is
# narrower, so the embedding spreads wider for the greedy rows to follow
# the backbone (as the cell's do at full width); the cache gate opens
# wider, for the cache branch to weigh in the greedy rows as much as it
# does at full width
TINY = {"embed_dim": 16, "hidden_dim": 128, "batch_size": 4,
        "support_size": 2, "query_size": 2,
        "init": {"gate_b": 0.0, "embed_std": 3.0}}


def leaves(spec: dict) -> list:
    e, h = spec["embed_dim"], spec["hidden_dim"]
    out = []
    ins = e
    for li in range(spec["num_layers"]):
        lim = glorot(ins + h, 4 * h)
        out += [(f"lstm.{li}.wx", (ins, 4 * h), "u", lim, 0.0),
                (f"lstm.{li}.wh", (h, 4 * h), "u", lim, 0.0),
                (f"lstm.{li}.b", (4 * h,), "n", 0.0, 0.0)]
        ins = h
    return out


def width(spec: dict) -> int:
    return spec["hidden_dim"]


def build(cfg, w: dict) -> dict:
    from fewshot_torch.models import lstm as lstm_mod
    return {"lstm": nn.ModuleList([
        lstm_mod.LSTMLayer(*(w[f"lstm.{i}.{k}"] for k in ("wx", "wh", "b")))
        for i in range(cfg.num_layers)]), "transformer": None}


def train_flops(spec: dict, support_len: np.ndarray,
                query_len: np.ndarray) -> int:
    """Every support and query position through every layer."""
    b, k = support_len.shape
    q, l = query_len.shape[1], spec["max_len"]
    return (b * k * l + b * q * (l - 1)) * lstm_token(spec)


def sample_flops(spec: dict, support_len: np.ndarray,
                 tokens: np.ndarray) -> int:
    """The support songs' full length, then one position a token."""
    rows, k = support_len.shape
    n = int(tokens.sum())
    return (rows * k * spec["max_len"] * lstm_token(spec)
            + n * lstm_token(spec))
