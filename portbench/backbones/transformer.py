"""The episodic transformer: ``num_layers`` pre-norm blocks of width
``embed_dim`` (``num_heads`` heads, MLP ``mlp_ratio`` wide) over the
support prefix and the query, a final norm.  Program side (see
__init__.py)."""

from __future__ import annotations

import numpy as np
from torch import nn

from portbench.counts.attention import decode_pairs, query_pairs
from portbench.counts.flops import block_token, prefix_flops
from portbench.inputs import glorot

MODEL = "transformer"
BLOCK = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")

# the heads stay the configuration's; the cache gate opens wider, for the
# cache branch to weigh in the greedy rows as much as it does at full width
TINY = {"embed_dim": 32, "num_layers": 2, "batch_size": 4,
        "support_size": 2, "query_size": 2,
        "init": {"gate_b": -2.0, "embed_std": 0.1, "eos_b": -30.0,
                 "gain": {"w2": 3.0, "wqkv": 2.0}}}


def leaves(spec: dict) -> list:
    e = spec["embed_dim"]
    f = e * spec["mlp_ratio"]
    out = []
    for li in range(spec["num_layers"]):
        p = f"transformer.layers.{li}."
        out += [(p + "ln1", (e,), "n", 0.1, 1.0),
                (p + "wqkv", (e, 3 * e), "u", glorot(e, 3 * e), 0.0),
                (p + "wo", (e, e), "u", glorot(e, e), 0.0),
                (p + "ln2", (e,), "n", 0.1, 1.0),
                (p + "w1", (e, f), "u", glorot(e, f), 0.0),
                (p + "w2", (f, e), "u", glorot(f, e), 0.0)]
    out.append(("transformer.ln_f", (e,), "n", 0.1, 1.0))
    return out


def width(spec: dict) -> int:
    return spec["embed_dim"]


def build(cfg, w: dict) -> dict:
    from fewshot_torch.models import transformer as tfm_mod
    return {"lstm": None, "transformer": tfm_mod.Transformer(nn.ModuleList([
        tfm_mod.TransformerLayer(*(w[f"transformer.layers.{i}.{k}"]
                                   for k in BLOCK))
        for i in range(cfg.num_layers)]), w["transformer.ln_f"])}


def train_flops(spec: dict, support_len: np.ndarray,
                query_len: np.ndarray) -> int:
    """The prefix, every query position through every block, and the
    query's attention over the prefix and its own earlier positions."""
    b, _ = support_len.shape
    q, l = query_len.shape[1], spec["max_len"]
    rows_q = b * q * (l - 1)
    return (prefix_flops(spec, support_len)
            + rows_q * spec["num_layers"] * block_token(spec)
            + spec["num_layers"] * 4 * spec["embed_dim"]
            * query_pairs(support_len, query_len))


def sample_flops(spec: dict, support_len: np.ndarray,
                 tokens: np.ndarray) -> int:
    """The prefix, then each token through every block and its attention
    over the cache."""
    n = int(tokens.sum())
    prime = prefix_flops(spec, support_len)
    per = (n * spec["num_layers"] * block_token(spec)
           + spec["num_layers"] * 4 * spec["embed_dim"]
           * decode_pairs(support_len, tokens))
    return prime + per
