"""Moonlight-16B-A3B's block (the DeepSeek-V3 layer): multi-head latent
attention over a latent KV cache, the first ``first_k_dense_replace``
FFNs SwiGLUs, the rest routed experts beside shared ones, a final norm.
Program side (see __init__.py): ``fewshot_torch/models/moonlight.py``.

Sizes are the configuration's, under the published config's key names;
``build`` reads them back from the weights' shapes.  The constants no
shape carries are the published ones, and the tiny sizes keep them: 6
experts a token, the routed weights' scale 2.446, RoPE base 50000, the
128 + 64 split of a head's query and key lanes.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from portbench.counts.attention import decode_pairs, prefix_pairs, query_pairs
from portbench.inputs import glorot

MODEL = "moonlight"
NOPE, TOP_K, SCALING, ROPE_THETA = 128, 6, 2.446, 50000.0

# 2 heads, r 32, dv 16, 8 experts of 32 and 2 shared, a dense layer of 96
# and 2 expert layers; the cache gate opens wider, for the cache branch to
# weigh in the greedy rows as much as it does at full width
TINY = {"embed_dim": 64, "num_layers": 3, "num_attention_heads": 2,
        "kv_lora_rank": 32, "v_head_dim": 16, "intermediate_size": 96,
        "n_routed_experts": 8, "moe_intermediate_size": 32,
        "batch_size": 4, "support_size": 2, "query_size": 2,
        "init": {"gate_b": -2.0, "embed_std": 0.1, "eos_b": -30.0,
                 "router_bias_std": 0.01, "gain": {"w": 0.3}}}


def _sizes(spec: dict) -> dict:
    return {"e": spec["embed_dim"], "nh": spec["num_attention_heads"],
            "r": spec["kv_lora_rank"], "dn": spec["qk_nope_head_dim"],
            "dr": spec["qk_rope_head_dim"], "dv": spec["v_head_dim"],
            "f": spec["intermediate_size"], "x": spec["n_routed_experts"],
            "w": spec["moe_intermediate_size"],
            "sw": spec["n_shared_experts"] * spec["moe_intermediate_size"],
            "k": spec["num_experts_per_tok"],
            "dense": spec["first_k_dense_replace"],
            "layers": spec["num_layers"]}


def leaves(spec: dict) -> list:
    z = _sizes(spec)
    e, nh, r, dr, x, w, sw = (z[k] for k in ("e", "nh", "r", "dr", "x", "w",
                                             "sw"))
    qk, kv = z["dn"] + dr, z["dn"] + z["dv"]
    bias = spec["init"].get("router_bias_std", 0.0)

    def u(name, shape):
        return (name, shape, "u", glorot(shape[-2], shape[-1]), 0.0)
    out = []
    for li in range(z["layers"]):
        p = f"moonlight.layers.{li}."
        out += [(p + "ln1", (e,), "n", 0.1, 1.0), u(p + "wq", (e, nh * qk)),
                u(p + "wkva", (e, r + dr)), (p + "kv_ln", (r,), "n", 0.1, 1.0),
                u(p + "wkvb", (r, nh * kv)), u(p + "wo", (nh * z["dv"], e)),
                (p + "ln2", (e,), "n", 0.1, 1.0)]
        if li < z["dense"]:
            out += [u(p + "w_gate", (e, z["f"])), u(p + "w_up", (e, z["f"])),
                    u(p + "w_down", (z["f"], e))]
        else:
            out += [u(p + "router", (e, x)),
                    (p + "router_bias", (x,), "n", bias, 0.0),
                    u(p + "e_gate", (x, e, w)), u(p + "e_up", (x, e, w)),
                    u(p + "e_down", (x, w, e)), u(p + "s_gate", (e, sw)),
                    u(p + "s_up", (e, sw)), u(p + "s_down", (sw, e))]
    out.append(("moonlight.ln_f", (e,), "n", 0.1, 1.0))
    return out


def width(spec: dict) -> int:
    return spec["embed_dim"]


def build(cfg, w: dict) -> dict:
    """The program's Moonlight around w's tensors, its sizes read from
    their shapes."""
    from fewshot_torch.models import moonlight as moon
    n = cfg.num_layers
    layers = []
    for li in range(n):
        p = f"moonlight.layers.{li}."
        layers.append(moon.MoonlightLayer(**{
            k[len(p):]: v for k, v in w.items() if k.startswith(p)}))
    first, last = layers[0], layers[-1]
    r = first.kv_ln.shape[0]
    dr = first.wkva.shape[1] - r
    nh = first.wq.shape[1] // (NOPE + dr)
    x, e, ew = last.e_gate.shape
    sizes = moon.Sizes(
        hidden=first.ln1.shape[0], heads=nh, kv_rank=r, nope=NOPE, rope=dr,
        v=first.wkvb.shape[1] // nh - NOPE,
        dense_width=first.w_gate.shape[1],
        dense_layers=sum(not layer.experts for layer in layers),
        experts=x, top_k=TOP_K, expert_width=ew,
        shared=last.s_gate.shape[1] // ew, scaling=SCALING,
        rope_theta=ROPE_THETA)
    return {"lstm": None, "transformer": None,
            "moonlight": moon.Moonlight(nn.ModuleList(layers),
                                        w["moonlight.ln_f"], sizes)}


# -- FLOPs ------------------------------------------------------------------

def _ffn_token(z: dict, li: int) -> int:
    """One position through layer li's FFN: a SwiGLU of width f, or the
    router and the chosen k experts beside the shared ones."""
    if li < z["dense"]:
        return 2 * 3 * z["e"] * z["f"]
    return (2 * z["e"] * z["x"]
            + 2 * 3 * z["e"] * (z["k"] * z["w"] + z["sw"]))


def _proj_token(z: dict) -> int:
    """The published form's projections of one position: W_q, W_kva,
    W_kvb, W_o."""
    e, nh, r = z["e"], z["nh"], z["r"]
    return 2 * (e * nh * (z["dn"] + z["dr"]) + e * (r + z["dr"])
                + r * nh * (z["dn"] + z["dv"]) + nh * z["dv"] * e)


def _pair(z: dict) -> int:
    """One (query, key) pair of a layer, published form: q.k over dn + dr
    lanes and p v over dv, every head."""
    return 2 * z["nh"] * (z["dn"] + z["dr"] + z["dv"])


def _block_tokens(z: dict) -> int:
    return sum(_proj_token(z) + _ffn_token(z, li)
               for li in range(z["layers"]))


def _prefix(z: dict, rows: int, positions: int,
            support_len: np.ndarray) -> int:
    """The prefix in the published form: full blocks below the last layer
    at every position, the last layer's latent (its output feeds nothing),
    attention over the real pairs below the last layer."""
    below = sum(_proj_token(z) + _ffn_token(z, li)
                for li in range(z["layers"] - 1))
    lat = 2 * z["e"] * (z["r"] + z["dr"])
    return (rows * positions * (below + lat) + (z["layers"] - 1) * _pair(z)
            * int(prefix_pairs(support_len).sum()))


def train_flops(spec: dict, support_len: np.ndarray,
                query_len: np.ndarray) -> int:
    """The prefix, every query position through every block, and the
    query's attention over the prefix and its own earlier positions."""
    z = _sizes(spec)
    b, k = support_len.shape
    q, l = query_len.shape[1], spec["max_len"]
    return (_prefix(z, b, k * l, support_len)
            + b * q * (l - 1) * _block_tokens(z)
            + z["layers"] * _pair(z) * query_pairs(support_len, query_len))


def sample_flops(spec: dict, support_len: np.ndarray,
                 tokens: np.ndarray) -> int:
    """The prefix (prefill, published form), then each token through every
    block in the absorbed form: W_q, W_kva, the query moved into the
    latent and the output out of it (W_uk, W_uv), W_o and the FFN, and
    its attention over the cache's real pairs, q.c over r + dr lanes and
    p c over r."""
    z = _sizes(spec)
    rows, k = support_len.shape
    e, nh, r, dr = z["e"], z["nh"], z["r"], z["dr"]
    absorbed = 2 * (e * nh * (z["dn"] + dr) + e * (r + dr)
                    + nh * z["dn"] * r + nh * r * z["dv"] + nh * z["dv"] * e)
    per_token = sum(absorbed + _ffn_token(z, li)
                    for li in range(z["layers"]))
    pair = 2 * nh * (2 * r + dr)
    return (_prefix(z, rows, k * spec["max_len"], support_len)
            + int(tokens.sum()) * per_token
            + z["layers"] * pair * decode_pairs(support_len, tokens))
