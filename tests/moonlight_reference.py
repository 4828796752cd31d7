"""A plain float32 reference of Moonlight-16B-A3B's block (the public
DeepSeek-V3 layer that https://huggingface.co/moonshotai/Moonlight-16B-A3B's
``config.json`` names) for the tests of ``fewshot_torch/models/moonlight.py``.

Plain PyTorch and nothing of the port: the published form of multi-head
latent attention with naive per-head K and V, the expert layer by direct
indexing of each token's chosen experts, no cache and no batching tricks.
``strict_fp32`` switches TF32 off.  Parameters are a dict by the port's
names under ``layers.<l>.`` and ``ln_f``; sizes a dict of the same keys
as the port's ``Sizes`` (hidden, heads, kv_rank, nope, rope, v, top_k,
scaling, rope_theta, eps).

Departures from the published model, as the port's: RoPE pairs lane i
with lane i + dr/2 (rotate-half; the checkpoint pairs neighbouring lanes,
a fixed permutation of W_q's and W_kva's rope columns).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def strict_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x [..., S, ..., dr] with positions pos broadcast to x[..., :dr/2]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[..., None] * inv
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def latent(p, s, x, pos):
    """The cache's latent [..., r + dr] of normed inputs x at positions."""
    a = x @ p["wkva"]
    r = s["kv_rank"]
    return torch.cat([rmsnorm(a[..., :r], p["kv_ln"], s["eps"]),
                      rope(a[..., r:], pos, s["rope_theta"])], dim=-1)


def queries(p, s, x, pos):
    """Per-head queries [N, S, nh, dn + dr], RoPE on the last dr lanes."""
    n, t, _ = x.shape
    q = (x @ p["wq"]).reshape(n, t, s["heads"], s["nope"] + s["rope"])
    return torch.cat([q[..., :s["nope"]],
                      rope(q[..., s["nope"]:], pos[:, None],
                           s["rope_theta"])], dim=-1)


def keys_values(p, s, lat):
    """Naive per-head k [N, S, nh, dn + dr] and v [N, S, nh, dv]."""
    n, t, _ = lat.shape
    nh, dn, r = s["heads"], s["nope"], s["kv_rank"]
    kv = (lat[..., :r] @ p["wkvb"]).reshape(n, t, nh, dn + s["v"])
    k_pe = lat[..., None, r:].expand(n, t, nh, s["rope"])
    return torch.cat([kv[..., :dn], k_pe], dim=-1), kv[..., dn:]


def attend(q, k, v, allowed):
    """softmax(q k / sqrt(width) over allowed [N, Sq, Sk]) v, per head:
    q [N, Sq, nh, w], k [N, Sk, nh, w], v [N, Sk, nh, dv] -> [N, Sq, nh dv]."""
    sc = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(q.shape[-1])
    sc = sc.masked_fill(~allowed[:, None], float("-inf"))
    out = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(sc, -1), v)
    return out.reshape(*out.shape[:2], -1)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def route(p, s, x):
    """(chosen experts [M, k], their weights [M, k]) of x [M, E]."""
    g = torch.sigmoid(x @ p["router"])
    top = torch.topk(g + p["router_bias"], s["top_k"], dim=-1).indices
    picked = g.gather(1, top)
    return top, s["scaling"] * picked / picked.sum(-1, keepdim=True)


def expert_layer(p, s, x):
    """sum_k w_k E_k(x) + S(x) for x [M, E], each token's chosen experts'
    weights indexed directly."""
    top, w = route(p, s, x)
    gate, up, down = p["e_gate"][top], p["e_up"][top], p["e_down"][top]
    h = F.silu(torch.einsum("me,mkef->mkf", x, gate)) * torch.einsum(
        "me,mkef->mkf", x, up)
    y = torch.einsum("mkf,mkfe->mke", h, down)
    return (w[..., None] * y).sum(1) + swiglu(x, p["s_gate"], p["s_up"],
                                            p["s_down"])


def layer_count(params):
    return sum(1 for k in params if k.startswith("layers.")
               and k.endswith(".wq"))


def hidden(params, s, x, valid):
    """The causal stack over x [N, S, E] at positions 0..S-1 (a key takes
    part where valid [N, S]), then the final norm: [N, S, E]."""
    n, t, e = x.shape
    pos = torch.arange(t, device=x.device)
    allowed = torch.ones(t, t, dtype=torch.bool, device=x.device).tril() \
        & valid[:, None, :]
    h = x
    for li in range(layer_count(params)):
        p = {k.split(".", 2)[2]: v for k, v in params.items()
             if k.startswith(f"layers.{li}.")}
        xn = rmsnorm(h, p["ln1"], s["eps"])
        k, v = keys_values(p, s, latent(p, s, xn, pos))
        h = h + attend(queries(p, s, xn, pos), k, v, allowed) @ p["wo"]
        xn = rmsnorm(h, p["ln2"], s["eps"]).reshape(n * t, e)
        f = (expert_layer(p, s, xn) if "router" in p else
             swiglu(xn, p["w_gate"], p["w_up"], p["w_down"]))
        h = h + f.reshape(n, t, e)
    return rmsnorm(h, params["ln_f"], s["eps"])
