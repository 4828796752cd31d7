"""Moonlight-16B-A3B's block (the DeepSeek-V3 layer of
https://huggingface.co/moonshotai/Moonlight-16B-A3B) in plain float32:
the K support songs, padded to L each, are one prefix that the query or
the served row follows; the prefix's pad positions take no part as keys.

The published form of multi-head latent attention, with naive per-head
keys and values (``k = [c W_kvb's k_nope, k_pe]``, ``v`` from ``c
W_kvb``), the expert layer by direct indexing of the experts each token
chose (sigmoid scores, the top ``num_experts_per_tok`` of scores plus the
selection bias, weights ``routed_scaling_factor g / sum g``), and the
shared experts as one SwiGLU.  Every size and constant comes from the
configuration (its published key names); RMSNorm has its
``rms_norm_eps`` and RoPE (rotate-half, as the program pairs lanes) its
``rope_theta``.  ``rnd`` rounds the operands of every product that the
configuration runs at its compute dtype; the router runs in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.model import mm

ROWS = 4096         # positions of an FFN product at a time


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta):
    """x [..., S, ..., d] rotate-half at positions pos (broadcast to x's
    leading dims: [S] or [S, 1])."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[..., None] * inv
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x2 * ang.cos() + x1 * ang.sin()], dim=-1)


def _swiglu(x, gate, up, down, rnd):
    return mm(F.silu(mm(x, gate, rnd)) * mm(x, up, rnd), down, rnd)


def _experts(w, spec, x, rnd):
    """sum_k w_k E_k(x) + S(x) of x [M, E]: each expert applied to the
    tokens that chose it."""
    g = torch.sigmoid(x @ w["router"])
    top = torch.topk(g + w["router_bias"], spec["num_experts_per_tok"],
                     dim=-1).indices
    picked = g.gather(1, top)
    wt = spec["routed_scaling_factor"] * picked / picked.sum(-1, keepdim=True)
    y = _swiglu(x, w["s_gate"], w["s_up"], w["s_down"], rnd)
    for e in range(w["router"].shape[1]):
        tok, slot = (top == e).nonzero(as_tuple=True)
        if len(tok):
            y[tok] += wt[tok, slot, None] * _swiglu(
                x[tok], w["e_gate"][e], w["e_up"][e], w["e_down"][e], rnd)
    return y


def _ffn(w, spec, x, rnd):
    out = torch.empty_like(x)
    for lo in range(0, x.shape[0], ROWS):
        part = x[lo:lo + ROWS]
        out[lo:lo + ROWS] = (_experts(w, spec, part, rnd) if "router" in w
                             else _swiglu(part, w["w_gate"], w["w_up"],
                                          w["w_down"], rnd))
    return out


def _layers(p: dict) -> int:
    return sum(1 for k in p if k.startswith("moonlight.layers.")
               and k.endswith(".wq"))


def moon_run(p: dict, x: torch.Tensor, valid: torch.Tensor, spec: dict,
             rnd) -> torch.Tensor:
    """The causal stack over x [N, S, E] at positions 0..S-1; a key takes
    part where valid [N, S] is True.  Returns hidden [N, S, E]."""
    n, s, e = x.shape
    nh, r = spec["num_attention_heads"], spec["kv_lora_rank"]
    dn, dr, dv = (spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
                  spec["v_head_dim"])
    eps, theta = spec["rms_norm_eps"], spec["rope_theta"]
    pos = torch.arange(s, device=x.device)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    allowed = causal[None] & valid[:, None, :]               # [N, S, S]
    h = x
    for li in range(_layers(p)):
        pre = f"moonlight.layers.{li}."
        w = {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}
        xn = _rmsnorm(h, w["ln1"], eps).reshape(n * s, e)
        q = mm(xn, w["wq"], rnd).reshape(n, s, nh, dn + dr)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos[:, None], theta)],
                      -1)
        a = mm(xn, w["wkva"], rnd).reshape(n, s, r + dr)
        c = _rmsnorm(a[..., :r], w["kv_ln"], eps)
        k_pe = _rope(a[..., r:], pos, theta)
        kv = mm(c.reshape(n * s, r), w["wkvb"], rnd).reshape(n, s, nh,
                                                             dn + dv)
        k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(n, s, nh, dr)],
                      -1)
        sc = torch.einsum("nqhd,nkhd->nhqk", rnd(q), rnd(k)) \
            / math.sqrt(dn + dr)
        pr = torch.softmax(sc.masked_fill(~allowed[:, None], float("-inf")),
                           dim=-1)
        att = torch.einsum("nhqk,nkhd->nqhd", rnd(pr), rnd(kv[..., dn:]))
        h = h + mm(att.reshape(n * s, nh * dv), w["wo"], rnd).reshape(n, s, e)
        f = _ffn(w, spec, _rmsnorm(h, w["ln2"], eps).reshape(n * s, e), rnd)
        h = h + f.reshape(n, s, e)
    return _rmsnorm(h, p["moonlight.ln_f"], eps)


def episode_hidden(p: dict, spec: dict, support, support_len, inputs,
                   in_mask, rnd) -> torch.Tensor:
    b, k, l = support.shape
    q_ = inputs.shape[1]
    emb = p["embed"]
    prefix = support.reshape(b, k * l)
    pmask = (torch.arange(l, device=support.device)
             < support_len[..., None]).reshape(b, k * l)
    seq = torch.cat([prefix.repeat_interleave(q_, 0),
                     inputs.reshape(b * q_, -1)], dim=1)
    valid = torch.cat([pmask.repeat_interleave(q_, 0),
                       in_mask.reshape(b * q_, -1)], dim=1)
    return moon_run(p, emb[seq], valid, spec, rnd)[:, k * l:]


def served_hidden(p: dict, spec: dict, support, support_len, inputs,
                  rnd) -> torch.Tensor:
    r, n = inputs.shape
    k, l = support.shape[1:]
    dev = inputs.device
    pmask = (torch.arange(l, device=dev)
             < support_len[..., None]).reshape(r, k * l)
    seq = torch.cat([support.reshape(r, k * l), inputs], dim=1)
    valid = torch.cat([pmask, torch.ones(r, n, dtype=torch.bool,
                                         device=dev)], dim=1)
    return moon_run(p, p["embed"][seq], valid, spec, rnd)[:, k * l:]
