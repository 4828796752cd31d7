"""Transformer-decoder backbone (config #4): pre-norm RMSNorm blocks, fused
QKV projection, rotate-half RoPE, fp32 softmax, bf16 matmul operands under
``compute_dtype: bfloat16``.

Port of ``fewshot/models/transformer.py``.  Episodic conditioning: the K
support songs form an attention PREFIX whose per-layer states are computed
once per episode, and each of the Q query songs attends to (prefix ++
itself) through the prefix-attention kernels (``ops/prefix_attention.py``).
Sampling decodes with a static KV cache (``init_kv_cache``, ``prefill``,
``transformer_step``).

Every matmul that the JAX code runs at the compute dtype with fp32
accumulation goes through ``models.lstm.matmul_f32``; rounding points are
the JAX code's (``transformer.py:79-135``).  ``jax.nn.gelu`` is the tanh
approximation.  ``transformer_prefix_forward`` does not compute the last
layer's prefix-stream self-attention, output projection and MLP: they feed
nothing (XLA deletes them from the JAX program), so the outputs and grads
are the same.  ``cfg.remat`` checkpoints each block
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX package): its
activations are recomputed in the backward, the attention kernels'
forward included, which are deterministic, so remat changes no bit of the
blocks' gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fewshot_torch.models.lstm import matmul_f32
from fewshot_torch.ops.attention import causal_attention
from fewshot_torch.ops.prefix_attention import (NEG,
                                                causal_self_attention_flash,
                                                episodic_attention)


def _dt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class TransformerLayer(nn.Module):
    """One block's parameters: ln1 [E], wqkv [E, 3E], wo [E, E], ln2 [E],
    w1 [E, F], w2 [F, E] (the JAX layouts)."""

    def __init__(self, ln1, wqkv, wo, ln2, w1, w2):
        super().__init__()
        for name, value in (("ln1", ln1), ("wqkv", wqkv), ("wo", wo),
                            ("ln2", ln2), ("w1", w1), ("w2", w2)):
            self.register_parameter(name, nn.Parameter(value))


class Transformer(nn.Module):
    """The JAX tree ``{"layers": [...], "ln_f": [E]}`` as a module."""

    def __init__(self, layers: nn.ModuleList, ln_f: torch.Tensor):
        super().__init__()
        self.layers = layers
        self.ln_f = nn.Parameter(ln_f)


def init_transformer_params(cfg, generator: torch.Generator) -> Transformer:
    """Glorot-uniform matrices and unit norm scales, from a CPU generator."""
    e = cfg.embed_dim
    f = cfg.mlp_ratio * e

    def glorot(shape):
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        return (torch.rand(shape, generator=generator) * 2 - 1) * limit

    layers = nn.ModuleList([
        TransformerLayer(torch.ones(e), glorot((e, 3 * e)), glorot((e, e)),
                         torch.ones(e), glorot((e, f)), glorot((f, e)))
        for _ in range(cfg.num_layers)])
    return Transformer(layers, torch.ones(e))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * rms * scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding, rotate-half: lane i pairs with lane i + hd/2.
    x [..., T, nh, hd], positions [..., T]."""
    hd = x.shape[-1]
    freqs = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                            device=x.device) / hd))
    angles = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(layer, x, positions, cfg):
    """x [B, T, E] -> q, k, v each [B, T, nh, hd], RoPE on q and k."""
    dt = _dt(cfg)
    b, t, e = x.shape
    nh = cfg.num_heads
    hd = e // nh
    qkv = matmul_f32(rmsnorm(x, layer.ln1), layer.wqkv, dt).to(dt)
    q, k, v = qkv.split(e, dim=-1)
    q = rope(q.reshape(b, t, nh, hd), positions)
    k = rope(k.reshape(b, t, nh, hd), positions)
    return q, k, v.reshape(b, t, nh, hd)


def _attend(q, k, v, bias):
    """q [B,Tq,nh,hd], k/v [B,Tk,nh,hd], bias [B,1,Tq,Tk] -> [B,Tq,E]."""
    b, tq, nh, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(b, tq, nh * hd)


def _mlp(layer, x, cfg):
    dt = _dt(cfg)
    h = matmul_f32(rmsnorm(x, layer.ln2), layer.w1, dt)
    return matmul_f32(F.gelu(h, approximate="tanh"), layer.w2, dt)


def _block_out(layer, h, attn, cfg):
    """h + attn wo, then + MLP: the block's residual tail, in h's dtype."""
    dt = _dt(cfg)
    h = h + matmul_f32(attn, layer.wo, dt).to(dt)
    return h + _mlp(layer, h, cfg).to(dt)


def _remat(block, cfg):
    """block, or block under activation checkpointing when cfg.remat and
    a backward can follow.  The blocks draw no random numbers, so the RNG
    state is not stashed.  Inside a torch.func transform (finetune's
    per-episode passes) the block runs plainly: torch.func has no saved
    tensor hooks, and checkpointing changes memory, not values."""
    if not (cfg.remat and torch.is_grad_enabled()) or \
            torch._C._functorch.maybe_current_level() is not None:
        return block
    return lambda *args: checkpoint(block, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def transformer_forward(params: Transformer, x: torch.Tensor,
                        mask: torch.Tensor | None, cfg) -> torch.Tensor:
    """x [B, T, E] embeddings -> hidden [B, T, E] (pre-head)."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)

    def block(h, layer):
        q, k, v = _qkv(layer, h, positions, cfg)
        return _block_out(layer, h,
                          causal_attention(q, k, v, mask, cfg.flash), cfg)

    block = _remat(block, cfg)
    h = x.to(_dt(cfg))
    for layer in params.layers:
        h = block(h, layer)
    return rmsnorm(h, params.ln_f)


def _self_attention(q, k, v, mask, cfg):
    """The prefix stream's (and the prefill's) causal self-attention: the
    kernels under prefix_flash, else the cfg.flash dispatch."""
    if cfg.prefix_flash:
        return causal_self_attention_flash(q, k, v, mask)
    return causal_attention(q, k, v, mask, cfg.flash)


def transformer_prefix_forward(params: Transformer, prefix_x: torch.Tensor,
                               prefix_mask: torch.Tensor,
                               query_x: torch.Tensor,
                               query_mask: torch.Tensor, cfg) -> torch.Tensor:
    """Episodic forward: prefix context computed once, shared by Q queries.

    prefix_x [B, P, E], prefix_mask [B, P]; query_x [B, Q, Lq, E],
    query_mask [B, Q, Lq] (key side).  Returns hidden [B, Q, Lq, E]."""
    b, p, e = prefix_x.shape
    _, q_, lq, _ = query_x.shape
    dt = _dt(cfg)
    nh = cfg.num_heads
    dev = prefix_x.device
    pos_p = torch.arange(p, device=dev).expand(b, p)
    # query songs restart their positions after the (padded) prefix
    pos_q = (torch.arange(lq, device=dev) + p).expand(b * q_, lq)
    last = len(params.layers) - 1

    def block(hp, hq, layer, prefix_out: bool):
        pq, pk, pv = _qkv(layer, hp, pos_p, cfg)
        if prefix_out:      # the last layer's prefix stream feeds nothing
            hp = _block_out(layer, hp,
                            _self_attention(pq, pk, pv, prefix_mask, cfg),
                            cfg)
        qq, qk, qv = (x.reshape(b, q_, lq, nh, e // nh)
                      for x in _qkv(layer, hq, pos_q, cfg))
        attn = episodic_attention(qq, qk, qv, pk, pv, query_mask,
                                  prefix_mask, cfg.prefix_flash)
        return hp, _block_out(layer, hq, attn.reshape(b * q_, lq, e), cfg)

    block = _remat(block, cfg)
    hp = prefix_x.to(dt)
    hq = query_x.to(dt).reshape(b * q_, lq, e)
    for i, layer in enumerate(params.layers):
        hp, hq = block(hp, hq, layer, i < last)
    return rmsnorm(hq, params.ln_f).reshape(b, q_, lq, e)


# ---------------------------------------------------------------------------
# KV-cache incremental decoding (sampling path)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int,
                  device: torch.device | str = "cpu") -> dict:
    nh = cfg.num_heads
    hd = cfg.embed_dim // nh
    shape = (cfg.num_layers, batch, max_len, nh, hd)
    return {"k": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "valid": torch.zeros((batch, max_len), dtype=torch.bool,
                                 device=device)}


def prefill(params: Transformer, x: torch.Tensor, mask: torch.Tensor | None,
            cache: dict, cfg) -> dict:
    """Fill the KV cache with a (support) prefix in one forward pass.

    x [B, P, E], mask [B, P]; writes K/V for positions [0, P) and marks the
    valid slots (in place).  Decode continues from idx = P."""
    b, p, _ = x.shape
    positions = torch.arange(p, device=x.device).expand(b, p)
    h = x.to(_dt(cfg))
    for li, layer in enumerate(params.layers):
        q, k, v = _qkv(layer, h, positions, cfg)
        cache["k"][li, :, :p] = k
        cache["v"][li, :, :p] = v
        h = _block_out(layer, h, _self_attention(q, k, v, mask, cfg), cfg)
    cache["valid"][:, :p] = True if mask is None else mask
    return cache


def transformer_step(params: Transformer, x_t: torch.Tensor, cache: dict,
                     idx: int, cfg) -> tuple[torch.Tensor, dict]:
    """One decode step.  x_t [B, E] at position idx; returns (hidden [B,
    E], cache), the cache updated in place.  The cache holds K/V for
    positions < idx; ``valid`` masks its pad slots."""
    b, _ = x_t.shape
    h = x_t[:, None].to(_dt(cfg))                         # [B, 1, E]
    pos = torch.full((b, 1), idx, device=x_t.device)
    valid = cache["valid"]
    valid[:, idx] = True
    key_ok = valid & (torch.arange(valid.shape[1], device=x_t.device) <= idx)
    bias = torch.where(key_ok, 0.0, NEG)[:, None, None, :]
    for li, layer in enumerate(params.layers):
        q, k, v = _qkv(layer, h, pos, cfg)
        cache["k"][li, :, idx] = k[:, 0]
        cache["v"][li, :, idx] = v[:, 0]
        attn = _attend(q, cache["k"][li], cache["v"][li], bias)
        h = _block_out(layer, h, attn, cfg)
    return rmsnorm(h, params.ln_f)[:, 0], cache
