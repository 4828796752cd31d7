"""Moonlight-16B-A3B's block: multi-head latent attention (MLA) over a
latent KV cache, and a routed expert layer beside shared experts.

The layer equations are the public DeepSeek-V3 block that Moonlight's
``config.json`` names (``model_type: deepseek_v3``,
https://huggingface.co/moonshotai/Moonlight-16B-A3B).  Pre-norm RMSNorm
blocks, ``h += Attn(norm(h)); h += FFN(norm(h))``, a final norm; the
first ``dense_layers`` FFNs are SwiGLUs, the rest expert layers.

* **MLA, published form** (prefill, the episodic forward): ``q = x W_q``
  [nh, dn + dr], RoPE on its last dr lanes; ``a = x W_kva`` [r + dr],
  ``c = norm_kv(a[:r])`` and one ``k_pe = RoPE(a[r:])`` for all heads;
  ``kv = c W_kvb`` [nh, dn + dv] gives ``k = [k_nope, k_pe]`` and v;
  softmax over (dn + dr)-wide scores, scale 1/sqrt(dn + dr), then
  ``W_o``.  It runs on the prefix-attention kernels (7-9) at head width
  dn + dr with V zero-padded to that width and the output sliced back.
* **MLA, absorbed form** (a decode step): the cache holds one latent
  ``[c, k_pe]`` a position and layer, shared by the heads; each head's
  query moves into the latent (``q_nope W_uk^T``), scores are one batched
  product against the cache in place, the output one more over its first
  r lanes, then ``W_uv`` and ``W_o``.  The same function; only rounding
  differs.
* **Expert layer**: sigmoid scores in fp32, the top ``top_k`` of scores
  plus a selection bias (which takes no part in the weights), weights
  ``scaling g / sum g``, ``y = sum_k w_k E_k(x) + S(x)``.  The pairs
  (token, expert) are sorted by expert with offsets that stay on the
  device; each of the two products (gate and up together, then down) is
  one grouped GEMM over all experts on the card (``torch._grouped_mm``),
  and the weighted outputs are put back in token order: no loop over the
  experts and no host sync.  On CPU tensors the plain twin
  (``grouped_mm_plain``) runs the same products a group at a time.

Matrices multiply at the compute dtype with fp32 accumulation (``mm``);
norms, the router, the softmax and the RoPE angles are fp32; the
residual stream is in the compute dtype.  The products' weights are cast
once by ``compute_weights`` (a sampling call does it inside
``sample.support``), so a decode step casts none.  Sizes live on the
module (``Sizes``, defaults the published values), never in ``cfg``.
Spans: ``moe.route`` and ``moe.experts`` per expert layer (and per chunk
of ``CHUNK`` rows), ``sample.attend`` per layer of a decode step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from fewshot_torch.ops.attention import causal_attention
from fewshot_torch.ops.prefix_attention import (NEG,
                                                causal_self_attention_flash,
                                                episodic_attention)
from fewshot_torch.utils.metrics import span

WIDTH = 2048            # the only hidden size init_lm builds
CHUNK = 32768           # rows of an FFN call at a time (prefill's bound)
ALIGN = 8               # keys a decode step reads: a multiple of this


@dataclass(frozen=True)
class Sizes:
    """The block's sizes; the defaults are Moonlight-16B-A3B's."""
    hidden: int = 2048              # hidden_size
    heads: int = 16                 # num_attention_heads
    kv_rank: int = 512              # kv_lora_rank (q_lora_rank: none)
    nope: int = 128                 # qk_nope_head_dim
    rope: int = 64                  # qk_rope_head_dim
    v: int = 128                    # v_head_dim
    dense_width: int = 11264        # intermediate_size
    dense_layers: int = 1           # first_k_dense_replace
    experts: int = 64               # n_routed_experts
    top_k: int = 6                  # num_experts_per_tok
    expert_width: int = 1408        # moe_intermediate_size
    shared: int = 2                 # n_shared_experts
    scaling: float = 2.446          # routed_scaling_factor
    rope_theta: float = 50000.0
    eps: float = 1e-5               # rms_norm_eps

    def __post_init__(self):
        if self.v > self.qk or self.rope % 2 or self.top_k > self.experts:
            raise ValueError(f"unsupported sizes {self}: v_head_dim <= "
                             "qk width, an even rope width and top_k <= "
                             "experts are needed")

    @property
    def qk(self) -> int:
        return self.nope + self.rope


class MoonlightLayer(nn.Module):
    """One block's parameters ([in, out] layouts): the attention's ``ln1``
    [E], ``wq`` [E, nh (dn + dr)], ``wkva`` [E, r + dr], ``kv_ln`` [r],
    ``wkvb`` [r, nh (dn + dv)], ``wo`` [nh dv, E], ``ln2`` [E]; then a
    SwiGLU's ``w_gate``, ``w_up`` [E, F], ``w_down`` [F, E], or the expert
    layer's ``router`` [E, X], ``router_bias`` [X], ``e_gate``, ``e_up``
    [X, E, W], ``e_down`` [X, W, E] and the shared experts as one SwiGLU,
    ``s_gate``, ``s_up`` [E, S W], ``s_down`` [S W, E]."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, value in tensors.items():
            self.register_parameter(name, nn.Parameter(value))

    @property
    def experts(self) -> bool:
        return hasattr(self, "router")


class Moonlight(nn.Module):
    """The blocks, the final norm ``ln_f`` [E] and the sizes."""

    def __init__(self, layers: nn.ModuleList, ln_f: torch.Tensor,
                 sizes: Sizes):
        super().__init__()
        self.layers = layers
        self.ln_f = nn.Parameter(ln_f)
        self.sizes = sizes


def _glorot(shape, generator):
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


def init_moonlight(cfg, generator: torch.Generator) -> Moonlight:
    """The published block at ``cfg.num_layers`` depth (the first dense,
    the rest expert layers): glorot-uniform matrices, unit norms, a zero
    selection bias, from a CPU generator."""
    if cfg.embed_dim != WIDTH:
        raise ValueError(f"model='moonlight' is Moonlight-16B-A3B's block, "
                         f"hidden size {WIDTH}; got embed_dim "
                         f"{cfg.embed_dim}")
    s = Sizes()
    e, nh, r = s.hidden, s.heads, s.kv_rank
    sw = s.shared * s.expert_width

    def g(*shape):
        return _glorot(shape, generator)
    layers = []
    for li in range(cfg.num_layers):
        t = {"ln1": torch.ones(e), "wq": g(e, nh * s.qk),
             "wkva": g(e, r + s.rope), "kv_ln": torch.ones(r),
             "wkvb": g(r, nh * (s.nope + s.v)), "wo": g(nh * s.v, e),
             "ln2": torch.ones(e)}
        if li < s.dense_layers:
            t.update(w_gate=g(e, s.dense_width), w_up=g(e, s.dense_width),
                     w_down=g(s.dense_width, e))
        else:
            x, w = s.experts, s.expert_width
            t.update(router=g(e, x), router_bias=torch.zeros(x),
                     e_gate=g(x, e, w), e_up=g(x, e, w), e_down=g(x, w, e),
                     s_gate=g(e, sw), s_up=g(e, sw), s_down=g(sw, e))
        layers.append(MoonlightLayer(**t))
    return Moonlight(nn.ModuleList(layers), torch.ones(e), s)


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------

def mm(a: torch.Tensor, b: torch.Tensor,
       out: torch.dtype = torch.float32) -> torch.Tensor:
    """a [..., K] @ b [K, N] of compute-dtype operands with fp32
    accumulation, the result in `out`: cuBLAS's bf16 product on the card,
    the fp32 product of the same values on the CPU (and in fp32)."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype == torch.bfloat16:
        y = (torch.mm(a2, b) if out == torch.bfloat16
             else torch.mm(a2, b, out_dtype=out))
    else:
        y = (a2.float() @ b.float()).to(out)
    return y.reshape(*lead, b.shape[-1])


def bmm(a: torch.Tensor, b: torch.Tensor,
        out: torch.dtype = torch.float32) -> torch.Tensor:
    """The batched ``mm``: [G, M, K] @ [G, K, N], operands read through
    their strides (views of the cache stay views)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return (torch.bmm(a, b) if out == torch.bfloat16
                else torch.bmm(a, b, out_dtype=out))
    return (a.float() @ b.float()).to(out)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            dt: torch.dtype) -> torch.Tensor:
    """RMSNorm in fp32 over the last dim, the result in dt."""
    return F.rms_norm(x.float(), (x.shape[-1],), scale, eps).to(dt)


def rope_table(s: Sizes, length: int, device) -> tuple:
    """(cos, sin) [length, dr] fp32 of positions 0..length-1, laid out for
    ``rope``: cos twice, then -sin and sin."""
    inv = 1.0 / (s.rope_theta ** (torch.arange(0, s.rope, 2,
                                               dtype=torch.float32,
                                               device=device) / s.rope))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv
    return (torch.cat([ang.cos(), ang.cos()], -1),
            torch.cat([-ang.sin(), ang.sin()], -1))


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """Rotate-half RoPE of x [..., dr] in fp32, lane i with lane i + dr/2:
    [x1 cos - x2 sin, x2 cos + x1 sin] from ``rope_table``'s cos/sin
    (broadcast to [..., dr])."""
    half = x.shape[-1] // 2
    x = x.float()
    return x * cos + torch.cat([x[..., half:], x[..., :half]], -1) * sin


def compute_weights(m: Moonlight, dt: torch.dtype) -> list:
    """Each layer's weights as the products take them, cast to the compute
    dtype once: gate and up side by side, ``w_uk`` [nh, dn, r] and
    ``w_uv`` [nh, r, dv] (the absorbed form's blocks of W_kvb).  Norms,
    the router and the selection bias stay fp32."""
    s = m.sizes
    out = []
    for layer in m.layers:
        blocks = layer.wkvb.to(dt).view(s.kv_rank, s.heads, s.nope + s.v)
        w = {"ln1": layer.ln1, "kv_ln": layer.kv_ln, "ln2": layer.ln2,
             "wq": layer.wq.to(dt), "wkva": layer.wkva.to(dt),
             "wkvb": blocks.view(s.kv_rank, -1), "wo": layer.wo.to(dt),
             "w_uk": blocks[..., :s.nope].permute(1, 2, 0).contiguous(),
             "w_uv": blocks[..., s.nope:].permute(1, 0, 2).contiguous()}
        if layer.experts:
            w.update(router=layer.router, router_bias=layer.router_bias,
                     e_gu=torch.cat([layer.e_gate, layer.e_up], -1).to(dt),
                     e_down=layer.e_down.to(dt),
                     s_gu=torch.cat([layer.s_gate, layer.s_up], -1).to(dt),
                     s_down=layer.s_down.to(dt))
        else:
            w.update(w_gu=torch.cat([layer.w_gate, layer.w_up], -1).to(dt),
                     w_down=layer.w_down.to(dt))
        out.append(w)
    return out


def _swiglu(gu: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """silu(gate) * up of [.., 2W] (gate, then up), fp32, in dt."""
    g, u = gu.float().chunk(2, dim=-1)
    return (F.silu(g) * u).to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def queries(w: dict, x: torch.Tensor, cos, sin, s: Sizes) -> torch.Tensor:
    """x [..., E] normed (compute dtype) -> q [..., nh, dn + dr] in x's
    dtype, RoPE on its last dr lanes."""
    q = mm(x, w["wq"]).unflatten(-1, (s.heads, s.qk))
    return torch.cat([q[..., :s.nope], rope(q[..., s.nope:],
                                            cos[..., None, :],
                                            sin[..., None, :])],
                     dim=-1).to(x.dtype)


def latent(w: dict, x: torch.Tensor, cos, sin, s: Sizes) -> torch.Tensor:
    """x [..., E] normed -> the cache's latent [..., r + dr] in x's dtype:
    c = norm_kv(a[:r]) and k_pe = RoPE(a[r:]) of a = x W_kva."""
    a = mm(x, w["wkva"])
    c = rmsnorm(a[..., :s.kv_rank], w["kv_ln"], s.eps, torch.float32)
    return torch.cat([c, rope(a[..., s.kv_rank:], cos, sin)],
                     -1).to(x.dtype)


def keys_values(w: dict, latent: torch.Tensor, s: Sizes):
    """The published form's per-head k [..., nh, dn + dr] and v, zero-padded
    from dv to the same width, from the latent [..., r + dr]."""
    kv = mm(latent[..., :s.kv_rank], w["wkvb"],
            latent.dtype).unflatten(-1, (s.heads, s.nope + s.v))
    k_pe = latent[..., None, s.kv_rank:].expand(*kv.shape[:-1], s.rope)
    k = torch.cat([kv[..., :s.nope], k_pe], dim=-1)
    return k, F.pad(kv[..., s.nope:], (0, s.qk - s.v))


def _heads_out(o: torch.Tensor, s: Sizes) -> torch.Tensor:
    """[..., nh (dn + dr)] fp32 over padded V -> [..., nh dv]."""
    return o.unflatten(-1, (s.heads, s.qk))[..., :s.v].flatten(-2)


def _self_attention(q, k, v, mask, cfg, s: Sizes) -> torch.Tensor:
    """Causal self-attention of [B, T, nh, dn + dr] streams (V padded):
    the kernels under prefix_flash, else the cfg.flash dispatch; [B, T,
    nh dv] fp32."""
    if cfg.prefix_flash:
        o = causal_self_attention_flash(q, k, v, mask)
    else:
        o = causal_attention(q, k, v, mask, cfg.flash).float()
    return _heads_out(o, s)


def key_bias(valid: torch.Tensor, idx: int) -> torch.Tensor:
    """[B, t] fp32: 0 where a decode step at idx admits a key (valid and
    position <= idx), NEG elsewhere, over the first idx + 1 positions
    rounded up to a multiple of ALIGN (so that the products' rows stay
    aligned); one a step, shared by the layers."""
    t = min(valid.shape[1], -(-(idx + 1) // ALIGN) * ALIGN)
    ok = valid[:, :t] & (torch.arange(t, device=valid.device) <= idx)
    return torch.where(ok, 0.0, NEG)


def latent_attention(q: torch.Tensor, w: dict, latent: torch.Tensor,
                     bias: torch.Tensor, s: Sizes) -> torch.Tensor:
    """A decode step's attention in the absorbed form.  q [B, nh, dn + dr]
    (roped, compute dtype); latent [B, T, r + dr], one layer's cache, read
    in place over the first t positions of ``key_bias``'s bias [B, t].
    Scores are fp32 sums of the compute-dtype operands over sqrt(dn +
    dr), an fp32 softmax, p rounded to the compute dtype.  Returns [B, nh
    dv] in the compute dtype."""
    dt = q.dtype
    b = q.shape[0]
    q_lat = bmm(q[..., :s.nope].transpose(0, 1), w["w_uk"], dt)  # nh,B,r
    qc = torch.cat([q_lat.transpose(0, 1), q[..., s.nope:]], dim=-1)
    keys = latent[:, :bias.shape[1]]                            # a view
    scores = bmm(qc, keys.transpose(1, 2)) / math.sqrt(s.qk)    # B,nh,t
    scores = scores + bias[:, None]
    p = torch.softmax(scores, dim=-1).to(dt)
    o_lat = bmm(p, keys[..., :s.kv_rank], dt)                   # B,nh,r
    o = bmm(o_lat.transpose(0, 1), w["w_uv"], dt)               # nh,B,dv
    return o.transpose(0, 1).reshape(b, s.heads * s.v)


# ---------------------------------------------------------------------------
# expert layer
# ---------------------------------------------------------------------------

def grouped_mm_plain(x: torch.Tensor, w: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """The twin of the grouped GEMM: rows ends[g-1]:ends[g] of x [P, K]
    times w[g] [K, N], a group at a time, fp32 sums, in x's dtype."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        out[lo:hi] = (x[lo:hi].float() @ w[g].float()).to(x.dtype)
        lo = hi
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """One grouped GEMM over all groups on CUDA tensors (bf16, fp32
    accumulation; ends int32 on the device), the plain twin on CPU
    tensors."""
    if x.device.type == "cpu":
        return grouped_mm_plain(x, w, ends)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"no grouped expert GEMM for {x.dtype} on "
                         f"{x.device}: the card's takes bf16")
    return torch._grouped_mm(x, w, offs=ends)


def route(w: dict, x: torch.Tensor, s: Sizes):
    """x [N, E] fp32 -> (weights [N, k] fp32, the pairs' order by expert
    [N k], each group's end in that order [X] int32): sigmoid scores in
    fp32, the top k of scores + selection bias, weights scaling g / sum
    g."""
    g = torch.sigmoid(x.float() @ w["router"])
    top = torch.topk(g + w["router_bias"], s.top_k, dim=-1).indices
    picked = g.gather(1, top)
    weights = s.scaling * picked / picked.sum(-1, keepdim=True)
    flat = top.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.searchsorted(
        flat[order], torch.arange(s.experts, device=x.device),
        right=True).to(torch.int32)
    return weights, order, ends


def experts(w: dict, x: torch.Tensor, weights, order, ends,
            s: Sizes) -> torch.Tensor:
    """sum_k w_k E_k(x) + S(x) [N, E] fp32 for the routed pairs."""
    n, e = x.shape
    dt = x.dtype
    xs = x[order // s.top_k]                             # pairs by expert
    ys = grouped_mm(_swiglu(grouped_mm(xs, w["e_gu"], ends), dt),
                    w["e_down"], ends)
    back = torch.empty_like(ys)
    back[order] = ys                                     # token order
    y = (back.view(n, s.top_k, e).float() * weights[..., None]).sum(1)
    return y + mm(_swiglu(mm(x, w["s_gu"]), dt), w["s_down"])


def expert_layer(w: dict, x: torch.Tensor, s: Sizes,
                 dt: torch.dtype) -> torch.Tensor:
    """The expert layer of x [N, E] (normed, fp32: the router reads it
    unrounded, the experts at dt)."""
    with span("moe.route"):
        routed = route(w, x, s)
    with span("moe.experts"):
        return experts(w, x.to(dt), *routed, s)


def ffn(w: dict, h: torch.Tensor, s: Sizes) -> torch.Tensor:
    """The layer's FFN of norm(h) for the residual stream h [..., E], in
    h's dtype, in chunks of at most CHUNK rows."""
    flat = h.reshape(-1, h.shape[-1])
    out = torch.empty_like(flat)
    for lo in range(0, flat.shape[0], CHUNK):
        x = rmsnorm(flat[lo:lo + CHUNK], w["ln2"], s.eps, torch.float32)
        if "router" in w:
            y = expert_layer(w, x, s, h.dtype)
        else:
            y = mm(_swiglu(mm(x.to(h.dtype), w["w_gu"]), h.dtype),
                   w["w_down"])
        out[lo:lo + CHUNK] = y
    return out.reshape(h.shape)


def _residual(w: dict, h: torch.Tensor, attn: torch.Tensor,
              s: Sizes) -> torch.Tensor:
    """h + attn W_o, then + FFN: the block's tail, in h's dtype."""
    h = h + mm(attn.to(h.dtype), w["wo"], h.dtype)
    return h + ffn(w, h, s)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _stack(m: Moonlight, ws: list, x: torch.Tensor, mask, cfg,
           cache: dict | None = None):
    """The causal stack over x [B, T, E] at positions 0..T-1 (keys where
    mask [B, T] is True, or all).  With a cache, writes each layer's
    latent into its first T positions and stops after the last layer's
    latent (its attention and FFN feed nothing), returning None; else
    returns the hidden states [B, T, E] before the final norm."""
    s = m.sizes
    dt = ws[0]["wq"].dtype
    cos, sin = rope_table(s, x.shape[1], x.device)
    h = x.to(dt)
    for li, w in enumerate(ws):
        xn = rmsnorm(h, w["ln1"], s.eps, dt)
        lat = latent(w, xn, cos, sin, s)
        if cache is not None:
            cache["latent"][li, :, :x.shape[1]] = lat
            if li == len(ws) - 1:
                return None
        k, v = keys_values(w, lat, s)
        h = _residual(w, h, _self_attention(queries(w, xn, cos, sin, s), k,
                                            v, mask, cfg, s), s)
    return h


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def forward(m: Moonlight, x: torch.Tensor, mask: torch.Tensor | None,
            cfg) -> torch.Tensor:
    """x [B, T, E] embeddings -> hidden [B, T, E] (pre-head), causal."""
    dt = compute_dtype(cfg)
    return rmsnorm(_stack(m, compute_weights(m, dt), x, mask, cfg), m.ln_f,
                   m.sizes.eps, dt)


def prefix_forward(m: Moonlight, prefix_x: torch.Tensor,
                   prefix_mask: torch.Tensor, query_x: torch.Tensor,
                   query_mask: torch.Tensor, cfg) -> torch.Tensor:
    """The episodic forward, as ``transformer_prefix_forward``: the prefix
    [B, P, E] (mask [B, P]) is computed once and each of the Q query songs
    [B, Q, Lq, E] (key mask [B, Q, Lq]) attends to it and to itself, at
    positions P.. after it, through the prefix-attention kernels.
    Returns hidden [B, Q, Lq, E]."""
    s = m.sizes
    dt = compute_dtype(cfg)
    ws = compute_weights(m, dt)
    b, p, e = prefix_x.shape
    _, q_, lq, _ = query_x.shape
    cos, sin = rope_table(s, p + lq, prefix_x.device)
    hp = prefix_x.to(dt)
    hq = query_x.to(dt).reshape(b * q_, lq, e)
    for li, w in enumerate(ws):
        xp = rmsnorm(hp, w["ln1"], s.eps, dt)
        pk, pv = keys_values(w, latent(w, xp, cos[:p], sin[:p], s), s)
        if li < len(ws) - 1:        # the last prefix stream feeds nothing
            pq = queries(w, xp, cos[:p], sin[:p], s)
            hp = _residual(w, hp, _self_attention(pq, pk, pv, prefix_mask,
                                                  cfg, s), s)
        xq = rmsnorm(hq, w["ln1"], s.eps, dt)
        qq = queries(w, xq, cos[p:], sin[p:], s)
        qk, qv = keys_values(w, latent(w, xq, cos[p:], sin[p:], s), s)

        def songs(t):
            return t.reshape(b, q_, lq, s.heads, s.qk)
        attn = episodic_attention(songs(qq), songs(qk), songs(qv), pk, pv,
                                  query_mask, prefix_mask, cfg.prefix_flash)
        hq = _residual(w, hq, _heads_out(attn.float(), s).reshape(
            b * q_, lq, -1), s)
    return rmsnorm(hq, m.ln_f, s.eps, dt).reshape(b, q_, lq, e)


# ---------------------------------------------------------------------------
# latent cache (sampling path)
# ---------------------------------------------------------------------------

def init_cache(m: Moonlight, batch: int, max_len: int, dt: torch.dtype,
               device) -> dict:
    """The latent cache [layers, B, T, r + dr] and its ``valid`` [B, T],
    T = max_len rounded up to a multiple of ALIGN."""
    s = m.sizes
    max_len = -(-max_len // ALIGN) * ALIGN
    return {"latent": torch.zeros((len(m.layers), batch, max_len,
                                   s.kv_rank + s.rope), dtype=dt,
                                  device=device),
            "valid": torch.zeros((batch, max_len), dtype=torch.bool,
                                 device=device),
            "rope": rope_table(s, max_len, device)}


def prefill(m: Moonlight, ws: list, x: torch.Tensor,
            mask: torch.Tensor | None, cache: dict, cfg) -> dict:
    """Write the latents of a prefix x [B, P, E] (mask [B, P]) into the
    cache's first P positions and mark them valid; decode goes on at
    idx = P."""
    _stack(m, ws, x, mask, cfg, cache)
    cache["valid"][:, :x.shape[1]] = True if mask is None else mask
    return cache


def decode_step(m: Moonlight, ws: list, x_t: torch.Tensor, cache: dict,
                idx: int, cfg) -> torch.Tensor:
    """One decode step: x_t [B, E] at position idx -> hidden [B, E] (final
    norm, compute dtype); the cache is updated in place.  Each layer's
    attention is ``latent_attention`` over the cache, in a
    ``sample.attend`` span."""
    s = m.sizes
    dt = ws[0]["wq"].dtype
    cos, sin = (t[idx] for t in cache["rope"])
    cache["valid"][:, idx] = True
    bias = key_bias(cache["valid"], idx)
    h = x_t.to(dt)
    for li, w in enumerate(ws):
        xn = rmsnorm(h, w["ln1"], s.eps, dt)
        q = queries(w, xn, cos, sin, s)
        cache["latent"][li, :, idx] = latent(w, xn, cos, sin, s)
        with span("sample.attend"):
            attn = latent_attention(q, w, cache["latent"][li], bias, s)
        h = _residual(w, h, attn, s)
    return rmsnorm(h, m.ln_f, s.eps, dt)
