"""The plain reference: the episodic cache LM in float32 PyTorch.

It follows the equations of the recipe the configurations state and
nothing of the program under test: TF gate order (i, j, f, o) with the
+1 forget bias, mean-state support conditioning, pre-norm RMSNorm
transformer blocks with rotate-half RoPE and tanh GELU, the tied head
(through ``out_proj`` where the head's input is wider than the
embedding), and the neural-cache mixture (support-count posterior with
per-count calibration, a learned global backoff, the continuous cache of
the row's own earlier tokens, a hidden-gated mixture, the
responsibility floor in training).  Parameters are a dict of fp32
tensors under the program's parameter names, so the two sides compare
leaf by leaf.  The backbone that a configuration's "model" names gives
the hidden states (reference/backbones/<model>.py, on the parts below);
this module adds the head and the cache.

``rnd`` is applied to every operand of a product that the configuration
runs at its compute dtype: ``exact`` for the reference, ``fp8`` for the
control (the nearest precision below the configuration's bfloat16).
TF32 is switched off by ``strict_fp32``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.cells import backbone

FORGET_BIAS = 1.0
CALIB_MAX = 32
BOS, EOS, PAD = 1, 2, 0


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale per tensor (its largest
    magnitude onto the format's 448), as fp8 products are run; fp32."""
    scale = 448.0 / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8(torch.autograd.Function):
    """An operand rounded to fp8, and its gradient rounded to fp8 too, as
    the configuration's bf16 products round both."""

    @staticmethod
    def forward(ctx, x):
        return _e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return _e4m3(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def mm(a: torch.Tensor, b: torch.Tensor, rnd) -> torch.Tensor:
    return rnd(a.float()) @ rnd(b.float())


# ---------------------------------------------------------------------------
# the backbones' parts (reference/backbones/<model>.py builds on these)
# ---------------------------------------------------------------------------

def lstm_layers(p: dict) -> int:
    return sum(1 for k in p if k.startswith("lstm.") and k.endswith(".wx"))


def lstm_run(p: dict, x: torch.Tensor, mask, state, rnd):
    """x [N, T, E]; mask [N, T] bool or None (a False step holds the
    state); state: per-layer (h, c) or None.  Returns (top outputs [N, T,
    H], final per-layer state)."""
    n, t, _ = x.shape
    out_state = []
    inp = x
    for li in range(lstm_layers(p)):
        wx, wh, b = (p[f"lstm.{li}.{k}"] for k in ("wx", "wh", "b"))
        hdim = wh.shape[0]
        zx = mm(inp.reshape(n * t, -1), wx, rnd).reshape(n, t, 4 * hdim)
        if state is None:
            h = c = x.new_zeros(n, hdim)
        else:
            h, c = state[li]
        ys = []
        for s in range(t):
            z = zx[:, s] + mm(h, wh, rnd) + b
            i, j, f, o = z.chunk(4, dim=-1)
            c_new = torch.sigmoid(f + FORGET_BIAS) * c + \
                torch.sigmoid(i) * torch.tanh(j)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if mask is None:
                h, c = h_new, c_new
            else:
                m = mask[:, s, None]
                h = torch.where(m, h_new, h)
                c = torch.where(m, c_new, c)
            ys.append(h)
        out_state.append((h, c))
        inp = torch.stack(ys, dim=1)
    return inp, out_state


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def rope(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x [N, S, nh, hd], pos [S]: rotate-half, lane i with lane i + hd/2."""
    hd = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos.float()[:, None] * inv                    # [S, hd/2]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def tfm_layers(p: dict) -> int:
    return sum(1 for k in p if k.startswith("transformer.layers.")
               and k.endswith(".wqkv"))


def tfm_run(p: dict, x: torch.Tensor, valid: torch.Tensor, heads: int, rnd):
    """Causal pre-norm decoder over x [N, S, E] at positions 0..S-1; a key
    takes part where valid [N, S] is True.  Returns hidden [N, S, E]."""
    n, s, e = x.shape
    hd = e // heads
    pos = torch.arange(s, device=x.device)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    allowed = causal[None] & valid[:, None, :]               # [N, S, S]
    h = x
    for li in range(tfm_layers(p)):
        w = {k: p[f"transformer.layers.{li}.{k}"]
             for k in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")}
        qkv = mm(rmsnorm(h, w["ln1"]).reshape(n * s, e), w["wqkv"], rnd)
        q, k, v = qkv.reshape(n, s, 3, heads, hd).unbind(2)
        q, k = rope(q, pos), rope(k, pos)
        sc = torch.einsum("nqhd,nkhd->nhqk", rnd(q), rnd(k)) / math.sqrt(hd)
        sc = sc.masked_fill(~allowed[:, None], float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        att = torch.einsum("nhqk,nkhd->nqhd", rnd(pr), rnd(v))
        h = h + mm(att.reshape(n * s, e), w["wo"], rnd).reshape(n, s, e)
        f = mm(rmsnorm(h, w["ln2"]).reshape(n * s, e), w["w1"], rnd)
        h = h + mm(F.gelu(f, approximate="tanh"), w["w2"],
                   rnd).reshape(n, s, e)
    return rmsnorm(h, p["transformer.ln_f"])


# ---------------------------------------------------------------------------
# head and cache
# ---------------------------------------------------------------------------

def head_logits(p: dict, hidden: torch.Tensor, rnd) -> torch.Tensor:
    """hidden [R, D] -> fp32 logits [R, V] of the tied head."""
    h2 = hidden
    if "out_proj" in p:
        h2 = mm(hidden, p["out_proj"], rnd)
    return mm(h2, p["embed"].T, rnd) + p["out_b"]


def gate_logit(p: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ p["cache_gate.w"] + p["cache_gate.b"]


def support_counts(support: torch.Tensor, support_len: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """[B, V] counts of the support songs' target tokens (1..len-1)."""
    b, k, l = support.shape
    real = torch.arange(1, l, device=support.device) < support_len[..., None]
    counts = torch.zeros(b, vocab, device=support.device)
    return counts.scatter_add_(1, support[..., 1:].reshape(b, -1),
                               real.reshape(b, -1).float())


def cache_parts(p: dict, counts: torch.Tensor):
    """(phi [B, V], total [B, 1], s, p_global [V]) of the calibrated
    support posterior (phi + s p_global) / (total + s)."""
    s = torch.exp(p["cache_prior.log_s"])
    p_global = torch.softmax(p["cache_prior.u"], dim=-1)
    idx = (counts.long() - 1).clamp(0, CALIB_MAX - 1)
    t = p["cache_calib.t"][idx]
    phi = torch.where(counts > 0,
                      torch.exp(t) * counts / counts.clamp(1.0, CALIB_MAX),
                      torch.zeros_like(counts))
    return phi, phi.sum(-1, keepdim=True), s, p_global


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def episode_loss(p: dict, spec: dict, ep: dict, rnd=exact, train=True):
    """(sum of the query tokens' mixture NLL, token count) of a batch of
    episodes ep = {support, support_len, query, query_len} (int64)."""
    support, slen = ep["support"], ep["support_len"]
    query, qlen = ep["query"], ep["query_len"]
    b, q_, l = query.shape
    vocab = p["embed"].shape[0]
    inputs, targets = query[..., :-1], query[..., 1:]
    mask = torch.arange(l - 1, device=query.device) < (qlen[..., None] - 1)
    hid = backbone(spec["model"], reference=True).episode_hidden(
        p, spec, support, slen, inputs, mask, rnd)
    rows, t = b * q_, l - 1
    hid = hid.reshape(rows, t, -1)
    tg = targets.reshape(rows, t)
    m = mask.reshape(rows, t).float()
    logits = head_logits(p, hid.reshape(rows * t, -1), rnd)
    lm_t = (logits.gather(1, tg.reshape(-1, 1))[:, 0]
            - torch.logsumexp(logits, dim=-1)).reshape(rows, t)
    phi, total, s, pg = cache_parts(p, support_counts(support, slen, vocab))
    phi = phi.repeat_interleave(q_, 0)
    total = total.repeat_interleave(q_, 0)
    earlier = torch.ones(t, t, dtype=torch.bool, device=tg.device).tril(-1)
    same = (tg[:, :, None] == tg[:, None, :]) & earlier
    c_pre = (same.float() * m[:, None, :]).sum(-1)
    plen = torch.cumsum(m, -1) - m
    cache_t = (torch.log(phi.gather(1, tg) + c_pre + s * pg[tg])
               - torch.log(total + plen + s))
    z = gate_logit(p, hid)
    mixed = torch.logaddexp(F.logsigmoid(-z) + lm_t, F.logsigmoid(z) + cache_t)
    floor = spec.get("cache_resp_floor", 0.0) if train else 0.0
    if floor:
        r_lm = torch.exp(F.logsigmoid(-z) + lm_t - mixed).detach()
        mixed = mixed + torch.relu(floor - r_lm) * (lm_t - lm_t.detach())
    return -(mixed * m).sum(), m.sum()


def adam_steps(p0: dict, spec: dict, episodes, rnd=exact):
    """Train a copy of p0 over the episodes, one Adam step each, as the
    recipe states (gradients of the CE sum over the token count, global
    norm clipped, bias-corrected Adam).  Returns (losses, the first step's
    clipped gradients, the parameters after the last step)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, clip = spec["lr"], spec["grad_clip"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    losses, first = [], None
    for n, ep in enumerate(episodes, 1):
        total, count = episode_loss(p, spec, ep, rnd)
        grads = torch.autograd.grad(total, list(p.values()),
                                    allow_unused=True)
        inv = 1.0 / count.clamp_min(1.0)
        g = {k: (gr if gr is not None else torch.zeros_like(v)) * inv
             for (k, v), gr in zip(p.items(), grads)}
        norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        if norm >= clip:
            g = {k: x / norm * clip for k, x in g.items()}
        if first is None:
            first = {k: x.detach().clone() for k, x in g.items()}
        losses.append(float(total.detach() * inv))
        with torch.no_grad():
            for k, v in p.items():
                mu[k] = (1 - b1) * g[k] + b1 * mu[k]
                nu[k] = (1 - b2) * g[k] * g[k] + b2 * nu[k]
                upd = (mu[k] / (1 - b1 ** n)) / (
                    torch.sqrt(nu[k] / (1 - b2 ** n)) + eps)
                v.sub_(lr * upd)
    return losses, first, {k: v.detach() for k, v in p.items()}


# ---------------------------------------------------------------------------
# served tokens, teacher-forced
# ---------------------------------------------------------------------------

def served_logp(p: dict, spec: dict, support, support_len, tokens,
                rnd=exact, cache: bool = True,
                dynamic: bool = True) -> torch.Tensor:
    """Mixture log-probs [R, n, V] that each decode position i of the
    served rows tokens [R, n] was drawn from: the support [R, K, L]
    conditions the model, BOS and tokens[:, :i] are its inputs, and the
    continuous cache counts tokens[:, :i] that are not PAD.  cache=False
    (the LM branch alone) and dynamic=False (the support's counts alone)
    are faults, for reading what the comparison sees of them."""
    r, n = tokens.shape
    vocab = p["embed"].shape[0]
    dev = tokens.device
    inputs = torch.cat([torch.full((r, 1), BOS, dtype=torch.long,
                                   device=dev), tokens[:, :-1]], dim=1)
    hid = backbone(spec["model"], reference=True).served_hidden(
        p, spec, support, support_len, inputs, rnd)
    logits = head_logits(p, hid.reshape(r * n, -1), rnd).reshape(r, n, vocab)
    logp = torch.log_softmax(logits, dim=-1)
    phi, total, s, pg = cache_parts(p, support_counts(support, support_len,
                                                      vocab))
    if not cache:
        return logp
    live = (tokens != PAD).float() if dynamic else tokens.new_zeros(
        tokens.shape, dtype=torch.float32)
    emitted = torch.zeros(r, n, vocab, device=dev)
    emitted.scatter_(2, tokens[:, :, None], live[:, :, None])
    c_pre = torch.cumsum(emitted, dim=1) - emitted           # before step i
    n_pre = (torch.cumsum(live, dim=1) - live)[..., None]
    log_cache = (torch.log(phi[:, None] + c_pre + s * pg)
                 - torch.log(total[:, None] + n_pre + s))
    z = gate_logit(p, hid)[..., None]
    return torch.logaddexp(logp + F.logsigmoid(-z),
                           log_cache + F.logsigmoid(z))
