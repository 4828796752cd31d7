"""Language-model head, losses and LSTM episodic conditioning.

Port of the LSTM, no-cache part of ``fewshot/models/lm.py``: ``init_lm``
with the same parameter tree, ``embed``, the embedding fold
``_lstm_embed``, ``head_logits`` with its [H, V] pre-contract gate,
``lm_logits``, ``token_nll`` (both branches), ``sequence_nll``,
``shift_targets``, ``lm_nll_stats``, ``support_state`` and
``episodic_nll_stats`` for ``state`` and ``mean_state``.  Every matmul that
the JAX code runs at the compute dtype with fp32 accumulation goes through
``models.lstm.matmul_f32``, which reproduces it, gradients included (the
grad of a rounded operand is rounded to the compute dtype, as JAX's dot
transpose does).  The transformer, the neural-cache head, the fused
head+CE kernels, the finetune variant and dropout in training are later
slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fewshot_torch.device import resolve_device
from fewshot_torch.models import lstm as lstm_mod
from fewshot_torch.models.lstm import matmul_f32

# Vocab size up to which the JAX package embeds by one-hot matmul; the
# embedding fold is eligible only below it.
ONEHOT_VOCAB_MAX = 1024


class LSTMLM(nn.Module):
    """The JAX parameter tree of an LSTM LM as a module.

    embed [V, E]; lstm[l].{wx [in, 4H], wh [H, 4H], b [4H]}; out_proj
    [H, E] (tied head with H != E) or out_w [H, V] (untied head); out_b
    [V].  Absent entries are None."""

    def __init__(self, embed: torch.Tensor, lstm: nn.ModuleList,
                 out_b: torch.Tensor, out_proj: torch.Tensor | None = None,
                 out_w: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.lstm = lstm
        self.out_b = nn.Parameter(out_b)
        for name, value in (("out_proj", out_proj), ("out_w", out_w)):
            self.register_parameter(
                name, None if value is None else nn.Parameter(value))


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg) -> None:
    """Raise for the configurations that later slices of the port add."""
    if cfg.model != "lstm":
        raise NotImplementedError(
            "model='transformer' is not ported yet (a later slice)")
    if cfg.support_cache:
        raise NotImplementedError(
            "support_cache=True (the neural-cache head) is not ported yet "
            "(a later slice)")
    if cfg.support_mode == "finetune":
        raise NotImplementedError(
            "support_mode='finetune' is not ported yet (a later slice)")


def check_fused_head(params: LSTMLM, cfg) -> None:
    """Raise where the JAX package scores with the fused head+CE kernels
    (V > 1024 under cell='pallas', a lane-aligned head width): they are a
    later slice (the cache-head slice)."""
    d = params.embed.shape[1] if cfg.tie_embeddings else params.out_w.shape[0]
    if (cfg.cell == "pallas" and _vocab(params, cfg) > ONEHOT_VOCAB_MAX
            and d % 128 == 0):
        raise NotImplementedError(
            "the fused head+CE kernels (V > 1024 with cell='pallas') are not "
            "ported yet (the cache-head slice)")


def _vocab(params: LSTMLM, cfg) -> int:
    return (params.embed.shape[0] if cfg.tie_embeddings
            else params.out_w.shape[1])


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


def init_lm(cfg, vocab_size: int, generator: torch.Generator,
            device: torch.device | str | None = None) -> LSTMLM:
    """Random parameters with the JAX package's distributions and tree.

    generator: a CPU generator, so a seed gives the same weights on any
    device.  The numbers differ from JAX's init for the same seed."""
    check_supported(cfg)
    dev = resolve_device(device)
    e, h = cfg.embed_dim, cfg.hidden_dim
    emb = torch.randn((vocab_size, e), generator=generator) * 0.02
    lstm = lstm_mod.init_lstm_params(e, h, cfg.num_layers, generator)
    out_proj = out_w = None
    if cfg.tie_embeddings:
        if h != e:
            out_proj = _glorot((h, e), generator)
    else:
        out_w = _glorot((h, vocab_size), generator)
    return LSTMLM(emb, lstm, torch.zeros(vocab_size), out_proj,
                  out_w).to(dev)


def head_logits(params: LSTMLM, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """hidden [..., H] -> logits [..., V] in fp32."""
    dt = compute_dtype(cfg)
    if cfg.tie_embeddings:
        if params.out_proj is not None:
            h, e = params.out_proj.shape
            v = params.embed.shape[0]
            rows = math.prod(hidden.shape[:-1])
            # Small vocabs: pre-contract the tied head to [H, V] once per
            # call when that costs fewer FLOPs over the rows (the JAX
            # package's gate, verbatim).
            if h > e and v < (h * e) // (h - e) and rows * (h - e) > h * e:
                w = matmul_f32(params.out_proj, params.embed.T, dt)
                return matmul_f32(hidden, w, dt) + params.out_b
            hidden = matmul_f32(hidden, params.out_proj, dt)
        logits = matmul_f32(hidden, params.embed.T, dt)
    else:
        logits = matmul_f32(hidden, params.out_w, dt)
    return logits + params.out_b


def embed(params: LSTMLM, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows [.., E] (the JAX one-hot matmul gives the same rows)."""
    return params.embed[tokens]


def _lstm_embed(params: LSTMLM, tokens: torch.Tensor, cfg):
    """(x, zx0) for the LSTM backbone, folding the embedding into the
    layer-0 input projection when eligible (evaluation: no dropout).

    zx0 = onehot @ (embed @ Wx_0) never materializes the [rows, E]
    activations.  Eligible when V is small (below the one-hot threshold
    and the FLOP crossover E*4H/(4H-E)) and rows >= 512.  The one-hot
    product picks rows of the [V, 4H] table exactly, so it is a gather."""
    table = params.embed
    v = table.shape[0]
    wx0 = params.lstm[0].wx
    e, four_h = wx0.shape
    rows = math.prod(tokens.shape)
    dt = compute_dtype(cfg)
    if (v <= ONEHOT_VOCAB_MAX and four_h > e
            and v < (e * four_h) // (four_h - e) and rows >= 512):
        w = matmul_f32(table, wx0, dt)                        # [V, 4H]
        return None, w.to(dt).float()[tokens]                 # [.., 4H]
    return embed(params, tokens), None


def shift_targets(tokens: torch.Tensor, lengths: torch.Tensor):
    """(inputs [.., T-1], targets [.., T-1], mask [.., T-1]).

    Position t is real iff t < len-1 (predicting tokens 1..len-1)."""
    t = tokens.shape[-1] - 1
    mask = torch.arange(t, device=tokens.device) < (lengths[..., None] - 1)
    return tokens[..., :-1], tokens[..., 1:], mask


def lm_logits(params: LSTMLM, tokens: torch.Tensor, cfg,
              mask: torch.Tensor | None = None, state=None,
              eval_mode: bool = False):
    """tokens [B, T] -> (logits [B, T, V] fp32, final per-layer state).

    eval_mode: the caller will not differentiate (admits the forward-only
    fused stack, as in the JAX package).  No dropout: train mode with
    cfg.dropout > 0 raises."""
    check_supported(cfg)
    if not eval_mode and cfg.dropout > 0:
        raise NotImplementedError(
            "dropout > 0 in training is not ported yet (a later slice)")
    x, zx0 = _lstm_embed(params, tokens, cfg)
    hidden, state = lstm_mod.lstm_forward(
        params.lstm, x, mask=mask, state=state,
        compute_dtype=compute_dtype(cfg), cell=cfg.cell, eval_mode=eval_mode,
        zx0=zx0)
    return head_logits(params, hidden, cfg), state


def token_nll(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum CE over masked positions, count), fp32 log-softmax.

    Up to ONEHOT_VOCAB_MAX the JAX package takes log_softmax and the target
    entry; above it the lse form lse - logit[target]; both are kept."""
    logits = logits.float()
    idx = targets[..., None]
    if logits.shape[-1] <= ONEHOT_VOCAB_MAX:
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, idx)[..., 0]
    else:
        ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, idx)[..., 0]
    m = mask.float()
    return (ce * m).sum(), m.sum()


def sequence_nll(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked mean NLL/token (the headline metric)."""
    total, count = token_nll(logits, targets, mask)
    return total / count.clamp_min(1.0)


def lm_nll_stats(params: LSTMLM, tokens: torch.Tensor, lengths: torch.Tensor,
                 cfg, eval_mode: bool = False):
    """(sum CE, token count) on a [B, T] batch of songs."""
    inputs, targets, mask = shift_targets(tokens, lengths)
    logits, _ = lm_logits(params, inputs, cfg, mask=mask,
                          eval_mode=eval_mode)
    return token_nll(logits, targets, mask)


def support_state(params: LSTMLM, support: torch.Tensor,
                  support_len: torch.Tensor, cfg, eval_mode: bool = False):
    """The priming per-layer (h, c) derived from the support set.

    support_mode="state": the K songs are concatenated along time into a
    [B, K*L] stream (PAD steps hold the state), K*L sequential steps.
    support_mode="mean_state": the K songs run independently as one
    [B*K, L] batch and the K final states are averaged."""
    check_supported(cfg)
    b, k_, l_ = support.shape
    dt = compute_dtype(cfg)
    steps = torch.arange(l_, device=support.device)
    if cfg.support_mode == "mean_state":
        flat = support.reshape(b * k_, l_)
        mask = steps < support_len.reshape(b * k_)[:, None]
        x, zx0 = _lstm_embed(params, flat, cfg)
        _, state = lstm_mod.lstm_forward(params.lstm, x, mask=mask,
                                         compute_dtype=dt, cell=cfg.cell,
                                         eval_mode=eval_mode, zx0=zx0)
        return [(h.reshape(b, k_, -1).mean(dim=1),
                 c.reshape(b, k_, -1).mean(dim=1)) for h, c in state]
    flat = support.reshape(b, k_ * l_)
    mask = (steps < support_len[..., None]).reshape(b, k_ * l_)
    x, zx0 = _lstm_embed(params, flat, cfg)
    _, state = lstm_mod.lstm_forward(params.lstm, x, mask=mask,
                                     compute_dtype=dt, cell=cfg.cell,
                                     eval_mode=eval_mode, zx0=zx0)
    return state


def episodic_nll_stats(params: LSTMLM, ep, cfg, eval_mode: bool = False):
    """(sum CE over query tokens, query token count) for a meta-batch.

    The LSTM branch of the JAX function without cache head or fused head:
    the support state (support_mode state or mean_state) primes each
    episode's Q query songs, which run as one [B*Q, L-1] batch.  In
    mean_state mode the support pass's top-layer outputs are unused, so its
    gradient arrives only through the final state (mean, then repeat)."""
    check_supported(cfg)
    check_fused_head(params, cfg)
    b, q_, l_ = ep.query.shape
    inputs, targets, mask = shift_targets(ep.query, ep.query_len)
    state = None
    if cfg.support_mode in ("state", "mean_state"):
        state = support_state(params, ep.support, ep.support_len, cfg,
                              eval_mode=eval_mode)
        # each episode's state over its Q query songs
        state = [(h.repeat_interleave(q_, dim=0),
                  c.repeat_interleave(q_, dim=0)) for h, c in state]
    logits, _ = lm_logits(params, inputs.reshape(b * q_, l_ - 1), cfg,
                          mask=mask.reshape(b * q_, l_ - 1), state=state,
                          eval_mode=eval_mode)
    return token_nll(logits, targets.reshape(b * q_, l_ - 1),
                     mask.reshape(b * q_, l_ - 1))
