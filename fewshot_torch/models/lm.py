"""Language-model head, losses, episodic conditioning (LSTM and
transformer) and the neural-cache head.

Port of ``fewshot/models/lm.py``: ``init_lm`` with
the same parameter tree (cache parameters included), ``embed``, the
embedding fold ``_lstm_embed``, ``head_logits`` with its [H, V] pre-contract
gate, the fused head ``fused_head_eligible`` / ``head_lse_target`` (kernels
5 and 6, ``ops/head_ce.py``), ``lm_logits``, ``token_nll`` (both branches),
``sequence_nll``, ``shift_targets``, ``lm_nll_stats``, ``support_state``,
the cache head (``support_counts``, ``cache_posterior_parts``,
``take_targets``, ``dynamic_cache_target_logp``, ``support_log_cache``,
``cache_token_nll``, ``lm_target_logp``, ``cache_mix_stats``), train-mode
``dropout``, and ``episodic_nll_stats`` for ``state``, ``mean_state``,
``none`` and ``finetune``, with and without the cache and the fused
head, for both backbones (the transformer's support prefix runs through
``models/transformer.py``'s prefix forward).  Every matmul that the
JAX code runs at the compute dtype with fp32 accumulation goes through
``models.lstm.matmul_f32``, which reproduces it, gradients included (the
grad of a rounded operand is rounded to the compute dtype, as JAX's dot
transpose does); ``stop_gradient`` is ``detach``.  ``cache_mixed_logp`` is
the cache head's mixture over the vocabulary, which sampling draws from.

Dropout masks come from a ``torch.Generator`` (the train state's, after the
episode draw) in the JAX call order: the embeddings, then the pre-head
hidden states.  The finetune variant (``finetune_episodic_nll_stats``)
adapts one parameter copy per episode with ``torch.func``: ``vmap`` over
the episodes of ``grad`` of the support loss through ``functional_call``,
so each routing predicate sees one episode's rows, as under JAX's vmap.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, grad, vmap

from fewshot_torch.device import resolve_device
from fewshot_torch.models import lstm as lstm_mod
from fewshot_torch.models import moonlight as moon_mod
from fewshot_torch.models import transformer as tfm_mod
from fewshot_torch.models.lstm import matmul_f32
from fewshot_torch.ops import head_ce

# Vocab size up to which the JAX package embeds by one-hot matmul; the
# embedding fold is eligible only below it.
ONEHOT_VOCAB_MAX = 1024
# The cache posterior's uniform smoothing pseudo-count per token, and the
# size of the count-calibration table (counts past it extend the last slot
# multiplicatively).
CACHE_ALPHA = 0.01
CACHE_CALIB_MAX = 32


class ParamGroup(nn.Module):
    """A named group of parameters, one JAX sub-dict (``cache_gate`` ...)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, value in tensors.items():
            self.register_parameter(name, nn.Parameter(value))


class LM(nn.Module):
    """The JAX parameter tree of an LM as a module.

    embed [V, E]; the backbone: lstm[l].{wx [in, 4H], wh [H, 4H], b [4H]}
    or transformer.{layers[l].{ln1, wqkv, wo, ln2, w1, w2}, ln_f}
    (``models/transformer.py``) or moonlight.{layers[l], ln_f}
    (``models/moonlight.py``); out_proj [D, E] (tied head with D != E) or
    out_w [D, V] (untied head), D = H or E; out_b [V]; with the cache head,
    cache_gate.{w [D], b []}, cache_prior.{u [V], log_s []} (global
    backoff) and cache_calib.{t [32], a [32]} (calib; ``a`` with
    calib_freq).  Absent entries are None."""

    def __init__(self, embed: torch.Tensor, lstm: nn.ModuleList | None,
                 out_b: torch.Tensor, out_proj: torch.Tensor | None = None,
                 out_w: torch.Tensor | None = None,
                 cache_gate: dict | None = None,
                 cache_prior: dict | None = None,
                 cache_calib: dict | None = None,
                 transformer: tfm_mod.Transformer | None = None,
                 moonlight: moon_mod.Moonlight | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.lstm = lstm
        self.transformer = transformer
        self.moonlight = moonlight
        self.out_b = nn.Parameter(out_b)
        for name, value in (("out_proj", out_proj), ("out_w", out_w)):
            self.register_parameter(
                name, None if value is None else nn.Parameter(value))
        for name, group in (("cache_gate", cache_gate),
                            ("cache_prior", cache_prior),
                            ("cache_calib", cache_calib)):
            setattr(self, name, None if group is None else ParamGroup(**group))

    def forward(self, fn, *args, **kwargs):
        """fn(self, *args, **kwargs): lets ``torch.func.functional_call``
        run any function of this module under substituted tensors."""
        return fn(self, *args, **kwargs)


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def check_supported(cfg) -> None:
    """Raise for finetune over a backbone that launches kernels: the outer
    gradient differentiates the inner one, and the kernels' backward has
    no derivative (the JAX package's outer grad fails there as well, in
    the Pallas call's JVP).  Use cell='scan' (flash=False).  Moonlight's
    block samples and evaluates only: no finetune."""
    if cfg.support_mode == "finetune" and cfg.model == "moonlight":
        raise ValueError("support_mode='finetune' is not available for "
                         "model='moonlight'")
    if cfg.support_mode == "finetune" and (
            (cfg.model == "lstm" and cfg.cell == "pallas")
            or (cfg.model == "transformer" and cfg.flash)):
        raise ValueError(
            "support_mode='finetune' needs the plain backbone (cell='scan', "
            "flash=False): the kernels' backward has no derivative")


def _vocab(params: LM, cfg) -> int:
    return (params.embed.shape[0] if cfg.tie_embeddings
            else params.out_w.shape[1])


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=generator) * 2 - 1) * limit


def init_lm(cfg, vocab_size: int, generator: torch.Generator,
            device: torch.device | str | None = None) -> LM:
    """Random parameters with the JAX package's distributions and tree.

    generator: a CPU generator, so a seed gives the same weights on any
    device.  The numbers differ from JAX's init for the same seed; the
    cache parameters are deterministic (the JAX package's init values)."""
    check_supported(cfg)
    dev = resolve_device(device)
    e = cfg.embed_dim
    emb = torch.randn((vocab_size, e), generator=generator) * 0.02
    lstm = tfm = None
    moon = None
    if cfg.model == "lstm":
        h = cfg.hidden_dim
        lstm = lstm_mod.init_lstm_params(e, h, cfg.num_layers, generator)
    elif cfg.model == "moonlight":
        h = e
        moon = moon_mod.init_moonlight(cfg, generator)
    else:
        h = e               # the head's input width
        tfm = tfm_mod.init_transformer_params(cfg, generator)
    out_proj = out_w = None
    if cfg.tie_embeddings:
        if h != e:
            out_proj = _glorot((h, e), generator)
    else:
        out_w = _glorot((h, vocab_size), generator)
    cache = {}
    if cfg.support_cache:
        # b = -1 starts the cache weight low (~0.27); the global backoff
        # starts as the uniform one (u = 0, s = CACHE_ALPHA V) and the
        # calibration as the identity (t[c] = log c, a = 0)
        cache["cache_gate"] = {"w": torch.zeros(h),
                               "b": torch.tensor(-1.0)}
        if cfg.cache_backoff == "global":
            cache["cache_prior"] = {
                "u": torch.zeros(vocab_size),
                "log_s": torch.log(torch.tensor(CACHE_ALPHA * vocab_size))}
        if cfg.cache_calib:
            cache["cache_calib"] = {"t": torch.log(torch.arange(
                1, CACHE_CALIB_MAX + 1, dtype=torch.float32))}
            if cfg.cache_calib_freq:
                cache["cache_calib"]["a"] = torch.zeros(CACHE_CALIB_MAX)
    return LM(emb, lstm, torch.zeros(vocab_size), out_proj, out_w,
              **cache, transformer=tfm, moonlight=moon).to(dev)


def head_logits(params: LM, hidden: torch.Tensor, cfg) -> torch.Tensor:
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


def fused_head_eligible(params: LM, cfg, vocab_size: int) -> bool:
    """Score through the fused head+CE kernels (``ops/head_ce.py``)?  As in
    the JAX package: cell='pallas', V above the one-hot threshold, and the
    kernels' plan holding for the head's inner dimension."""
    if cfg.cell != "pallas" or vocab_size <= ONEHOT_VOCAB_MAX:
        return False
    d = params.embed.shape[1] if cfg.tie_embeddings else params.out_w.shape[0]
    return head_ce.fused_head_nll_supported(d, vocab_size,
                                            compute_dtype(cfg))


def head_lse_target(params: LM, hidden: torch.Tensor,
                    targets: torch.Tensor, cfg):
    """Fused per-position (logsumexp, target logit) of the head logits,
    without the [.., V] logits: hidden [.., H], targets [..] -> two [..]
    fp32 tensors.  h2 is the out_proj product (tied head) rounded to the
    compute dtype; w = embed^T or out_w."""
    dt = compute_dtype(cfg)
    h2 = hidden
    if cfg.tie_embeddings:
        if params.out_proj is not None:
            h2 = matmul_f32(hidden, params.out_proj, dt)
        w = params.embed.T
    else:
        w = params.out_w
    lse, tl = head_ce.head_lse_tgt(h2.to(dt).reshape(-1, w.shape[0]), w,
                                   params.out_b, targets.reshape(-1))
    return lse.reshape(targets.shape), tl.reshape(targets.shape)


def embed(params: LM, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows [.., E] (the JAX one-hot matmul gives the same rows)."""
    return params.embed[tokens]


def dropout(x: torch.Tensor, rate: float, src) -> torch.Tensor:
    """Inverted dropout; the identity when rate <= 0 or src is None (eval).

    src: a generator to draw the keep mask from (u < 1 - rate, as
    jax.random.bernoulli), or the bool keep mask itself."""
    if src is None or rate <= 0.0:
        return x
    keep = (src if isinstance(src, torch.Tensor) else
            torch.rand(x.shape, generator=src, device=x.device) < 1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def _drop_sources(drop):
    """(embedding side, hidden side) of a forward's dropout source: one
    generator draws both masks in turn; finetune passes a pair of masks."""
    return drop if isinstance(drop, tuple) else (drop, drop)


def _lstm_embed(params: LM, tokens: torch.Tensor, cfg, drop_in=None):
    """(x, zx0) for the LSTM backbone, folding the embedding into the
    layer-0 input projection when eligible.

    zx0 = onehot @ (embed @ Wx_0) never materializes the [rows, E]
    activations.  Eligible when V is small (below the one-hot threshold
    and the FLOP crossover E*4H/(4H-E)), rows >= 512 and the embedding
    dropout is inactive.  The one-hot product picks rows of the [V, 4H]
    table exactly, so it is a gather."""
    table = params.embed
    v = table.shape[0]
    wx0 = params.lstm[0].wx
    e, four_h = wx0.shape
    rows = math.prod(tokens.shape)
    dt = compute_dtype(cfg)
    drop_active = drop_in is not None and cfg.dropout > 0
    if (not drop_active and v <= ONEHOT_VOCAB_MAX and four_h > e
            and v < (e * four_h) // (four_h - e) and rows >= 512):
        w = matmul_f32(table, wx0, dt)                        # [V, 4H]
        return None, w.to(dt).float()[tokens]                 # [.., 4H]
    return dropout(embed(params, tokens), cfg.dropout, drop_in), None


def shift_targets(tokens: torch.Tensor, lengths: torch.Tensor):
    """(inputs [.., T-1], targets [.., T-1], mask [.., T-1]).

    Position t is real iff t < len-1 (predicting tokens 1..len-1)."""
    t = tokens.shape[-1] - 1
    mask = torch.arange(t, device=tokens.device) < (lengths[..., None] - 1)
    return tokens[..., :-1], tokens[..., 1:], mask


def lm_logits(params: LM, tokens: torch.Tensor, cfg,
              mask: torch.Tensor | None = None, state=None,
              eval_mode: bool = False, with_hidden: bool = False,
              no_head: bool = False, drop=None):
    """tokens [B, T] -> (logits [B, T, V] fp32, final per-layer state; None
    for the transformer, which decodes with its KV cache).

    with_hidden=True also returns the (post-dropout) pre-head hidden
    states (the cache gate's input); no_head=True skips the head and
    returns (None, state, hidden), for the fused head+CE path.  eval_mode:
    the caller will not differentiate (admits the forward-only fused
    stack, as in the JAX package).  drop: None (no dropout), or the source
    of the train-mode dropout on the embeddings and the hidden states
    (``dropout``, ``_drop_sources``), active when cfg.dropout > 0."""
    check_supported(cfg)
    drop_in, drop_out = _drop_sources(drop)
    if cfg.model == "lstm":
        x, zx0 = _lstm_embed(params, tokens, cfg, drop_in)
        hidden, state = lstm_mod.lstm_forward(
            params.lstm, x, mask=mask, state=state,
            compute_dtype=compute_dtype(cfg), cell=cfg.cell,
            eval_mode=eval_mode, zx0=zx0)
    elif cfg.model == "moonlight":
        x = dropout(embed(params, tokens), cfg.dropout, drop_in)
        hidden = moon_mod.forward(params.moonlight, x, mask, cfg)
        state = None
    else:
        x = dropout(embed(params, tokens), cfg.dropout, drop_in)
        hidden = tfm_mod.transformer_forward(params.transformer, x, mask,
                                             cfg)
        state = None
    hidden = dropout(hidden, cfg.dropout, drop_out)
    if no_head:
        return None, state, hidden
    if with_hidden:
        return head_logits(params, hidden, cfg), state, hidden
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


# ---------------------------------------------------------------------------
# neural-cache head (cfg.support_cache)
# ---------------------------------------------------------------------------

def support_counts(support: torch.Tensor, support_len: torch.Tensor,
                   vocab_size: int) -> torch.Tensor:
    """[B, V] fp32 token counts over the support set's target positions
    (targets 1..len-1, PAD masked).  A scatter-add: the JAX package's
    one-hot sum would be [B, K, L-1, V]; both give the same integers."""
    _, targets, mask = shift_targets(support, support_len)    # [B, K, L-1]
    b = targets.shape[0]
    counts = torch.zeros((b, vocab_size), device=targets.device)
    return counts.scatter_add_(1, targets.reshape(b, -1),
                               mask.reshape(b, -1).float())


def cache_posterior_parts(params: LM, support: torch.Tensor,
                          support_len: torch.Tensor, vocab_size: int):
    """(phi [B, V], total [B, 1], s [], p_global [V]); the cache posterior
    is (phi + s p_global) / (total + s).

    phi: the raw support counts, or with cache_calib the learned
    calibration phi(c) = exp(t[c] (+ a[c] x(w))) c / min(c, 32), x the
    word's centred log global frequency (no gradient into u through it).
    (s, p_global): CACHE_ALPHA V pseudo-counts of the uniform, or the
    learned backoff exp(log_s), softmax(u).  The calibration tables are
    read by one-hot products, as in the JAX package: PyTorch's index
    backward serialises on a 32-row table under B V indices."""
    counts = support_counts(support, support_len, vocab_size)
    prior = params.cache_prior
    dev = counts.device
    if prior is None:
        s = torch.tensor(CACHE_ALPHA * vocab_size, device=dev)
        p_global = torch.full((vocab_size,), 1.0 / vocab_size, device=dev)
        log_pg = torch.full((vocab_size,), -math.log(vocab_size), device=dev)
    else:
        s = torch.exp(prior.log_s.float())
        log_pg = torch.log_softmax(prior.u.float(), dim=-1)
        p_global = torch.exp(log_pg)
    calib = params.cache_calib
    if calib is None:
        phi = counts
    else:
        idx = (counts.long() - 1).clamp(0, CACHE_CALIB_MAX - 1)
        c_cap = counts.clamp(1.0, float(CACHE_CALIB_MAX))
        hot = torch.nn.functional.one_hot(idx, CACHE_CALIB_MAX).float()
        t = calib.t.float()
        a = getattr(calib, "a", None)
        if a is not None:
            x = (math.log(vocab_size) + log_pg).detach()          # [V]
            ta = hot @ torch.stack([t, a.float()], dim=-1)         # [B,V,2]
            log_phi = ta[..., 0] + ta[..., 1] * x
        else:
            log_phi = hot @ t
        phi = torch.where(counts > 0, torch.exp(log_phi) * (counts / c_cap),
                          torch.zeros_like(counts))
    total = phi.sum(dim=-1, keepdim=True)
    return phi, total, s, p_global


def take_targets(x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """x.gather(-1, targets) for x [rows, V] and targets [rows, T], with a
    backward that gives the same bits on every run.

    A gather's backward adds into x's gradient with atomics on the card,
    so a token repeated in a row sums its gradients in a varying order.
    Here only each token's first place in its row reads x, the other
    places copy that value through a [rows, T, T] equality product, and
    the gradient of a repeated token is summed over its places by a
    reduction; the atomics then add exact zeros beside one sum.  x must be
    finite (the products multiply it by zero)."""
    eq = targets[:, :, None] == targets[:, None, :]            # [rows, T, T]
    first = ~torch.tril(eq, -1).any(dim=-1)                     # [rows, T]
    own = x.gather(-1, targets) * first
    return ((eq & first[:, None, :]).to(x.dtype) * own[:, None, :]).sum(-1)


def dynamic_cache_target_logp(phi, total, s, p_global, targets, mask):
    """[rows, T] cache-branch log-prob at each target with the query's own
    raw prefix counts added (cache_dynamic):
    log(phi(w_t) + c_prefix(t, w_t) + s p(w_t)) - log(total + len_prefix(t)
    + s), over the same masked positions NLL scores."""
    t_ = targets.shape[-1]
    eq = targets[:, :, None] == targets[:, None, :]           # [rows, T, T]
    tri = torch.ones((t_, t_), dtype=torch.bool,
                     device=targets.device).tril(-1)
    m = mask.float()
    c_pre = ((eq & tri).float() * m[:, None, :]).sum(dim=-1)   # [rows, T]
    plen = torch.cumsum(m, dim=-1) - m                         # exclusive
    phi_t = take_targets(phi, targets)
    return (torch.log(phi_t + c_pre + s * p_global[targets])
            - torch.log(total + plen + s))


def support_log_cache(params: LM, support: torch.Tensor,
                      support_len: torch.Tensor,
                      vocab_size: int) -> torch.Tensor:
    """[B, V] log-probs of the support-count posterior (the cache)."""
    phi, total, s, p_global = cache_posterior_parts(
        params, support, support_len, vocab_size)
    return torch.log(phi + s * p_global[None]) - torch.log(total + s)


def lm_target_logp(logits: torch.Tensor, targets: torch.Tensor
                   ) -> torch.Tensor:
    """[.., T] log-softmax of the logits at the targets (log_softmax form
    up to ONEHOT_VOCAB_MAX, lse form above, as in the JAX package)."""
    logits = logits.float()
    idx = targets[..., None]
    if logits.shape[-1] <= ONEHOT_VOCAB_MAX:
        return torch.log_softmax(logits, dim=-1).gather(-1, idx)[..., 0]
    return (logits.gather(-1, idx)[..., 0]
            - torch.logsumexp(logits, dim=-1))


def cache_mixed_logp(params: LM, logits: torch.Tensor, hidden: torch.Tensor,
                     log_cache: torch.Tensor) -> torch.Tensor:
    """Mixture log-probs [.., V]: (1-g) p_lm + g p_cache with the
    per-position gate g = sigmoid(hidden . w + b).  A normalized
    log-distribution: sampling's temperature and top-k act on it as on
    logits (``fewshot/models/lm.py`` cache_mixed_logp)."""
    gate = params.cache_gate
    z = hidden.float() @ gate.w + gate.b
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.logaddexp(logp + F.logsigmoid(-z)[..., None],
                           log_cache + F.logsigmoid(z)[..., None])


def cache_token_nll(params: LM, logits, hidden, log_cache, targets, mask,
                    lm_aux: float = 0.0, resp_floor: float = 0.0):
    """(sum CE, count) under the cache mixture from the target entries of
    both branches, without the [.., V] mixture.  logits/hidden [rows, T, *];
    log_cache [rows, V]; targets/mask [rows, T].  The cache entry is a
    one-hot product up to ONEHOT_VOCAB_MAX and a gather above, as in the
    JAX package."""
    v = logits.shape[-1]
    lm_t = lm_target_logp(logits, targets)
    if v <= ONEHOT_VOCAB_MAX:
        hot = torch.nn.functional.one_hot(targets, v).float()
        cache_t = torch.einsum("rtv,rv->rt", hot, log_cache)
    else:
        cache_t = take_targets(log_cache, targets)
    return cache_mix_stats(params, hidden, lm_t, cache_t, mask, lm_aux,
                           resp_floor)


def cache_mix_stats(params: LM, hidden, lm_t, cache_t, mask,
                    lm_aux: float = 0.0, resp_floor: float = 0.0):
    """(sum CE, count) of the gated mixture (1-g) p_lm + g p_cache, g =
    sigmoid(hidden . w + b), from the two branches' target log-probs.

    lm_aux > 0 (train only) adds lm_aux x the LM branch's log-prob;
    resp_floor > 0 (train only) adds the zero-valued term relu(floor -
    sg(r_lm)) (lm_t - sg(lm_t)), which lifts the LM branch's gradient
    multiplier r_lm = (1-g) p_lm / p_mix to at least the floor."""
    gate = params.cache_gate
    z = hidden.float() @ gate.w + gate.b
    mixed_t = torch.logaddexp(F.logsigmoid(-z) + lm_t,
                              F.logsigmoid(z) + cache_t)
    if resp_floor:
        r_lm = torch.exp(F.logsigmoid(-z) + lm_t - mixed_t).detach()
        coef = torch.relu(resp_floor - r_lm)
        mixed_t = mixed_t + coef * (lm_t - lm_t.detach())
    if lm_aux:
        mixed_t = mixed_t + lm_aux * lm_t
    m = mask.float()
    return -(mixed_t * m).sum(), m.sum()


def sequence_nll(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked mean NLL/token (the headline metric)."""
    total, count = token_nll(logits, targets, mask)
    return total / count.clamp_min(1.0)


def lm_nll_stats(params: LM, tokens: torch.Tensor, lengths: torch.Tensor,
                 cfg, eval_mode: bool = False, drop=None):
    """(sum CE, token count) on a [B, T] batch of songs."""
    inputs, targets, mask = shift_targets(tokens, lengths)
    logits, _ = lm_logits(params, inputs, cfg, mask=mask,
                          eval_mode=eval_mode, drop=drop)
    return token_nll(logits, targets, mask)


def lm_nll(params: LM, tokens: torch.Tensor, lengths: torch.Tensor,
           cfg) -> torch.Tensor:
    """Plain LM loss (NLL/token) on a [B, T] batch of songs."""
    total, count = lm_nll_stats(params, tokens, lengths, cfg)
    return total / count.clamp_min(1.0)


def support_state(params: LM, support: torch.Tensor,
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


def _inner_params(params: LM) -> dict:
    """The parameters the support loss reaches, by name: all but the cache
    head's, which get no inner gradient (so the adapted cache groups are
    the meta-parameters')."""
    return {n: p for n, p in params.named_parameters()
            if not n.startswith("cache_")}


def _adapt(params: LM, cfg, support: torch.Tensor,
           support_len: torch.Tensor, first_order: bool) -> dict:
    """One episode's inner SGD (run under vmap): cfg.inner_steps steps of
    lr cfg.inner_lr on the mean NLL of its support songs [K, L], from the
    shared parameters.  first_order detaches the inner gradients (FOMAML);
    otherwise the outer gradient runs through them (MAML).  Returns the
    adapted tensors by name."""
    def support_loss(p, sup, slen):
        inputs, targets, mask = shift_targets(sup, slen)
        logits, _ = functional_call(params, p, (lm_logits, inputs, cfg),
                                    {"mask": mask})
        return sequence_nll(logits, targets, mask)

    p = _inner_params(params)
    for _ in range(cfg.inner_steps):
        g = grad(support_loss)(p, support, support_len)
        if first_order:
            g = {k: v.detach() for k, v in g.items()}
        p = {k: w - cfg.inner_lr * g[k] for k, w in p.items()}
    return p


def finetune_adapt(params: LM, support: torch.Tensor,
                   support_len: torch.Tensor, cfg) -> dict:
    """Per-episode adapted parameters, stacked [B, ...] by name (the inner
    loop of ``finetune_episodic_nll_stats``; sampling's adaptation).  Runs
    under no_grad: torch.func.grad still differentiates the support loss,
    and nothing outside keeps a graph."""
    with torch.no_grad():
        return vmap(lambda s, sl: _adapt(params, cfg, s, sl, True))(
            support, support_len)


def finetune_episodic_nll_stats(params: LM, ep, cfg, drop=None,
                                lm_aux: float = 0.0,
                                resp_floor: float = 0.0):
    """(sum CE over query tokens, count) of the finetune variant: per
    episode, cfg.inner_steps SGD steps on its support songs' LM loss from
    the shared parameters (``_adapt``), then its query songs scored under
    the adapted parameters (``fewshot/models/lm.py`` 667-744).

    The B episodes adapt in one batched program (vmap), each on its own
    copy, so every routing predicate (the embedding fold's rows >= 512)
    sees one episode's rows, as under JAX's vmap.  The query pass is the
    dense-logits path (no fused head), in train mode, with its own
    dropout masks drawn from `drop` before the vmap.  With the cache head
    the mixture is scored outside the vmap: its parameters and the
    support counts are the same for the adapted and the shared model.
    Runs under no_grad too (evaluation): torch.func.grad ignores it."""
    b, q_, l_ = ep.query.shape
    v_total = _vocab(params, cfg)
    masks = ()
    if drop is not None and cfg.dropout > 0:
        d = cfg.hidden_dim if cfg.model == "lstm" else cfg.embed_dim
        masks = tuple(
            torch.rand((b, q_, l_ - 1, width), generator=drop,
                       device=ep.query.device) < 1.0 - cfg.dropout
            for width in (cfg.embed_dim, d))

    def one_episode(sup, slen, qry, qlen, *keep):
        p = _adapt(params, cfg, sup, slen, cfg.first_order)
        inputs, targets, mask = shift_targets(qry, qlen)
        logits, _, hidden = functional_call(
            params, p, (lm_logits, inputs, cfg),
            {"mask": mask, "with_hidden": True, "drop": keep or None})
        return lm_target_logp(logits, targets), hidden

    lm_t, hidden = vmap(one_episode)(ep.support, ep.support_len, ep.query,
                                     ep.query_len, *masks)
    _, targets, mask = shift_targets(ep.query, ep.query_len)
    flat_t = targets.reshape(b * q_, l_ - 1)
    flat_m = mask.reshape(b * q_, l_ - 1)
    lm_t = lm_t.reshape(b * q_, l_ - 1)
    if not cfg.support_cache:
        m = flat_m.float()
        return -(lm_t * m).sum(), m.sum()
    hidden = hidden.reshape(b * q_, l_ - 1, -1)
    if cfg.cache_dynamic:
        phi, total, s, p_global = cache_posterior_parts(
            params, ep.support, ep.support_len, v_total)
        cache_t = dynamic_cache_target_logp(
            phi.repeat_interleave(q_, dim=0),
            total.repeat_interleave(q_, dim=0), s, p_global, flat_t, flat_m)
    else:
        cache_t = take_targets(support_log_cache(
            params, ep.support, ep.support_len,
            v_total).repeat_interleave(q_, dim=0), flat_t)
    return cache_mix_stats(params, hidden, lm_t, cache_t, flat_m, lm_aux,
                           resp_floor)


def episodic_nll_stats(params: LM, ep, cfg, eval_mode: bool = False,
                       drop=None):
    """(sum CE over query tokens, query token count) for a meta-batch.

    LSTM: the support state (support_mode state or mean_state; none for an
    unconditioned model) primes each episode's Q query songs, which run as
    one [B*Q, L-1] batch.  Transformer and Moonlight: under state and
    mean_state alike the K support songs form a prefix that the query songs
    attend to (``transformer_prefix_forward``, ``moonlight.prefix_forward``);
    none runs the plain causal model.  The head is the fused head+CE
    (``fused_head_eligible``) or the dense logits;
    the loss is plain CE or, with support_cache, the gated cache mixture
    (static or dynamic cache).  eval_mode forces cache_lm_aux and
    cache_resp_floor to 0, so every reported NLL is the pure mixture.  In
    mean_state mode the support pass's top-layer outputs are unused, so its
    gradient arrives only through the final state (mean, then repeat).
    drop: the train-mode dropout's generator (None: no dropout), applied
    to the query side only.  support_mode="finetune" runs
    ``finetune_episodic_nll_stats`` (eval_mode is not forwarded: its inner
    loop differentiates the support loss either way).
    """
    check_supported(cfg)
    lm_aux = 0.0 if eval_mode else cfg.cache_lm_aux
    resp_floor = 0.0 if eval_mode else cfg.cache_resp_floor
    if cfg.support_mode == "finetune":
        return finetune_episodic_nll_stats(params, ep, cfg, drop, lm_aux,
                                           resp_floor)
    b, q_, l_ = ep.query.shape
    inputs, targets, mask = shift_targets(ep.query, ep.query_len)
    flat_inputs = inputs.reshape(b * q_, l_ - 1)
    flat_targets = targets.reshape(b * q_, l_ - 1)
    flat_mask = mask.reshape(b * q_, l_ - 1)
    v_total = _vocab(params, cfg)
    fused = fused_head_eligible(params, cfg, v_total)
    conditioned = cfg.support_mode in ("state", "mean_state")
    hidden = logits = None
    if cfg.model in ("transformer", "moonlight") and conditioned:
        drop_in, drop_out = _drop_sources(drop)
        # the K support songs, concatenated, form each episode's prefix
        _, k_, sl = ep.support.shape
        prefix = ep.support.reshape(b, k_ * sl)
        prefix_mask = (torch.arange(sl, device=prefix.device)
                       < ep.support_len[..., None]).reshape(b, k_ * sl)
        q_emb = dropout(embed(params, flat_inputs), cfg.dropout, drop_in)
        prefix_forward, backbone = (
            (moon_mod.prefix_forward, params.moonlight)
            if cfg.model == "moonlight" else
            (tfm_mod.transformer_prefix_forward, params.transformer))
        hidden = prefix_forward(
            backbone, embed(params, prefix), prefix_mask,
            q_emb.reshape(b, q_, l_ - 1, -1), mask, cfg)
        hidden = dropout(hidden.reshape(b * q_, l_ - 1, -1), cfg.dropout,
                         drop_out)
        if not fused:
            logits = head_logits(params, hidden, cfg)
    else:
        state = None
        if cfg.model == "lstm" and conditioned:
            state = support_state(params, ep.support, ep.support_len, cfg,
                                  eval_mode=eval_mode)
            # each episode's state over its Q query songs
            state = [(h.repeat_interleave(q_, dim=0),
                      c.repeat_interleave(q_, dim=0)) for h, c in state]
        if cfg.support_cache or fused:
            logits, _, hidden = lm_logits(params, flat_inputs, cfg,
                                          mask=flat_mask, state=state,
                                          eval_mode=eval_mode,
                                          with_hidden=True, no_head=fused,
                                          drop=drop)
        else:
            logits, _ = lm_logits(params, flat_inputs, cfg, mask=flat_mask,
                                  state=state, eval_mode=eval_mode,
                                  drop=drop)

    def lm_branch():
        if fused:
            lse, tl = head_lse_target(params, hidden, flat_targets, cfg)
            return tl - lse
        return lm_target_logp(logits, flat_targets)

    if cfg.support_cache:
        # one [B, V] cache per episode, over its Q query songs
        if cfg.cache_dynamic:
            phi, total, s, p_global = cache_posterior_parts(
                params, ep.support, ep.support_len, v_total)
            cache_t = dynamic_cache_target_logp(
                phi.repeat_interleave(q_, dim=0),
                total.repeat_interleave(q_, dim=0), s, p_global,
                flat_targets, flat_mask)
            return cache_mix_stats(params, hidden, lm_branch(), cache_t,
                                   flat_mask, lm_aux, resp_floor)
        log_cache = support_log_cache(params, ep.support, ep.support_len,
                                      v_total).repeat_interleave(q_, dim=0)
        if fused:
            return cache_mix_stats(params, hidden, lm_branch(),
                                   take_targets(log_cache, flat_targets),
                                   flat_mask, lm_aux, resp_floor)
        return cache_token_nll(params, logits, hidden, log_cache,
                               flat_targets, flat_mask, lm_aux, resp_floor)
    if fused:
        m = flat_mask.float()
        return (-lm_branch() * m).sum(), m.sum()
    return token_nll(logits, flat_targets, flat_mask)


def episodic_nll(params: LM, ep, cfg) -> torch.Tensor:
    """Query-set NLL/token of a meta-batch of episodes (the metric).

    eval_mode=True: a metric is never differentiated, and it is the pure
    mixture CE (no train-only cache_lm_aux or cache_resp_floor term)."""
    total, count = episodic_nll_stats(params, ep, cfg, eval_mode=True)
    return total / count.clamp_min(1.0)
