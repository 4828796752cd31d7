"""Few-shot generation: support-primed top-k / nucleus sampling.

Port of ``fewshot/sampling.py``: ``filtered_sample``, the decode loop,
``sample_lstm``, ``sample_transformer`` (the support prefix prefilled into
a KV cache through the prefix-attention kernels, then one cached step per
token) and ``generate``, the finetune variant included (each row adapts
its own parameters on its support set, then decodes under them).  With
the cache head (``support_cache``) every step samples from the same gated
mixture the model is scored under: the static cache's
support posterior, or (``cache_dynamic``) that posterior with the row's
own emitted tokens counted in, as the continuous-cache NLL counts the
query's prefix.  ``token_masks`` [P, V] (the MIDI event grammar,
``data.midi.grammar_masks``) restricts each step to the legal tokens of the
row's phase, applied after the cache mixture; the phase advances by one
(mod P) on each token a live row emits, and a finished row keeps its
phase.  Semantics are the JAX package's:

  * temperature scales the logits BEFORE top-k truncation;
  * top_k == 0 means full ancestral sampling; 0 < top_p < 1 also applies
    nucleus filtering (the smallest set whose probability reaches top_p);
  * generation starts from BOS after the support prime, and a row emits
    PAD after its EOS.

Randomness: each row draws its noise from its own ``torch.Generator``, and
a token is drawn by Gumbel-max (argmax of logits + Gumbel noise, which is a
draw from softmax(logits)).  A row's tokens therefore depend only on its
own generator, never on its position in the batch.  JAX's threefry streams
cannot be reproduced, so the parity tests compare greedy decoding.

Profiler spans (``utils.metrics.span``): ``sample.generate`` a call, holding
``sample.support`` (support pass, prefill, cache posterior),
``sample.noise`` and ``sample.decode``; the decode loop holds one
``sample.decode_step`` a step that runs and one ``sample.sync`` an
early-exit test.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from fewshot_torch.data import midi as midi_mod
from fewshot_torch.data.vocab import BOS, EOS, PAD
from fewshot_torch.models import lm as lm_mod
from fewshot_torch.models import lstm as lstm_mod
from fewshot_torch.models import moonlight as moon_mod
from fewshot_torch.models import transformer as tfm_mod
from fewshot_torch.utils.metrics import span

# Early exit tests "every row has emitted EOS" once per this many tokens
# (each test waits for the device); rows that finished emit PAD meanwhile,
# so the output is the same as testing every token.
EXIT_CHECK_EVERY = 8


def row_generator(seed: int, stream: int,
                  device: torch.device | str = "cpu") -> torch.Generator:
    """A generator for one row: `stream` separates the row's independent
    uses of its seed (0: episode songs, 1: sampling noise)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream) % 2 ** 63)
    return g


def grammar_masks(cfg, corpus, device) -> torch.Tensor | None:
    """The MIDI event grammar's [4, V] masks on `device` where the config
    samples under them (``grammar_sampling`` on a MIDI corpus without BPE
    merges: a merged token spans phases), else None."""
    if cfg.dataset == "midi" and cfg.grammar_sampling and not corpus.merges:
        return torch.as_tensor(midi_mod.grammar_masks(corpus.vocab),
                               device=device)
    return None


def gumbel_noise(generators, n_tokens: int, vocab: int,
                 device: torch.device) -> torch.Tensor:
    """[n_tokens, B, V] Gumbel noise, row b drawn from generators[b]."""
    u = torch.stack([torch.rand((n_tokens, vocab), generator=g,
                                device=device) for g in generators], dim=1)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def filter_logits(logits: torch.Tensor, temperature, top_k: int,
                  top_p: float = 0.0) -> torch.Tensor:
    """Temperature, then top-k, then nucleus filtering; dropped = -inf.

    temperature: a scalar or a per-row [B] tensor."""
    logits = logits.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    if temperature.ndim == 1:
        temperature = temperature[:, None]
    logits = logits / temperature.clamp(min=1e-6)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p    # up to and including the crossing one
        cutoff = sorted_logits.masked_fill(~keep, float("inf")).min(
            dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def filtered_sample(noise: torch.Tensor, logits: torch.Tensor, temperature,
                    top_k: int, top_p: float = 0.0) -> torch.Tensor:
    """Token ids [B] from logits [B, V], given Gumbel noise [B, V]."""
    return torch.argmax(filter_logits(logits, temperature, top_k, top_p)
                        + noise, dim=-1)


def _cache_ctx(params, support: torch.Tensor, support_len: torch.Tensor,
               cfg):
    """None, or the cache head's context for the decode loop: ("static",
    the [B, V] support log-posterior) or, with cfg.cache_dynamic,
    ("dynamic", phi, total, s, p_global), the posterior's parts, to which
    the loop adds the row's emitted-token counts each step."""
    if not cfg.support_cache:
        return None
    v = params.out_b.shape[0]
    if cfg.cache_dynamic:
        return ("dynamic",) + tuple(lm_mod.cache_posterior_parts(
            params, support, support_len, v))
    return ("static", lm_mod.support_log_cache(params, support, support_len,
                                               v))


def _dynamic_log_cache(ctx, c_pre: torch.Tensor, n_pre: torch.Tensor
                       ) -> torch.Tensor:
    """[B, V] log-posterior with the emitted counts c_pre [B, V] and their
    total n_pre [B, 1] added to the support's."""
    _, phi, total, s, p_global = ctx
    return (torch.log(phi + c_pre + s * p_global[None])
            - torch.log(total + n_pre + s))


def _count_emitted(c_pre: torch.Tensor, n_pre: torch.Tensor,
                   nxt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Add the just-emitted tokens [B] to the carried counts; a finished
    row emits PAD, which is a real id and must not count."""
    live = (nxt != PAD).float()
    c_pre = c_pre.scatter_add(1, nxt[:, None], live[:, None])
    return c_pre, n_pre + live[:, None]


def _decode(params, step, b: int, dev, generators, cfg, n_tokens: int,
            temperature, early_exit: bool, ctx=None,
            token_masks: torch.Tensor | None = None,
            head=None) -> torch.Tensor:
    """The decode loop from BOS: step(tok [B], i) -> top hidden [B, D] of
    position i; ctx: the cache head's context (``_cache_ctx``) or None;
    token_masks: [P, V] bool, the legal tokens of each phase, or None;
    head: hidden -> logits, ``lm.head_logits`` where None.
    Returns tokens [B, n_tokens], PAD after a row's EOS."""
    if len(generators) != b:
        raise ValueError(f"need one generator per row ({b}), got "
                         f"{len(generators)}")
    temp = (torch.full((b,), cfg.temperature, device=dev)
            if temperature is None
            else torch.as_tensor(temperature, dtype=torch.float32,
                                 device=dev).expand(b))
    vocab = params.out_b.shape[0]
    with span("sample.noise"):
        noise = gumbel_noise(generators, n_tokens, vocab, dev)
    tok = torch.full((b,), BOS, dtype=torch.int64, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    toks = torch.full((b, n_tokens), PAD, dtype=torch.int64, device=dev)
    dynamic = ctx is not None and ctx[0] == "dynamic"
    if dynamic:
        c_pre = torch.zeros((b, vocab), device=dev)
        n_pre = torch.zeros((b, 1), device=dev)
    if token_masks is not None:
        token_masks = torch.as_tensor(token_masks, dtype=torch.bool,
                                      device=dev)
        phase = torch.zeros((b,), dtype=torch.int64, device=dev)
    with span("sample.decode"):
        for i in range(n_tokens):
            if early_exit and i and i % EXIT_CHECK_EVERY == 0:
                with span("sample.sync"):
                    finished = bool(done.all())
                if finished:
                    break
            with span("sample.decode_step"):
                h = step(tok, i)
                logits = (lm_mod.head_logits(params, h, cfg) if head is None
                          else head(h))
                if ctx is not None:
                    # sample from the same mixture the NLL scores
                    log_cache = (_dynamic_log_cache(ctx, c_pre, n_pre)
                                 if dynamic else ctx[1])
                    logits = lm_mod.cache_mixed_logp(params, logits, h,
                                                     log_cache)
                if token_masks is not None:
                    logits = logits.masked_fill(~token_masks[phase],
                                                float("-inf"))
                nxt = filtered_sample(noise[i], logits, temp, cfg.top_k,
                                      cfg.top_p)
                nxt = nxt.masked_fill(done, PAD)
                done = done | (nxt == EOS)
                if token_masks is not None:
                    phase = torch.where(done, phase,
                                        (phase + 1) % token_masks.shape[0])
                if dynamic:
                    c_pre, n_pre = _count_emitted(c_pre, n_pre, nxt)
                toks[:, i] = nxt
                tok = nxt
    return toks


def sample_lstm(params, support: torch.Tensor, support_len: torch.Tensor,
                generators, cfg, n_tokens: int, temperature=None,
                early_exit: bool = True, token_masks=None) -> torch.Tensor:
    """LSTM few-shot continuation.  support [B, K, L] -> tokens [B, n]."""
    b = support.shape[0]
    dev = support.device
    dt = lm_mod.compute_dtype(cfg)
    with span("sample.support"):
        if cfg.support_mode in ("state", "mean_state"):
            state = lm_mod.support_state(params, support, support_len, cfg,
                                         eval_mode=True)
        else:
            state = lstm_mod.zero_state(b, cfg.hidden_dim, cfg.num_layers,
                                        dev)
        ctx = _cache_ctx(params, support, support_len, cfg)

    def step(tok, _):
        nonlocal state
        h, state = lstm_mod.lstm_step(params.lstm, lm_mod.embed(params, tok),
                                      state, dt)
        return h
    return _decode(params, step, b, dev, generators, cfg, n_tokens,
                   temperature, early_exit, ctx, token_masks)


def sample_transformer(params, support: torch.Tensor,
                       support_len: torch.Tensor, generators, cfg,
                       n_tokens: int, temperature=None,
                       early_exit: bool = True,
                       token_masks=None) -> torch.Tensor:
    """Transformer few-shot continuation by prefix KV-cache decode: the K
    support songs (support_mode state or mean_state) prefill the cache in
    one pass, then position K L + i decodes token i.  support [B, K, L] ->
    tokens [B, n]."""
    with span("sample.support"):
        cache, prefix_len = prefix_cache(params, support, support_len, cfg,
                                         n_tokens + 1)
        ctx = _cache_ctx(params, support, support_len, cfg)

    def step(tok, i):
        h, _ = tfm_mod.transformer_step(params.transformer,
                                        lm_mod.embed(params, tok), cache,
                                        prefix_len + i, cfg)
        return h
    return _decode(params, step, support.shape[0], support.device,
                   generators, cfg, n_tokens, temperature, early_exit, ctx,
                   token_masks)


def sample_moonlight(params, support: torch.Tensor,
                     support_len: torch.Tensor, generators, cfg,
                     n_tokens: int, temperature=None,
                     early_exit: bool = True,
                     token_masks=None) -> torch.Tensor:
    """Moonlight's block by latent-cache decode, laid out as
    ``sample_transformer``: the support prefix (state or mean_state)
    prefilled into the latent cache, then position K L + i decodes token
    i.  The weights' compute-dtype copies, the embedding's among them,
    are made once, inside ``sample.support``; the tied head multiplies
    by that copy (``head_logits``' products at the same operands).
    support [B, K, L] -> tokens [B, n]."""
    m = params.moonlight
    dt = lm_mod.compute_dtype(cfg)
    b, k_, l_ = support.shape
    dev = support.device
    with span("sample.support"):
        ws = moon_mod.compute_weights(m, dt)
        emb = params.embed.to(dt)
        w_head = emb.T if cfg.tie_embeddings else params.out_w.to(dt)
        prefix_len = (k_ * l_ if cfg.support_mode in ("state", "mean_state")
                      else 0)
        cache = moon_mod.init_cache(m, b, prefix_len + n_tokens + 1, dt, dev)
        if prefix_len:
            mask = (torch.arange(l_, device=dev)
                    < support_len[..., None]).reshape(b, prefix_len)
            moon_mod.prefill(m, ws, emb[support.reshape(b, prefix_len)],
                             mask, cache, cfg)
        ctx = _cache_ctx(params, support, support_len, cfg)

    def step(tok, i):
        return moon_mod.decode_step(m, ws, emb[tok], cache, prefix_len + i,
                                    cfg)

    def head(h):
        return moon_mod.mm(h, w_head) + params.out_b
    return _decode(params, step, b, dev, generators, cfg, n_tokens,
                   temperature, early_exit, ctx, token_masks, head)


SAMPLERS = {"lstm": sample_lstm, "transformer": sample_transformer,
            "moonlight": sample_moonlight}


def prefix_cache(params, support: torch.Tensor, support_len: torch.Tensor,
                 cfg, extra: int) -> tuple[dict, int]:
    """(KV cache, prefix length): a cache of prefix length + `extra`
    positions whose first K L hold the support prefix (prefilled in one
    pass) under support_mode state or mean_state; no prefix under none."""
    b, k_, l_ = support.shape
    dev = support.device
    use_prefix = cfg.support_mode in ("state", "mean_state")
    prefix_len = k_ * l_ if use_prefix else 0
    cache = tfm_mod.init_kv_cache(cfg, b, prefix_len + extra, dev)
    if use_prefix:
        flat = support.reshape(b, prefix_len)
        mask = (torch.arange(l_, device=dev)
                < support_len[..., None]).reshape(b, prefix_len)
        tfm_mod.prefill(params.transformer, lm_mod.embed(params, flat), mask,
                        cache, cfg)
    return cache, prefix_len


def generate(params, support: torch.Tensor, support_len: torch.Tensor,
             generators, cfg, n_tokens: int | None = None, temperature=None,
             early_exit: bool = True, token_masks=None) -> torch.Tensor:
    """Support-conditioned continuations [B, n] (int64 token ids).

    generators: one torch.Generator per row, on the support's device; row
    i's continuation depends only on generators[i].  temperature: optional
    scalar or [B] overriding cfg.temperature.  early_exit stops once every
    row has emitted EOS; the output is the same either way.  token_masks:
    optional [P, V] bool per-phase legal tokens (the MIDI grammar).

    support_mode="finetune": the inner SGD adapts one parameter copy per
    row on its support set (``lm.finetune_adapt``, before inference mode:
    it differentiates), then each row decodes alone under its own copy, a
    loop over the rows (a row's tokens still depend on its generator
    only)."""
    with span("sample.generate"):
        lm_mod.check_supported(cfg)
        n = n_tokens if n_tokens is not None else cfg.sample_tokens
        fn = SAMPLERS[cfg.model]
        if cfg.support_mode != "finetune":
            with torch.inference_mode():
                return fn(params, support, support_len, generators, cfg, n,
                          temperature, early_exit, token_masks)
        b = support.shape[0]
        if len(generators) != b:
            raise ValueError(f"need one generator per row ({b}), got "
                             f"{len(generators)}")
        adapted = lm_mod.finetune_adapt(params, support, support_len, cfg)
        temps = (None if temperature is None else torch.as_tensor(
            temperature, dtype=torch.float32).expand(b))
        rows = []
        with torch.inference_mode():
            for i in range(b):
                with span("sample.generate"):
                    rows.append(functional_call(
                        params, {k: v[i] for k, v in adapted.items()},
                        (fn, support[i:i + 1], support_len[i:i + 1],
                         generators[i:i + 1], cfg, n,
                         None if temps is None else temps[i:i + 1], early_exit,
                         token_masks)))
        return torch.cat(rows)
