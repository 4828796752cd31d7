"""Moonlight-16B-A3B's block in the port (``models/moonlight.py``) against
a plain float32 reference (``tests/moonlight_reference.py``: the
published form of latent attention with naive per-head K and V, the expert
layer by direct indexing), on seeded random weights.

On the CPU, at tiny sizes (hidden 64, 4 heads, r 32, dn 16, dr 8, dv 16, 8
experts with 2 a token, 1 shared; a dense layer and 2 expert layers), in
fp32:
* the episodic forward's hidden states and NLL (prefix-attention twins);
* ``lm_logits``' causal model (support_mode none, the LM task);
* prefill then greedy decode through ``sampling.generate``: each step's
  logits against the reference's full forward over prefix + tokens;
* the absorbed decode attention against the published form;
* the expert layer's twin against direct indexing, with a selection bias
  that picks an expert the weights alone would not;
* one ``sample.attend`` a layer and one ``moe.route`` and ``moe.experts``
  an expert layer in each ``sample.decode_step``;
* ``init_lm`` refusing a width other than 2048, training and finetune
  refused.
Tolerances are absolute, on values of order 1 (hidden states after the
final norm, logits up to about 3): 1e-4, fp32 round-off through three
blocks in another order of sums (the absorbed form multiplies W_uk into
the query instead of into the keys).  The bf16 path misses them by far.

On a CUDA card (``-k on_cuda``), at the published widths: the grouped
expert layer against its twin (64 experts, top 6, 512 rows), the latent
decode attention against the published form at T = 609, a whole decode
step under ``torch.cuda.set_sync_debug_mode("error")``, and as many
launches a decode step at 16 experts as at 64.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import moonlight_reference as ref
from fewshot_torch import sampling, training
from fewshot_torch.config import Config
from fewshot_torch.data.episodes import Episode
from fewshot_torch.data.vocab import BOS, PAD
from fewshot_torch.models import lm as lm_mod
from fewshot_torch.models import moonlight as moon

V, L, K = 50, 10, 2
TINY = moon.Sizes(hidden=64, heads=4, kv_rank=32, nope=16, rope=8, v=16,
                  dense_width=96, dense_layers=1, experts=8, top_k=2,
                  expert_width=32, shared=1)
TOL = 1e-4


def _shapes(s: moon.Sizes, li: int) -> dict:
    e, nh, r, x, w = s.hidden, s.heads, s.kv_rank, s.experts, s.expert_width
    out = {"ln1": (e,), "wq": (e, nh * s.qk), "wkva": (e, r + s.rope),
           "kv_ln": (r,), "wkvb": (r, nh * (s.nope + s.v)),
           "wo": (nh * s.v, e), "ln2": (e,)}
    if li < s.dense_layers:
        out.update(w_gate=(e, s.dense_width), w_up=(e, s.dense_width),
                   w_down=(s.dense_width, e))
    else:
        sw = s.shared * w
        out.update(router=(e, x), router_bias=(x,), e_gate=(x, e, w),
                   e_up=(x, e, w), e_down=(x, w, e), s_gate=(e, sw),
                   s_up=(e, sw), s_down=(sw, e))
    return out


def _params(s: moon.Sizes, layers: int, seed: int = 0, device="cpu"):
    """Random parameters by name: norms around 1, glorot-uniform matrices,
    a selection bias of spread 0.02 (the scores' own spread is ~0.2)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for li in range(layers):
        for name, shape in _shapes(s, li).items():
            if len(shape) == 1:
                base = 0.0 if name == "router_bias" else 1.0
                spread = 0.02 if name == "router_bias" else 0.1
                t = base + spread * torch.randn(shape, generator=g,
                                                device=device)
            else:
                lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
                t = (torch.rand(shape, generator=g, device=device) * 2 - 1) \
                    * lim
            out[f"layers.{li}.{name}"] = t
    out["ln_f"] = 1.0 + 0.1 * torch.randn((s.hidden,), generator=g,
                                          device=device)
    return out


def _module(p: dict, s: moon.Sizes) -> moon.Moonlight:
    n = ref.layer_count(p)
    layers = torch.nn.ModuleList(
        moon.MoonlightLayer(**{k.split(".", 2)[2]: v.clone()
                               for k, v in p.items()
                               if k.startswith(f"layers.{li}.")})
        for li in range(n))
    return moon.Moonlight(layers, p["ln_f"].clone(), s)


def _ref_sizes(s: moon.Sizes) -> dict:
    return {k: getattr(s, k) for k in ("hidden", "heads", "kv_rank", "nope",
                                       "rope", "v", "top_k", "scaling",
                                       "rope_theta", "eps")}


def _cfg(**kw):
    return Config(**{**dict(
        model="moonlight", vocab_size=V, max_len=L, embed_dim=TINY.hidden,
        num_layers=3, batch_size=2, support_size=K, query_size=2,
        support_mode="mean_state", compute_dtype="float32", cell="scan",
        prefix_flash=True, flash=False, top_k=0, support_cache=False),
        **kw})


def _lm(seed=0):
    p = _params(TINY, 3, seed)
    g = torch.Generator().manual_seed(seed + 100)
    embed = 0.1 * torch.randn((V, TINY.hidden), generator=g)
    out_b = 0.1 * torch.randn((V,), generator=g)
    return lm_mod.LM(embed, None, out_b, moonlight=_module(p, TINY)), p


def _songs(n, seed):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(3, L + 1, (n,), generator=g)
    toks = torch.randint(3, V, (n, L), generator=g)
    toks[torch.arange(L)[None] >= lens[:, None]] = PAD
    toks[:, 0] = BOS
    return toks, lens


def _ref_logits(lm, p, seq, valid):
    hid = ref.hidden(p, _ref_sizes(TINY), lm.embed.detach()[seq], valid)
    return hid @ lm.embed.detach().T + lm.out_b.detach(), hid


def _prefix_mask(support_len):
    return (torch.arange(L) < support_len[..., None]).reshape(
        support_len.shape[0], -1)


def test_episodic_hidden_and_nll_match_the_reference():
    lm, p = _lm()
    cfg = _cfg()
    b, q_ = 2, 2
    sup, slen = _songs(b * K, 1)
    qry, qlen = _songs(b * q_, 2)
    ep = Episode(sup.reshape(b, K, L), slen.reshape(b, K),
                 qry.reshape(b, q_, L), qlen.reshape(b, q_),
                 torch.arange(b))
    inputs, targets, mask = lm_mod.shift_targets(ep.query, ep.query_len)
    with torch.no_grad():
        hid = moon.prefix_forward(
            lm.moonlight, lm.embed[ep.support.reshape(b, K * L)],
            _prefix_mask(ep.support_len), lm.embed[inputs], mask, cfg)
        total, count = lm_mod.episodic_nll_stats(lm, ep, cfg, eval_mode=True)
    seq = torch.cat([ep.support.reshape(b, K * L).repeat_interleave(q_, 0),
                     inputs.reshape(b * q_, L - 1)], 1)
    valid = torch.cat([_prefix_mask(ep.support_len).repeat_interleave(q_, 0),
                       mask.reshape(b * q_, L - 1)], 1)
    logits, want = _ref_logits(lm, p, seq, valid)
    m = mask.reshape(b * q_, L - 1)
    got = hid.reshape(b * q_, L - 1, -1)
    assert (got - want[:, K * L:]).abs()[m].max() < TOL
    logp = torch.log_softmax(logits[:, K * L:], -1)
    nll = -logp.gather(-1, targets.reshape(b * q_, L - 1, 1))[..., 0]
    assert count == m.sum()
    assert abs(float(total) - float(nll[m].sum())) < TOL * float(count)


def test_causal_forward_matches_the_reference():
    """lm_logits' causal model (support_mode none, the LM task): the stack
    over the songs alone, pad keys masked."""
    lm, p = _lm(1)
    toks, lens = _songs(3, 9)
    mask = torch.arange(L)[None] < lens[:, None]
    with torch.no_grad():
        logits, state = lm_mod.lm_logits(lm, toks, _cfg(), mask=mask)
    want, _ = _ref_logits(lm, p, toks, mask)
    assert state is None
    assert (logits - want).abs()[mask].max() < TOL


def _greedy(cfg, monkeypatch, n_tok=7):
    """(tokens [R, n], each step's logits [R, n, V], the reference's
    logits at the same positions) of greedy decoding through generate."""
    lm, p = _lm()
    rows = 3
    sup, slen = _songs(rows * K, 5)
    support, support_len = sup.reshape(rows, K, L), slen.reshape(rows, K)
    seen = []
    orig = sampling.filtered_sample

    def record(noise, logits, *a, **k):
        seen.append(logits.float().clone())
        return orig(noise, logits, *a, **k)
    monkeypatch.setattr(sampling, "filtered_sample", record)
    gens = [torch.Generator().manual_seed(i) for i in range(rows)]
    toks = sampling.generate(lm, support, support_len, gens, cfg,
                             n_tokens=n_tok, temperature=0.0,
                             early_exit=False)
    inputs = torch.cat([torch.full((rows, 1), BOS), toks[:, :-1]], 1)
    seq = torch.cat([support.reshape(rows, K * L), inputs], 1)
    valid = torch.cat([_prefix_mask(support_len),
                       torch.ones(rows, n_tok, dtype=torch.bool)], 1)
    with torch.no_grad():
        want, _ = _ref_logits(lm, p, seq, valid)
    return toks, torch.stack(seen, 1), want[:, K * L:]


def test_greedy_decode_logits_match_the_reference(monkeypatch):
    toks, got, want = _greedy(_cfg(), monkeypatch)
    assert (got - want).abs().max() < TOL
    assert torch.equal(toks, want.argmax(-1))


def test_bf16_path_misses_the_tolerance(monkeypatch):
    """The same path at the compute dtype bf16 falls outside the fp32
    tolerance: the comparison can tell a lower precision."""
    _, got, want = _greedy(_cfg(compute_dtype="bfloat16"), monkeypatch)
    assert (got - want).abs().max() > 10 * TOL


def test_absorbed_decode_matches_the_published_form():
    p = _params(TINY, 1, 3)
    w = moon.compute_weights(_module(p, TINY), torch.float32)[0]
    layer = {k.split(".", 2)[2]: v for k, v in p.items()
             if k.startswith("layers.0.")}
    g = torch.Generator().manual_seed(4)
    b, t, idx = 3, 9, 6
    latent = torch.randn((b, t, TINY.kv_rank + TINY.rope), generator=g)
    valid = torch.rand((b, t), generator=g) < 0.7
    valid[:, idx] = True
    valid[1, idx + 1:] = True          # stale slots past idx take no part
    q = torch.randn((b, TINY.heads, TINY.qk), generator=g)
    got = moon.latent_attention(q, w, latent, moon.key_bias(valid, idx),
                                TINY)
    k, v = ref.keys_values(layer, _ref_sizes(TINY), latent)
    allowed = (valid & (torch.arange(t) <= idx))[:, None, :]
    want = ref.attend(q[:, None], k, v, allowed)[:, 0]
    assert (got - want).abs().max() < 1e-5


def test_expert_layer_twin_matches_direct_indexing():
    """The routed pairs' sort, the grouped products' twin and the combine
    against direct indexing; a selection bias that moves one expert into
    token 0's chosen two changes the result, and the weights still come
    from the scores alone."""
    p = _params(TINY, 2, 7)
    layer = {k.split(".", 2)[2]: v for k, v in p.items()
             if k.startswith("layers.1.")}
    layer["router_bias"] = torch.zeros(TINY.experts)
    x = torch.randn((13, TINY.hidden), generator=torch.Generator()
                    .manual_seed(8))
    s = _ref_sizes(TINY)
    g = torch.sigmoid(x @ layer["router"])
    third = g[0].argsort(descending=True)[TINY.top_k]
    biased = dict(layer, router_bias=torch.zeros(TINY.experts)
                  .index_fill(0, third, 1.0))
    top, _ = ref.route(biased, s, x)
    assert third in top[0] and third not in ref.route(layer, s, x)[0][0]
    outs = []
    for lay in (layer, biased):
        m = moon.Moonlight(torch.nn.ModuleList([moon.MoonlightLayer(**lay)]),
                           p["ln_f"], TINY)
        w = moon.compute_weights(m, torch.float32)[0]
        got = moon.expert_layer(w, x, TINY, torch.float32)
        want = ref.expert_layer(lay, s, x)
        assert (got - want).abs().max() < 1e-5
        outs.append(got)
    assert (outs[0][0] - outs[1][0]).abs().max() > 1e-2


def test_decode_spans_per_layer_and_expert_layer(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _greedy(_cfg(), monkeypatch, n_tok=4)
    events = prof.events()
    steps = [e for e in events if e.name == "sample.decode_step"]
    assert len(steps) == 4
    for step in steps:
        kids = [c.name for c in step.cpu_children]
        assert kids.count("sample.attend") == 3
        assert kids.count("moe.route") == 2
        assert kids.count("moe.experts") == 2
    for name in ("sample.attend", "moe.route", "moe.experts"):
        inside = [e for e in events if e.name == name
                  and e.cpu_parent is not None
                  and e.cpu_parent.name == "sample.decode_step"]
        assert len(inside) == 4 * (3 if name == "sample.attend" else 2)


def test_init_lm_refuses_another_width():
    with pytest.raises(ValueError, match="2048"):
        lm_mod.init_lm(_cfg(), V, torch.Generator().manual_seed(0), "cpu")


def test_init_lm_builds_the_published_dense_layer():
    cfg = _cfg(embed_dim=2048, num_layers=1)
    lm = lm_mod.init_lm(cfg, V, torch.Generator().manual_seed(0), "cpu")
    got = {k.split(".", 3)[3]: tuple(v.shape)
           for k, v in lm.named_parameters()
           if k.startswith("moonlight.layers.0.")}
    assert got == _shapes(moon.Sizes(), 0)
    assert lm.moonlight.sizes == moon.Sizes()


def test_training_and_finetune_refused():
    with pytest.raises(ValueError, match="moonlight"):
        training.make_fed_train_step(_cfg())
    with pytest.raises(ValueError, match="moonlight"):
        lm_mod.check_supported(_cfg(support_mode="finetune"))


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped GEMM and the cuBLAS "
                    "bf16 products with fp32 results have no CPU mode")
    return torch.device("cuda")


def _published(device, layers=2, experts=64):
    s = moon.Sizes(experts=experts)
    p = _params(s, layers, 11, device)
    return _module(p, s), p, s


def test_grouped_expert_layer_matches_its_twin_on_cuda(cuda_device,
                                                       monkeypatch):
    """Tolerance 2e-2 on outputs of order 1: both sides round the products
    to bf16; where the fp32 sums' order moves a value across a bf16
    rounding boundary, one bf16 unit (2^-8 relative) moves."""
    m, _, s = _published(cuda_device)
    w = moon.compute_weights(m, torch.bfloat16)[1]
    x = torch.randn((512, s.hidden), device=cuda_device)
    got = moon.expert_layer(w, x, s, torch.bfloat16)
    monkeypatch.setattr(moon, "grouped_mm", moon.grouped_mm_plain)
    want = moon.expert_layer(w, x, s, torch.bfloat16)
    assert (got - want).abs().max() < 2e-2


def test_latent_attention_matches_the_published_form_on_cuda(cuda_device):
    """At T = 609 (a 480-slot prefix, 128 decode positions and one), 512
    rows, bf16: the published form in fp32 from the same bf16 latent.
    Tolerance 3e-2 on outputs of order 1: q_lat, p and o_lat are rounded
    to bf16 (2^-8 relative each)."""
    ref.strict_fp32()
    m, p, s = _published(cuda_device, layers=1)
    w = moon.compute_weights(m, torch.bfloat16)[0]
    layer = {k.split(".", 2)[2]: v for k, v in p.items()
             if k.startswith("layers.0.")}
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, t, idx = 512, 609, 550
    x = torch.randn((b, t, s.hidden), generator=g, device=cuda_device)
    lat = ref.latent(layer, _ref_sizes(s),
                     ref.rmsnorm(x, layer["ln1"], s.eps),
                     torch.arange(t, device=cuda_device))
    latent = lat.to(torch.bfloat16)
    valid = torch.rand((b, t), generator=g, device=cuda_device) < 0.6
    valid[:, idx] = True
    q = torch.randn((b, s.heads, s.qk), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    got = moon.latent_attention(q, w, latent, moon.key_bias(valid, idx), s)
    k, v = ref.keys_values(layer, _ref_sizes(s), latent.float())
    allowed = (valid & (torch.arange(t, device=cuda_device) <= idx))[:, None]
    want = ref.attend(q.float()[:, None], k, v, allowed)[:, 0]
    assert (got.float() - want).abs().max() < 3e-2


def _decode_setup(device, experts):
    m, _, s = _published(device, experts=experts)
    cfg = _cfg(embed_dim=s.hidden, num_layers=2, compute_dtype="bfloat16")
    ws = moon.compute_weights(m, torch.bfloat16)
    rows, prefix = 512, 96
    cache = moon.init_cache(m, rows, prefix + 8, torch.bfloat16, device)
    x = torch.randn((rows, prefix, s.hidden), device=device)
    moon.prefill(m, ws, x, torch.ones((rows, prefix), dtype=torch.bool,
                                      device=device), cache, cfg)
    x_t = torch.randn((rows, s.hidden), device=device).to(torch.bfloat16)
    return m, ws, cache, cfg, x_t, prefix


def test_decode_step_makes_no_host_sync_on_cuda(cuda_device):
    m, ws, cache, cfg, x_t, idx = _decode_setup(cuda_device, 64)
    w_head = torch.randn((m.sizes.hidden, V), device=cuda_device).to(
        torch.bfloat16)
    noise = torch.rand((x_t.shape[0], V), device=cuda_device)
    temp = torch.ones((x_t.shape[0],), device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(2):
            h = moon.decode_step(m, ws, x_t, cache, idx + i, cfg)
            logits = moon.mm(h, w_head)
            sampling.filtered_sample(noise, logits, temp, 40)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert h.shape == x_t.shape
    torch.cuda.synchronize()


def test_decode_launches_do_not_grow_with_experts_on_cuda(cuda_device):
    counts = []
    for experts in (16, 64):
        m, ws, cache, cfg, x_t, idx = _decode_setup(cuda_device, experts)
        moon.decode_step(m, ws, x_t, cache, idx, cfg)       # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            moon.decode_step(m, ws, x_t, cache, idx + 1, cfg)
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
        del m, ws, cache
        torch.cuda.empty_cache()
    assert counts[0] == counts[1] > 0
