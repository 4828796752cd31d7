"""The port's sampler against fewshot.sampling.

* filtered_sample: given the same Gumbel noise that jax.random.categorical
  draws for a key, the port picks the same token as the JAX sampler, for
  every mix of temperature (scalar or per row), top-k and top-p; this pins
  temperature-before-top-k and the nucleus rule exactly.
* Greedy end to end (top_k=1, fp32): the port's generate() emits the JAX
  package's tokens, token for token, on fixed episodes and bridged weights,
  with the JAX side on its Pallas kernels in interpret mode (a subprocess:
  FEWSHOT_PALLAS_INTERPRET is read at import).  2 layers route to the fused
  kernel, 1 layer to the per-layer kernel.  The support state and the
  per-step logits along JAX's tokens agree to 1e-4 (fp32; the logits reach
  about 10 in magnitude, and only summation order differs).
* A row emits PAD after its EOS, early exit changes nothing, and a row's
  output does not depend on its batch neighbours.
* The cache head in the decode loop (static and dynamic cache; the LSTM in
  state and mean_state, the transformer in state; fp32, the same weights
  through the bridge): ``cache_mixed_logp`` against JAX's within 1e-5;
  ``_count_emitted`` skips PAD rows; fed JAX's greedy tokens, the port's
  loop computes JAX's mixed log-probs at every step within 1e-4; its own
  greedy tokens equal JAX's up to a row's first near tie.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot import sampling as jsampling
from fewshot.config import Config as JConfig
from fewshot_torch import sampling
from fewshot_torch.bridge import params_from_numpy
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.vocab import EOS, PAD
from fewshot_torch.models import lm, lstm
from fewshot_torch.ops import lstm_stack

REPO = Path(__file__).resolve().parent.parent
E, H, N_TOK = 32, 128, 12
# (layers, support_mode): the fused kernel on the shipped mode, the
# per-layer kernel on the bench mode
ROUTES = [(2, "state"), (1, "mean_state")]
SONG_IDS = np.array([[0, 1, 2], [8, 9, 10], [13, 14, 12], [40, 41, 42]])


def _cfg_kw(layers, mode, v):
    return dict(vocab_size=64, max_len=24, embed_dim=E, hidden_dim=H,
                num_layers=layers, batch_size=4, support_size=2,
                query_size=1, cell="pallas", support_mode=mode,
                compute_dtype="float32", top_k=1, sample_tokens=N_TOK)


def _tree(layers, v, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    tree = {"embed": f(0.5, v, E), "out_b": f(0.1, v), "lstm": [],
            "out_proj": f(0.3, H, E)}
    in_dim = E
    for _ in range(layers):
        lim = np.sqrt(6.0 / (in_dim + 5 * H))
        tree["lstm"].append({
            "wx": rng.uniform(-lim, lim, (in_dim, 4 * H)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(np.float32),
            "b": f(0.1, 4 * H)})
        in_dim = H
    return tree


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot import sampling
from fewshot.config import Config
from fewshot.data.episodes import CorpusOnDevice, gather_episode
from fewshot.data.vocab import BOS
from fewshot.models import lm, lstm

d = sys.argv[1]
z = dict(np.load(d + "/inputs.npz"))
data = CorpusOnDevice(*(jnp.asarray(z[k]) for k in
                        ("songs", "song_len", "artist_song_ids",
                         "artist_num_songs")))
out = {}
for layers, mode in ((2, "state"), (1, "mean_state")):
    tag = f"{layers}_{mode}"
    params = {"embed": jnp.asarray(z[f"{tag}_embed"]),
              "out_b": jnp.asarray(z[f"{tag}_out_b"]),
              "out_proj": jnp.asarray(z[f"{tag}_out_proj"]),
              "lstm": [{k: jnp.asarray(z[f"{tag}_lstm{l}_{k}"])
                        for k in ("wx", "wh", "b")} for l in range(layers)]}
    cfg = Config(vocab_size=64, max_len=z["songs"].shape[1], embed_dim=32,
                 hidden_dim=128, num_layers=layers, batch_size=4,
                 support_size=2, query_size=1, cell="pallas",
                 support_mode=mode, compute_dtype="float32", top_k=1,
                 sample_tokens=int(z["n_tok"]))
    ep = gather_episode(data, jnp.asarray(z["song_ids"]),
                        jnp.asarray(z["artist"]), 2, 1)
    toks = sampling.generate(params, ep.support, ep.support_len,
                             jax.random.PRNGKey(0), cfg)
    state = lm.support_state(params, ep.support, ep.support_len, cfg,
                             eval_mode=True)
    out[f"{tag}_toks"] = np.asarray(toks)
    out[f"{tag}_h"] = np.stack([np.asarray(h) for h, _ in state])
    out[f"{tag}_c"] = np.stack([np.asarray(c) for _, c in state])
    tok = jnp.full((toks.shape[0],), BOS, jnp.int32)
    logits = []
    for i in range(toks.shape[1]):
        h, state = lstm.lstm_step(params["lstm"], lm.embed(params, tok),
                                  state, jnp.float32)
        logits.append(np.asarray(lm.head_logits(params, h, cfg)))
        tok = toks[:, i]
    out[f"{tag}_logits"] = np.stack(logits)
np.savez(d + "/jax_out.npz", **out)
"""


@pytest.fixture(scope="module")
def greedy(tiny_corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("greedy")
    v = len(tiny_corpus.vocab)
    z = {k: np.asarray(a) for k, a in tiny_corpus.device_arrays().items()}
    z.update(song_ids=SONG_IDS.astype(np.int32),
             artist=tiny_corpus.song_artist[SONG_IDS[:, 0]].astype(np.int32),
             n_tok=np.int32(N_TOK))
    trees = {}
    for layers, mode in ROUTES:
        tag = f"{layers}_{mode}"
        tree = trees[tag] = _tree(layers, v)
        for k in ("embed", "out_b", "out_proj"):
            z[f"{tag}_{k}"] = tree[k]
        for l, layer in enumerate(tree["lstm"]):
            for k, a in layer.items():
                z[f"{tag}_lstm{l}_{k}"] = a
    np.savez(d / "inputs.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, trees, dict(np.load(d / "jax_out.npz"))


def _episode(z):
    data = eps.put_corpus({k: z[k] for k in ("songs", "song_len",
                                             "artist_song_ids",
                                             "artist_num_songs")}, "cpu")
    return eps.gather_episode(data, torch.tensor(z["song_ids"]),
                              torch.tensor(z["artist"]), 2, 1)


@pytest.mark.parametrize("layers,mode", ROUTES)
def test_greedy_generate_matches_jax(greedy, layers, mode):
    z, trees, ref = greedy
    tag = f"{layers}_{mode}"
    v = trees[tag]["embed"].shape[0]
    cfg = Config(**{**_cfg_kw(layers, mode, v),
                    "max_len": z["songs"].shape[1]})
    params = params_from_numpy(trees[tag], "cpu")
    ep = _episode(z)
    rows = len(SONG_IDS) * (2 if mode == "mean_state" else 1)
    assert lstm_stack.stack_fused_supported(
        params.lstm, torch.float32, batch_rows=rows,
        eval_mode=True) == (layers == 2)
    gens = [sampling.row_generator(i, 1) for i in range(len(SONG_IDS))]
    toks = sampling.generate(params, ep.support, ep.support_len, gens, cfg)
    np.testing.assert_array_equal(toks.numpy(), ref[f"{tag}_toks"])

    with torch.no_grad():
        state = lm.support_state(params, ep.support, ep.support_len, cfg,
                                 eval_mode=True)
        np.testing.assert_allclose(torch.stack([h for h, _ in state]).numpy(),
                                   ref[f"{tag}_h"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(torch.stack([c for _, c in state]).numpy(),
                                   ref[f"{tag}_c"], rtol=0, atol=1e-4)
        tok = torch.full((len(SONG_IDS),), 1, dtype=torch.int64)
        jtoks = torch.tensor(ref[f"{tag}_toks"]).long()
        for i in range(N_TOK):
            h, state = lstm.lstm_step(params.lstm, lm.embed(params, tok),
                                      state, torch.float32)
            logits = lm.head_logits(params, h, cfg)
            np.testing.assert_allclose(logits.numpy(), ref[f"{tag}_logits"][i],
                                       rtol=0, atol=1e-4)
            tok = jtoks[:, i]


@pytest.mark.parametrize("temperature", [1.0, 0.3, "rows"])
@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8),
                                         (7, 0.6), (1, 0.0)])
def test_filtered_sample_matches_jax(temperature, top_k, top_p):
    rng = np.random.RandomState(5)
    b, v = 6, 50
    logits = (2.0 * rng.randn(b, v)).astype(np.float32)
    temp = (rng.uniform(0.2, 2.0, b).astype(np.float32)
            if temperature == "rows" else temperature)
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        noise = np.asarray(jax.random.gumbel(key, (b, v), jnp.float32))
        want = jsampling.filtered_sample(key, jnp.asarray(logits),
                                         jnp.asarray(temp), top_k, top_p)
        got = sampling.filtered_sample(torch.tensor(noise),
                                       torch.tensor(logits),
                                       torch.as_tensor(temp), top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filter_logits_keeps_the_right_set():
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0]])
    kept = sampling.filter_logits(logits, 0.5, top_k=2)
    # temperature first: the survivors carry logits / T
    assert torch.equal(kept[0, :2], torch.tensor([8.0, 6.0]))
    assert torch.isinf(kept[0, 2:]).all()
    # nucleus: p = softmax([4, 3, 2, 1, 0]) = .64, .24, .09, ...; 0.7 keeps 2
    kept = sampling.filter_logits(logits, 1.0, top_k=0, top_p=0.7)
    assert torch.isfinite(kept[0]).tolist() == [True, True, False, False,
                                                False]


def _small_model(layers=1, eos_bias=0.0, mode="mean_state"):
    v = 30
    tree = _tree(layers, v, seed=3)
    tree["out_b"][EOS] += eos_bias
    cfg = Config(**{**_cfg_kw(layers, mode, v), "top_k": 0,
                    "sample_tokens": 40})
    return params_from_numpy(tree, "cpu"), cfg, v


def _support(v, b, seed=6):
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, 10, (b, 2))
    sup = rng.randint(4, v, (b, 2, 10))
    sup[np.arange(10)[None, None] >= lens[..., None]] = PAD
    return torch.tensor(sup).long(), torch.tensor(lens).long()


def test_pad_after_eos_and_early_exit_is_exact():
    params, cfg, v = _small_model(eos_bias=4.0)
    sup, lens = _support(v, 6)
    gens = lambda: [sampling.row_generator(s, 1) for s in range(6)]  # noqa
    full = sampling.generate(params, sup, lens, gens(), cfg,
                             early_exit=False)
    early = sampling.generate(params, sup, lens, gens(), cfg)
    assert torch.equal(full, early)
    rows_with_eos = 0
    for row in full.tolist():
        if EOS in row:
            rows_with_eos += 1
            assert all(t == PAD for t in row[row.index(EOS) + 1:])
    assert rows_with_eos == 6


def test_row_depends_only_on_its_own_generator():
    params, cfg, v = _small_model(layers=2, mode="state")
    sup, lens = _support(v, 3)
    seeds = [11, 12, 13]
    batched = sampling.generate(
        params, sup, lens, [sampling.row_generator(s, 1) for s in seeds],
        cfg, temperature=torch.tensor([0.7, 1.3, 0.9]))
    alone = sampling.generate(
        params, sup[1:2], lens[1:2], [sampling.row_generator(12, 1)], cfg,
        temperature=torch.tensor([1.3]))
    assert torch.equal(batched[1], alone[0])
    swapped = sampling.generate(
        params, sup[[2, 1, 0]], lens[[2, 1, 0]],
        [sampling.row_generator(s, 1) for s in seeds[::-1]], cfg,
        temperature=torch.tensor([0.9, 1.3, 0.7]))
    assert torch.equal(swapped[[2, 1, 0]], batched)


# ---------------------------------------------------------------------------
# the cache head in the decode loop
# ---------------------------------------------------------------------------

# (model, support_mode): the LSTM in both support modes and the transformer;
# each with the static and the dynamic cache.  cell="scan" and the einsum
# attention on both sides: the kernels' parity is held elsewhere, and the
# JAX side then runs in this process without interpret mode.
CACHE_CASES = [(m, mode, dyn) for m, mode in (("lstm", "state"),
                                              ("lstm", "mean_state"),
                                              ("transformer", "state"))
               for dyn in (False, True)]
CACHE_V, CACHE_L, CACHE_B, CACHE_N = 40, 12, 4, 10
MIXED_TOL = 1e-4          # fp32, the same weights; only sum order differs
GAP = 1e-3                # a top-two gap above this decides greedy tokens


def _cache_cfg_kw(model, mode, dynamic):
    return dict(model=model, vocab_size=CACHE_V, max_len=CACHE_L,
                embed_dim=32, hidden_dim=64, num_layers=2, num_heads=2,
                batch_size=CACHE_B, support_size=2, query_size=1,
                cell="scan", prefix_flash=False, support_mode=mode,
                compute_dtype="float32", top_k=1, sample_tokens=CACHE_N,
                support_cache=True, cache_backoff="global", cache_calib=True,
                cache_calib_freq=True, cache_dynamic=dynamic)


def _cache_tree(cfg_kw, seed):
    """JAX init plus noise on every leaf (the gate and the calibration
    tables start at values that hide the mixture), as numpy."""
    from fewshot.models import lm as jlm
    from fewshot_torch.bridge import flatten, unflatten
    tree = jlm.init_lm(jax.random.PRNGKey(seed), JConfig(**cfg_kw), CACHE_V)
    rng = np.random.RandomState(seed)
    flat = {k: np.asarray(v, np.float32) for k, v in flatten(
        jax.tree.map(np.asarray, tree)).items()}
    for k, v in flat.items():
        flat[k] = (v + 0.3 * rng.randn(*v.shape)).astype(np.float32)
    return unflatten(flat)


def _jax_mixed_decode(tree, support, support_len, cfg):
    """JAX's greedy decode with the cache head, step by step from the JAX
    package's own pieces (sample_lstm / sample_transformer's one_step):
    (tokens [B, n], mixed log-probs [n, B, V])."""
    from fewshot.data.vocab import BOS as JBOS, EOS as JEOS, PAD as JPAD
    from fewshot.models import lm as jlm, lstm as jlstm
    from fewshot.models import transformer as jtfm
    params = jax.tree.map(jnp.asarray, tree)
    b, k_, l_ = support.shape
    ctx = jsampling._cache_ctx(params, support, support_len, cfg)
    dynamic = ctx[0] == "dynamic"
    if cfg.model == "lstm":
        state = jlm.support_state(params, support, support_len, cfg,
                                  eval_mode=True)

        def step(tok, i, state):
            return jlstm.lstm_step(params["lstm"], jlm.embed(params, tok),
                                   state, jnp.float32)
    else:
        prefix_len = k_ * l_
        state = jtfm.init_kv_cache(cfg, b, prefix_len + cfg.sample_tokens
                                   + 1)
        mask = (jnp.arange(l_) < support_len[..., None]).reshape(
            b, prefix_len)
        state = jtfm.prefill(params["transformer"], jlm.embed(
            params, support.reshape(b, prefix_len)), mask, state, cfg)

        def step(tok, i, state):
            return jtfm.transformer_step(params["transformer"],
                                         jlm.embed(params, tok), state,
                                         prefix_len + i, cfg)
    tok = jnp.full((b,), JBOS, jnp.int32)
    done = jnp.zeros((b,), bool)
    c_pre = jnp.zeros((b, CACHE_V), jnp.float32)
    n_pre = jnp.zeros((b, 1), jnp.float32)
    toks, mixed = [], []
    for i in range(cfg.sample_tokens):
        h, state = step(tok, i, state)
        logits = jlm.head_logits(params, h, cfg)
        log_cache = (jsampling._dynamic_log_cache(ctx, c_pre, n_pre)
                     if dynamic else ctx[1])
        m = jlm.cache_mixed_logp(params, logits, h, log_cache)
        mixed.append(np.asarray(m))
        nxt = jnp.where(done, JPAD, jnp.argmax(m, axis=-1).astype(jnp.int32))
        done = done | (nxt == JEOS)
        if dynamic:
            c_pre, n_pre = jsampling._count_emitted(c_pre, n_pre, nxt)
        toks.append(np.asarray(nxt))
        tok = nxt
    return np.stack(toks, axis=1), np.stack(mixed)


@pytest.fixture(scope="module", params=CACHE_CASES,
                ids=["-".join(map(str, c)) for c in CACHE_CASES])
def cache_decode(request):
    model, mode, dynamic = request.param
    kw = _cache_cfg_kw(model, mode, dynamic)
    tree = _cache_tree(kw, seed=3)
    rng = np.random.RandomState(11)
    support_len = rng.randint(3, CACHE_L + 1, (CACHE_B, 2))
    support = (rng.randint(3, CACHE_V, (CACHE_B, 2, CACHE_L))
               * (np.arange(CACHE_L) < support_len[..., None]))
    jcfg = JConfig(**kw)
    toks, mixed = _jax_mixed_decode(tree, jnp.asarray(support, jnp.int32),
                                    jnp.asarray(support_len, jnp.int32),
                                    jcfg)
    # the reconstruction is JAX's own greedy decode
    ref = jsampling.generate(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(support, jnp.int32),
                             jnp.asarray(support_len, jnp.int32),
                             jax.random.PRNGKey(0), jcfg, early_exit=False)
    np.testing.assert_array_equal(np.asarray(ref), toks)
    return kw, tree, support, support_len, toks, mixed


def test_cache_mixed_logp_matches_jax():
    from fewshot.models import lm as jlm
    kw = _cache_cfg_kw("lstm", "state", False)
    tree = _cache_tree(kw, seed=5)
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 7, CACHE_V).astype(np.float32) * 3
    hidden = rng.randn(3, 7, 64).astype(np.float32)
    log_cache = np.log(rng.dirichlet(np.ones(CACHE_V), (3, 7))).astype(
        np.float32)
    want = jlm.cache_mixed_logp(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(logits), jnp.asarray(hidden),
                                jnp.asarray(log_cache))
    got = lm.cache_mixed_logp(params_from_numpy(tree, "cpu"),
                              torch.tensor(logits), torch.tensor(hidden),
                              torch.tensor(log_cache))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.logsumexp(got, -1).detach().numpy(),
                               0.0, atol=1e-5)


def test_count_emitted_skips_pad_rows():
    c = torch.zeros(3, 6)
    n = torch.zeros(3, 1)
    for nxt in ([2, PAD, 5], [2, 4, PAD], [PAD, PAD, 5]):
        c, n = sampling._count_emitted(c, n, torch.tensor(nxt))
    want = torch.zeros(3, 6)
    want[0, 2] = 2
    want[1, 4] = 1
    want[2, 5] = 2
    assert torch.equal(c, want)
    assert n[:, 0].tolist() == [2.0, 1.0, 2.0]


def test_cache_head_decode_matches_jax(cache_decode, monkeypatch):
    """Fed JAX's greedy tokens, the port's decode loop samples from the
    same mixed log-probs at every step (1e-4, fp32); unpatched, its greedy
    tokens equal JAX's at every step until a row's top-two gap first falls
    to 1e-3 (a near tie may then break either way)."""
    kw, tree, support, support_len, jtoks, jmixed = cache_decode
    cfg = Config(**kw)
    params = params_from_numpy(tree, "cpu")
    sup = torch.tensor(support, dtype=torch.int64)
    slen = torch.tensor(support_len, dtype=torch.int64)
    gens = [torch.Generator().manual_seed(i) for i in range(CACHE_B)]
    got = sampling.generate(params, sup, slen, gens, cfg, early_exit=False)
    top2 = np.sort(jmixed, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]                    # [n, B]
    for r in range(CACHE_B):
        small = np.nonzero(gap[:, r] <= GAP)[0]
        upto = small[0] + 1 if len(small) else CACHE_N
        np.testing.assert_array_equal(got[r, :upto].numpy(),
                                      jtoks[r, :upto])
    seen = []

    def forced(noise, logits, temperature, top_k, top_p=0.0):
        seen.append(logits.clone())
        return torch.tensor(jtoks[:, len(seen) - 1], dtype=torch.int64)
    monkeypatch.setattr(sampling, "filtered_sample", forced)
    toks = sampling.generate(params, sup, slen, gens, cfg, early_exit=False)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    assert len(seen) == CACHE_N
    np.testing.assert_allclose(torch.stack(seen).numpy(), jmixed, rtol=0,
                               atol=MIXED_TOL)
