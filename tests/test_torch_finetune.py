"""The port's finetune variant (fewshot_torch/models/lm.py
``finetune_episodic_nll_stats``, sampling.py's finetune branch) against
fewshot's on bridged weights (mirrors tests/test_finetune.py).

* the loss and the outer gradients of every parameter, for first_order
  true and false, without the cache head and with the static and the
  dynamic cache stack, 2 LSTM layers; one transformer case;
* zero inner steps equal no adaptation (support_mode none), with and
  without the cache stack; adaptation lowers the query NLL when the query
  repeats the support;
* three train steps against ``fewshot.training.make_fed_train_step`` on the
  same episodes (loss and grad norm of each step, the parameters after);
  the fused train step and ``training.evaluate`` (under no_grad: the inner
  loop differentiates anyway) run on a tiny corpus;
* greedy finetune sampling equal to JAX's token for token, with and
  without the cache, and the FewShotModel facade and the serving batcher
  on it;
* cell='pallas' is refused (the kernels' backward has no derivative; JAX's
  outer grad fails there too).

Small sizes: E=16, H=24, V=64, B=3, K=Q=2, L=9 with ragged lengths, fp32,
cell='scan' (the shipped config's).  Tolerances, relative to each compared
array's largest magnitude: 2e-5 for the loss and the grads (the same
arithmetic in another order of fp32 sums, through two inner SGD steps),
1e-4 for the parameters after three Adam steps (Adam divides by each
element's own RMS).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot import sampling as jsampling
from fewshot import training as jtraining
from fewshot.config import Config as JConfig
from fewshot.data.episodes import Episode as JEpisode
from fewshot.models import lm as jlm
from fewshot_torch import bridge, sampling, serve, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.models import lm
from fewshot_torch.models.base import FewShotModel

V, B, K, Q, L = 64, 3, 2, 2, 9
REL = 2e-5
PARAM_REL = 1e-4
KW = dict(vocab_size=V, max_len=12, embed_dim=16, hidden_dim=24,
          num_layers=2, batch_size=B, support_size=K, query_size=Q,
          support_mode="finetune", inner_steps=2, inner_lr=0.5,
          data_parallel=False, cell="scan")
STATIC = dict(support_cache=True, cache_backoff="global", cache_calib=True)
DYNAMIC = dict(STATIC, cache_calib_freq=True, cache_dynamic=True)
CASES = {
    "fomaml": {},
    "maml": dict(first_order=False),
    "fomaml_static_cache": STATIC,
    "maml_dynamic_cache": dict(DYNAMIC, first_order=False),
    "fomaml_dynamic_cache": DYNAMIC,
    "transformer": dict(model="transformer", num_heads=2, embed_dim=16),
}


def _episode_np(seed=0, b=B):
    rng = np.random.RandomState(seed)
    return (rng.randint(4, V, (b, K, L)), rng.randint(5, L + 1, (b, K)),
            rng.randint(4, V, (b, Q, L)), rng.randint(4, L + 1, (b, Q)),
            np.zeros((b,), np.int64))


def _jep(arrs):
    return JEpisode(*(jnp.asarray(a, jnp.int32) for a in arrs))


def _tep(arrs):
    return eps.Episode(*(torch.tensor(a, dtype=torch.int64) for a in arrs))


def _pair(change, seed=1):
    """(JAX config, port config, JAX params, the same params in the port)."""
    jcfg, tcfg = JConfig(**{**KW, **change}), Config(**{**KW, **change})
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg, V)
    return jcfg, tcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        what, float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_outer_grads_match_jax(name):
    jcfg, tcfg, jp, tp = _pair(CASES[name])
    arrs = _episode_np()
    (jt, jc), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.episodic_nll_stats(p, _jep(arrs), jcfg),
        has_aux=True))(jp)
    tt, tc = lm.episodic_nll_stats(tp, _tep(arrs), tcfg)
    tt.backward()
    _close(tt, jt, what="total")
    assert float(tc) == float(jc)
    want = bridge.flatten(jax.tree.map(np.asarray, jg))
    got = dict(tp.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k].grad, w, what=k)


def test_first_and_second_order_grads_differ():
    """The MAML gradient runs through the inner gradients: another
    outer gradient than FOMAML's on the same loss."""
    arrs = _episode_np(2)
    grads = {}
    for fo in (True, False):
        _, tcfg, _, tp = _pair(dict(first_order=fo))
        total, _ = lm.episodic_nll_stats(tp, _tep(arrs), tcfg)
        total.backward()
        grads[fo] = tp.lstm[0].wh.grad
    assert not torch.allclose(grads[True], grads[False])


@pytest.mark.parametrize("cache", [{}, STATIC, DYNAMIC])
def test_zero_inner_steps_equals_no_adaptation(cache):
    _, tcfg, _, tp = _pair(dict(cache, inner_steps=0), seed=5)
    ep = _tep(_episode_np(6))
    a = lm.episodic_nll_stats(tp, ep, tcfg)
    b = lm.episodic_nll_stats(tp, ep, dataclasses.replace(
        tcfg, support_mode="none"))
    _close(a[0], b[0].detach(), 1e-6, "total")
    assert float(a[1]) == float(b[1])


def test_adaptation_helps_when_query_repeats_support():
    _, tcfg, _, tp = _pair({}, seed=1)
    sup, slen, _, _, art = _episode_np(3)
    ep = _tep((sup, slen, sup, slen, art))
    with torch.no_grad():
        n0 = lm.episodic_nll(tp, ep, dataclasses.replace(tcfg,
                                                         inner_steps=0))
        n2 = lm.episodic_nll(tp, ep, tcfg)
    assert float(n2) < float(n0)


def test_train_steps_match_jax_fed_step():
    """Three Adam steps on the same three episodes from the same
    parameters: each step's loss and grad norm, and the parameters."""
    change = dict(DYNAMIC, cache_resp_floor=0.25, lr=1e-2)
    jcfg, tcfg, jp, tp = _pair(change, seed=3)
    jstep = jtraining.make_fed_train_step(jcfg)
    jstate = jtraining.TrainState(
        jp, jtraining.make_optimizer(jcfg).init(jp), jnp.int32(0),
        jax.random.PRNGKey(0))
    tstate = training.TrainState(tp, training.make_optimizer(tcfg).init(tp),
                                 0, torch.Generator())
    tstep = training.make_fed_train_step(tcfg)
    for i in range(3):
        arrs = _episode_np(10 + i)
        jstate, jm = jstep(jstate, _jep(arrs))
        tstate, tm = tstep(tstate, _tep(arrs))
        _close(tm["loss"], jm["loss"], what=f"loss {i}")
        _close(tm["grad_norm"], jm["grad_norm"], 1e-4, f"grad_norm {i}")
    want = bridge.flatten(jax.tree.map(np.asarray, jstate.params))
    for k, p in tstate.params.named_parameters():
        _close(p, want[k], PARAM_REL, k)


@pytest.fixture(scope="module")
def corpus():
    """The port's copy of conftest's tiny_corpus: 8 artists x 6 songs."""
    from fewshot_torch.data.corpus import PackedCorpus
    from fewshot_torch.data.lyrics import tokenize_corpus
    rng = np.random.RandomState(7)
    words = [f"w{i}" for i in range(30)]
    rows = []
    for a in range(8):
        prefs = rng.dirichlet(np.ones(len(words)))
        for s in range(6):
            text = " ".join(rng.choice(words, size=rng.randint(8, 20),
                                       p=prefs))
            rows.append((f"artist_{a}", f"song_{s}", text))
    vocab, items = tokenize_corpus(rows, vocab_size=V)
    return PackedCorpus.pack(items, vocab, max_len=24, seed=0)


def test_meta_training_and_evaluation_run(corpus):
    cfg = Config(**{**KW, "batch_size": 4, "max_len": 24})
    data = eps.put_corpus(corpus, "cpu")
    split = {s: torch.as_tensor(corpus.splits[s], dtype=torch.int64)
             for s in ("train", "val")}
    state = training.init_train_state(cfg, V, device="cpu")
    step = training.make_train_step(cfg, data, split["train"])
    losses = []
    for _ in range(15):
        state, m = step(state)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    val = [training.evaluate(cfg, state.params, data, split["val"],
                             torch.Generator().manual_seed(7),
                             num_episodes=8) for _ in range(2)]
    assert np.isfinite(val[0]) and val[0] == val[1]


@pytest.mark.parametrize("cache", [{}, DYNAMIC])
def test_greedy_sampling_matches_jax(cache):
    """top_k=1 on both sides (each step's argmax); the seeds give no near
    tie, so the rows agree token for token."""
    change = dict(cache, num_layers=1, top_k=1, sample_tokens=10,
                  inner_lr=0.05)
    jcfg, tcfg, jp, tp = _pair(change, seed=0)
    rng = np.random.RandomState(0)
    sup = rng.randint(4, V, (3, K, 10))
    slen = np.array([[10, 7], [9, 10], [10, 10]])
    want = np.asarray(jsampling.generate(
        jp, jnp.asarray(sup, jnp.int32), jnp.asarray(slen, jnp.int32),
        jax.random.PRNGKey(1), jcfg))
    gens = [sampling.row_generator(i, 1) for i in range(3)]
    got = sampling.generate(tp, torch.tensor(sup), torch.tensor(slen), gens,
                            tcfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) > 1      # the supports matter


def test_facade_and_serving_run(corpus):
    cfg = Config(**{**KW, **DYNAMIC, "batch_size": 2, "max_len": 24,
                    "sample_tokens": 6, "eval_episodes": 4})
    model = FewShotModel(cfg, corpus, device="cpu")
    assert np.isfinite(model.train(2))
    assert np.isfinite(model.eval(num_episodes=4))
    toks, artists = model.sample_artist(split="train", num=2)
    assert toks.shape == (2, 6) and len(artists) == 2
    gen = serve.Generator(cfg, corpus, model.state.params,
                          batch_size=2, device="cpu")
    try:
        outs = gen.generate(num=2, split="train", episode_seed=3)
    finally:
        gen.close()
    assert len(outs) == 2 and all(0 < o["tokens"] <= 6 for o in outs)


@pytest.mark.parametrize("change", [dict(cell="pallas"),
                                    dict(model="transformer", flash=True)])
def test_kernel_backbones_are_refused(change):
    cfg = Config(**{**KW, **change})
    with pytest.raises(ValueError, match="finetune"):
        lm.init_lm(cfg, V, torch.Generator().manual_seed(0), "cpu")
