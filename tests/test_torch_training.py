"""The port's train step against fewshot.training on the same episodes.

* ``episodic_nll_stats``: value and grads in both support modes
  (``mean_state`` on the fused stack, ``state`` per layer), against
  ``jax.value_and_grad`` of the JAX function;
* the whole train step against ``fewshot.training.make_fed_train_step``
  (``data_parallel=False``) fed the same three episodes from the same
  parameters: loss, tokens and grad_norm of every step and the parameters
  after 3 Adam steps, on the per-layer route (1 layer, a clip threshold the
  gradients cross) and the fused route (2 layers, warm-up);
* the Adam-state bridge: the port continues a JAX run from its state after
  one step (parameters and optax's ScaleByAdamState) and lands on the JAX
  run's parameters after three; the numpy round trip is exact;
* the optimizer alone against optax (clip, Adam, AdamW, SGD, warm-up);
* the on-device sampler's semantics: artists from the split, distinct songs
  of the artist, the with-replacement overflow for short artists.

Inputs come from numpy seeds: E=64, H=128, a V=40 corpus of L=12 token
songs with ragged lengths (one of length 1), K=Q=2, nonzero initial state
through the support pass.  24 episodes per batch, so that the query and
support passes have >= 512 rows and take the embedding fold, as the bench
config does.  The JAX side runs once for the file, in a subprocess, with
the Pallas kernels in interpret mode (cell="pallas" on both sides; the
port's wrappers run their plain twins on the CPU).

Tolerances, relative to each compared array's largest magnitude: fp32 1e-5
(the same arithmetic; only the order of fp32 sums differs: matmuls, the
embedding gather's scatter-add against JAX's one-hot product, db).  The
parameters after Adam steps: 5e-5.  Adam divides each element's gradient by
that element's own RMS, so an element whose gradient is ~1000x below its
leaf's largest carries its share of the 1e-5 summation noise into its
update at ~1e-3 relative (measured: 1.8e-5 of the leaf's max on lstm.0.wh
of the per-layer case, whose updates are ~1e-3).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch import bridge, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps

REPO = Path(__file__).resolve().parent.parent
E, H, V, L, K, Q, B = 64, 128, 40, 12, 2, 2, 24
REL = 1e-5
PARAM_REL = 5e-5        # parameters after Adam steps (module docstring)
BASE = dict(vocab_size=V, max_len=L, embed_dim=E, hidden_dim=H, cell="pallas",
            compute_dtype="float32", batch_size=B, support_size=K,
            query_size=Q, data_parallel=False, lr=1e-3)
STATS = {"mean_state_fused": dict(support_mode="mean_state", num_layers=2),
         "state_per_layer": dict(support_mode="state", num_layers=1)}
TRAIN = {"per_layer_clip": dict(support_mode="mean_state", num_layers=1,
                                grad_clip=0.05),
         "fused_warmup": dict(support_mode="state", num_layers=2,
                              warmup_steps=2, grad_clip=1.0)}
STEPS = 3

_JAX_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import optax
from fewshot import training
from fewshot.config import Config
from fewshot.data.episodes import Episode
from fewshot.models import lm
from fewshot_torch.bridge import flatten, unflatten

d = sys.argv[1]
spec = json.load(open(d + "/spec.json"))
z = dict(np.load(d + "/inputs.npz"))
out = {}

def tree(prefix):
    return jax.tree.map(jnp.asarray, unflatten(
        {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}))

def flat(t, prefix):
    for k, v in flatten(t).items():
        out[prefix + k] = np.asarray(v)

def episode(i):
    return Episode(*(jnp.asarray(z[f"ep{i}_{f}"]) for f in
                     ("support", "support_len", "query", "query_len",
                      "artist")))

def adam_of(opt_state):
    return [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]

for name, kw in spec["stats"].items():
    cfg = Config(**spec["base"], **kw)
    params = tree(f"params{kw['num_layers']}:")
    (total, count), grads = jax.value_and_grad(
        lambda p: lm.episodic_nll_stats(p, episode(0), cfg),
        has_aux=True)(params)
    out[f"stats_{name}_total"] = np.asarray(total)
    out[f"stats_{name}_count"] = np.asarray(count)
    flat(grads, f"stats_{name}_grad:")

for name, kw in spec["train"].items():
    cfg = Config(**spec["base"], **kw)
    params = tree(f"params{kw['num_layers']}:")
    opt = training.make_optimizer(cfg)
    state = training.TrainState(params, opt.init(params), jnp.int32(0),
                                jax.random.PRNGKey(0))
    step = training.make_fed_train_step(cfg)
    for i in range(spec["steps"]):
        state, m = step(state, episode(i))
        for k, v in m.items():
            out[f"train_{name}_{i}_{k}"] = np.asarray(v)
        if i == 0:
            flat(state.params, f"train_{name}_after0:")
            adam = adam_of(state.opt_state)
            out[f"train_{name}_after0_count"] = np.asarray(adam.count)
            flat(adam.mu, f"train_{name}_after0_mu:")
            flat(adam.nu, f"train_{name}_after0_nu:")
    flat(state.params, f"train_{name}_final:")
np.savez(d + "/jax_out.npz", **out)
"""


def _params(seed, layers):
    """A JAX LSTM tree (numpy) with a tied head through out_proj."""
    rng = np.random.RandomState(seed)
    f = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    tree = {"embed": f(0.3, V, E), "out_b": f(0.1, V),
            "out_proj": f(0.1, H, E), "lstm": []}
    in_dim = E
    for _ in range(layers):
        lim = np.sqrt(6.0 / (in_dim + 5 * H))
        tree["lstm"].append({
            "wx": rng.uniform(-lim, lim, (in_dim, 4 * H)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(np.float32),
            "b": f(0.1, 4 * H)})
        in_dim = H
    return tree


def _corpus(seed=3):
    """Packed-corpus arrays: 6 artists, one with fewer than K+Q songs."""
    rng = np.random.RandomState(seed)
    counts = np.array([6, 3, 8, 5, 7, 4])
    n = int(counts.sum())
    lens = rng.randint(2, L + 1, n)
    lens[4] = 1
    songs = np.zeros((n, L), np.int64)
    for s in range(n):
        songs[s, :lens[s]] = rng.randint(3, V, lens[s])
    ids = np.full((len(counts), counts.max()), -1, np.int64)
    start = 0
    for a, c in enumerate(counts):
        ids[a, :c] = np.arange(start, start + c)
        start += c
    return {"songs": songs, "song_len": lens, "artist_song_ids": ids,
            "artist_num_songs": counts}


def _episode_ids(seed, corpus):
    """[B, K+Q] song ids and [B] artists drawn with numpy (distinct songs;
    a short artist repeats songs past its count)."""
    rng = np.random.RandomState(seed)
    artists = rng.randint(0, len(corpus["artist_num_songs"]), B)
    ids = np.zeros((B, K + Q), np.int64)
    for r, a in enumerate(artists):
        row = corpus["artist_song_ids"][a][:corpus["artist_num_songs"][a]]
        take = rng.permutation(len(row))[:K + Q]
        while len(take) < K + Q:
            take = np.append(take, rng.randint(len(row)))
        ids[r] = row[take]
    return ids, artists


def _inputs() -> dict:
    corpus = _corpus()
    z = {}
    for layers in (1, 2):
        for k, v in bridge.flatten(_params(layers, layers)).items():
            z[f"params{layers}:{k}"] = v
    for i in range(STEPS):
        ids, artists = _episode_ids(10 + i, corpus)
        toks, lens = corpus["songs"][ids], corpus["song_len"][ids]
        z[f"ep{i}_support"] = toks[:, :K].astype(np.int32)
        z[f"ep{i}_support_len"] = lens[:, :K].astype(np.int32)
        z[f"ep{i}_query"] = toks[:, K:].astype(np.int32)
        z[f"ep{i}_query_len"] = lens[:, K:].astype(np.int32)
        z[f"ep{i}_artist"] = artists.astype(np.int32)
    return z


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("training")
    z = _inputs()
    np.savez(d / "inputs.npz", **z)
    (d / "spec.json").write_text(json.dumps(
        {"base": BASE, "stats": STATS, "train": TRAIN, "steps": STEPS}))
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, dict(np.load(d / "jax_out.npz"))


def _sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _episode(z, i) -> eps.Episode:
    return eps.Episode(*(torch.tensor(z[f"ep{i}_{f}"], dtype=torch.int64)
                         for f in ("support", "support_len", "query",
                                   "query_len", "artist")))


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _cfg(kw) -> Config:
    return Config(**BASE, **kw)


def _state(cfg, tree) -> training.TrainState:
    params = bridge.params_from_numpy(bridge.unflatten(tree), "cpu")
    return training.TrainState(params, training.make_optimizer(cfg).init(
        params), 0, torch.Generator())


@pytest.mark.parametrize("name", sorted(STATS))
def test_episodic_nll_stats_matches_jax(case, name):
    """Value and grads; in mean_state mode the support pass's top-layer
    outputs are unused, so its grads arrive only through the final state
    (mean over K, repeat over Q)."""
    z, ref = case
    kw = STATS[name]
    cfg = _cfg(kw)
    params = bridge.params_from_numpy(
        bridge.unflatten(_sub(z, f"params{kw['num_layers']}:")), "cpu")
    from fewshot_torch.models import lm
    total, count = lm.episodic_nll_stats(params, _episode(z, 0), cfg)
    total.backward()
    _close(total, ref[f"stats_{name}_total"], what="total")
    assert float(count) == float(ref[f"stats_{name}_count"])
    want = _sub(ref, f"stats_{name}_grad:")
    got = dict(params.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k].grad, w, what=k)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_step_matches_jax(case, name):
    z, ref = case
    kw = TRAIN[name]
    cfg = _cfg(kw)
    state = _state(cfg, _sub(z, f"params{kw['num_layers']}:"))
    step = training.make_fed_train_step(cfg)
    norms = []
    for i in range(STEPS):
        state, m = step(state, _episode(z, i))
        for k in ("loss", "tokens", "grad_norm"):
            _close(m[k], ref[f"train_{name}_{i}_{k}"], what=f"{i} {k}")
        norms.append(float(m["grad_norm"]))
    # the cases exercise what they name
    if "clip" in name:
        assert min(norms) > cfg.grad_clip
    else:
        assert cfg.warmup_steps > 0 and max(norms) < cfg.grad_clip
    assert state.step == STEPS and int(state.opt_state.count) == STEPS
    final = bridge.flatten(bridge.params_to_numpy(state.params))
    want = _sub(ref, f"train_{name}_final:")
    assert set(final) == set(want)
    for k, w in want.items():
        _close(final[k], w, PARAM_REL, what=k)


def test_port_continues_a_jax_run(case):
    """Parameters and ScaleByAdamState after the JAX run's first step,
    bridged into the port: its next two steps land on the JAX run's
    parameters after three (warm-up: the count drives the schedule too)."""
    z, ref = case
    name = "fused_warmup"
    cfg = _cfg(TRAIN[name])
    pre = f"train_{name}_after0"
    params = bridge.params_from_numpy(
        bridge.unflatten(_sub(ref, pre + ":")), "cpu")
    opt_state = bridge.adam_state_from_numpy(
        ref[pre + "_count"], bridge.unflatten(_sub(ref, pre + "_mu:")),
        bridge.unflatten(_sub(ref, pre + "_nu:")), "cpu")
    state = training.TrainState(params, opt_state, 1, torch.Generator())
    step = training.make_fed_train_step(cfg)
    for i in range(1, STEPS):
        state, _ = step(state, _episode(z, i))
    final = bridge.flatten(bridge.params_to_numpy(state.params))
    for k, w in _sub(ref, f"train_{name}_final:").items():
        _close(final[k], w, PARAM_REL, what=k)


def test_adam_state_bridge_round_trip(case):
    _, ref = case
    pre = "train_per_layer_clip_after0"
    mu = bridge.unflatten(_sub(ref, pre + "_mu:"))
    nu = bridge.unflatten(_sub(ref, pre + "_nu:"))
    st = bridge.adam_state_from_numpy(ref[pre + "_count"], mu, nu, "cpu")
    assert int(st.count) == 1 and st.count.dtype == torch.int64
    count, mu2, nu2 = bridge.adam_state_to_numpy(st)
    assert count == 1 and count.dtype == np.int32
    for a, b in ((mu, mu2), (nu, nu2)):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam", grad_clip=0.5),
    dict(optimizer="adam", grad_clip=0.0, weight_decay=0.1),
    dict(optimizer="sgd", grad_clip=100.0, warmup_steps=3),
    dict(optimizer="adam", grad_clip=1.0, warmup_steps=2, lr=3e-3),
], ids=["adam_clipped", "adamw", "sgd_warmup", "adam_warmup"])
def test_optimizer_matches_optax(kw):
    """Four updates of random gradients, the clip crossed or not, against
    the JAX package's own optax chain (make_optimizer)."""
    import jax.numpy as jnp
    import optax
    from fewshot import training as jtraining
    from fewshot.config import Config as JConfig
    cfg_kw = {**BASE, **kw}
    rng = np.random.RandomState(4)
    tree = _params(7, 1)
    jparams = {k: ([{w: jnp.asarray(a) for w, a in l.items()} for l in v]
                   if k == "lstm" else jnp.asarray(v))
               for k, v in tree.items()}
    jopt = jtraining.make_optimizer(JConfig(**cfg_kw))
    jstate = jopt.init(jparams)
    cfg = Config(**cfg_kw)
    params = bridge.params_from_numpy(tree, "cpu")
    opt = training.make_optimizer(cfg)
    state = opt.init(params)
    for i in range(4):
        scale = 0.05 if i % 2 else 1.0       # below and above the clip
        g = {k: (scale * rng.randn(*v.shape)).astype(np.float32)
             for k, v in bridge.flatten(tree).items()}
        jg = {k: ([{w: jnp.asarray(g[f"lstm.{n}.{w}"]) for w in l}
                   for n, l in enumerate(v)] if k == "lstm"
                  else jnp.asarray(g[k])) for k, v in tree.items()}
        upd, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = {k: torch.tensor(v) for k, v in g.items()}
        opt.update_(tg, state, params, training.global_norm(tg))
        _close(training.global_norm(tg), optax.global_norm(jg))
    got = bridge.flatten(bridge.params_to_numpy(params))
    want = bridge.flatten({k: ([{w: np.asarray(a) for w, a in l.items()}
                                for l in v] if k == "lstm" else np.asarray(v))
                           for k, v in jparams.items()})
    for k in want:
        _close(got[k], want[k], what=k)


def test_sample_episode_semantics():
    """Artists come from the split; an artist with >= K+Q songs gives K+Q
    distinct songs of its own; a short artist gives all its songs first and
    then repeats its own songs; lengths and tokens are the corpus rows."""
    c = _corpus()
    data = eps.put_corpus(c, "cpu")
    split = torch.tensor([1, 2, 5])           # artist 1 has 3 < K+Q songs
    gen = torch.Generator().manual_seed(0)
    owner = {int(s): a for a, row in enumerate(c["artist_song_ids"])
             for s in row if s >= 0}
    seen = set()
    for _ in range(20):
        ep = eps.sample_episode(gen, data, split, 16, k=K, q=Q)
        assert ep.support.shape == (16, K, L) and ep.query.shape == (16, Q, L)
        tokens = torch.cat([ep.support, ep.query], dim=1)
        lens = torch.cat([ep.support_len, ep.query_len], dim=1)
        for r in range(16):
            a = int(ep.artist[r])
            assert a in (1, 2, 5)
            seen.add(a)
            n = int(c["artist_num_songs"][a])
            songs = [int(np.flatnonzero((c["songs"] == tokens[r, i].numpy())
                                        .all(1) & (c["song_len"]
                                                   == int(lens[r, i])))[0])
                     for i in range(K + Q)]
            assert all(owner[s] == a for s in songs)
            head = songs[:min(n, K + Q)]
            assert len(set(head)) == len(head)          # distinct
            if n < K + Q:
                assert set(head) == set(range(
                    int(c["artist_song_ids"][a][0]),
                    int(c["artist_song_ids"][a][0]) + n))
    assert seen == {1, 2, 5}


def test_sample_episode_is_uniform_over_songs():
    """Every song of an artist is picked at about the same rate."""
    c = _corpus()
    data = eps.put_corpus(c, "cpu")
    gen = torch.Generator().manual_seed(1)
    ep = eps.sample_episode(gen, data, torch.tensor([2]), 4000, k=K, q=Q)
    # artist 2 owns songs 9..16 (8 songs); 4 distinct per row
    toks = torch.cat([ep.support, ep.query], 1).reshape(-1, L)
    ids = [int(np.flatnonzero((c["songs"] == t.numpy()).all(1))[0])
           for t in toks[:4000]]
    counts = np.bincount(ids, minlength=17)[9:17]
    assert counts.sum() == 4000
    assert counts.min() > 0.8 * 500 and counts.max() < 1.2 * 500


def test_sample_lm_batch_draws_from_the_pool():
    c = _corpus()
    data = eps.put_corpus(c, "cpu")
    pool = torch.tensor([0, 4, 9])
    toks, lens = eps.sample_lm_batch(torch.Generator().manual_seed(2), data,
                                     pool, 64)
    assert toks.shape == (64, L) and lens.shape == (64,)
    for t, n in zip(toks, lens):
        s = int(np.flatnonzero((c["songs"] == t.numpy()).all(1)
                               & (c["song_len"] == int(n)))[0])
        assert s in (0, 4, 9)


def test_train_step_samples_on_device_and_learns():
    """make_train_step samples its own episodes (CPU here), returns tensor
    metrics, and the loss falls over a few steps at a high learning rate;
    init_train_state without device raises when no card is visible."""
    c = _corpus()
    data = eps.put_corpus(c, "cpu")
    cfg = dataclasses.replace(_cfg(dict(support_mode="mean_state",
                                        num_layers=1)), lr=1e-2,
                              batch_size=8)
    state = training.init_train_state(cfg, V, device="cpu")
    step = training.make_multi_step(
        training.make_train_step(cfg, data, torch.tensor([0, 2, 3, 4])), 3)
    losses = []
    for _ in range(4):
        state, m = step(state)
        assert isinstance(m["loss"], torch.Tensor)
        losses.append(float(m["loss"]))
    assert state.step == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            training.init_train_state(cfg, V)


def test_training_later_slices_raise():
    """Dropout in training and finetune once raised; now both run.
    Dropout: with the same keep masks on both sides (both packages'
    ``dropout`` applying numpy masks in call order) the train-mode loss
    and grads (the port's kernel route, twins here; JAX's scan cell) equal
    JAX's, on the 528-row batch where the embedding fold is eligible and
    dropout must skip it.  Finetune (cell='scan'; the
    kernel route is refused, as JAX's outer grad fails there): equal to
    JAX's.  An 1100-word model with a 128-wide untied head, where the JAX
    package scores with its fused head+CE kernels, runs both routes: the
    fused one (cell='pallas', the kernels' twins here) equals the dense one
    (cell='scan') in value and grads."""
    import jax
    import jax.numpy as jnp
    from fewshot.config import Config as JConfig
    from fewshot.data.episodes import Episode as JEpisode
    from fewshot.models import lm as jlm
    from fewshot_torch.models import lm
    z = _inputs()
    ep = _episode(z, 0)
    jep = JEpisode(*(jnp.asarray(z[f"ep0_{f}"], jnp.int32) for f in (
        "support", "support_len", "query", "query_len", "artist")))
    shapes = {"jax": [], "port": []}

    def masks(side):
        def apply(x, rate, src):
            if src is None or rate <= 0.0:
                return x
            rng = np.random.RandomState(len(shapes[side]))
            shapes[side].append(tuple(int(d) for d in x.shape))
            keep = rng.rand(*x.shape) < 1.0 - rate
            if side == "jax":
                return jnp.where(jnp.asarray(keep), x / (1.0 - rate), 0.0)
            return torch.where(torch.as_tensor(keep), x / (1.0 - rate),
                               x.new_zeros(()))
        return apply

    saved = (jlm.dropout, lm.dropout)
    jlm.dropout, lm.dropout = masks("jax"), masks("port")
    try:
        for kw in (dict(dropout=0.3),
                   dict(support_mode="finetune", cell="scan",
                        inner_steps=1, inner_lr=0.1)):
            kw = {**BASE, "num_layers": 1, **kw}
            params = bridge.params_from_numpy(_params(1, 1), "cpu")
            (jt, _), jg = jax.jit(jax.value_and_grad(
                lambda p: jlm.episodic_nll_stats(
                    p, jep, JConfig(**{**kw, "cell": "scan"}),
                    dropout_key=jax.random.PRNGKey(0)),
                has_aux=True))(jax.tree.map(jnp.asarray, _params(1, 1)))
            total, _ = lm.episodic_nll_stats(params, ep, Config(**kw),
                                             drop=torch.Generator())
            total.backward()
            _close(total, jt, what="total")
            want = bridge.flatten(jax.tree.map(np.asarray, jg))
            for k, p in params.named_parameters():
                _close(p.grad, want[k], what=k)
    finally:
        jlm.dropout, lm.dropout = saved
    assert shapes["jax"] == shapes["port"] == [(48, 11, E), (48, 11, H)]
    rng = np.random.RandomState(5)
    big = {k: v for k, v in _params(1, 1).items() if k != "out_proj"}
    big["embed"] = (0.3 * rng.randn(1100, E)).astype(np.float32)
    big["out_b"] = (0.1 * rng.randn(1100)).astype(np.float32)
    big["out_w"] = (0.1 * rng.randn(H, 1100)).astype(np.float32)
    cfg = _cfg(dict(num_layers=1, tie_embeddings=False))
    out = {}
    for cell in ("pallas", "scan"):
        model = bridge.params_from_numpy(big, "cpu")
        c = dataclasses.replace(cfg, cell=cell)
        assert lm.fused_head_eligible(model, c, 1100) == (cell == "pallas")
        total, count = lm.episodic_nll_stats(model, ep, c)
        total.backward()
        out[cell] = (total, count, {k: p.grad for k, p in
                                    model.named_parameters()})
    _close(out["pallas"][0], out["scan"][0].detach())
    assert float(out["pallas"][1]) == float(out["scan"][1])
    for k, g in out["scan"][2].items():
        _close(out["pallas"][2][k], g, what=k)
