"""The port's neural-cache head, fused-head route, evaluation and unigram
floor against fewshot.models / fewshot.training / fewshot.models.unigram.

* each cache function (``support_counts``, ``cache_posterior_parts``,
  ``support_log_cache``, ``dynamic_cache_target_logp``,
  ``cache_token_nll`` on both sides of ONEHOT_VOCAB_MAX, ``cache_mix_stats``
  with ``lm_aux`` and ``resp_floor``), values and grads, against the JAX
  functions in this process: uniform and global backoff, calibration with
  and without the frequency term, counts past the calibration table;
* ``episodic_nll_stats``, value and grads, against ``jax.value_and_grad``:
  V > 1024 on the fused head+CE route (cell="pallas", the Pallas kernels in
  interpret mode, the port's twins) with and without the cache, V <= 1024
  on the ``cache_token_nll`` route, the dense large-V route (cell="scan"),
  aux and floor terms in train mode and forced off in eval mode;
* 3 train steps with the full cache stack (global backoff, calibration,
  dynamic cache, responsibility floor) at V=1100 on the fused route against
  ``fewshot.training.make_fed_train_step``;
* per-batch eval stats (``make_fed_eval_step``) and the unigram floor
  (``fit_global``, ``episodic_nll_stats``, ``lm_nll_stats``) on fixed
  episodes; ``evaluate`` and ``evaluate_unigram`` add their batches;
* the bridge round trip of the cache parameters (0-d ones included), their
  Adam moments and ``params.npz``.

Inputs come from numpy seeds: E=128, H=256 (the fused head needs a
128-aligned head width), 1 layer, B=4 episodes of K=Q=2 songs, L=12; each
artist draws its songs from its own 30 words, so the cache sees its query
words.  The Pallas side runs once for the file in a subprocess with
FEWSHOT_PALLAS_INTERPRET=1.  Tolerances, relative to each compared array's
largest magnitude, fp32: 1e-5 (the same arithmetic in another summation
order); the parameters after 3 Adam steps 1 % of the largest update (see
``test_train_steps_match_jax``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot.models import lm as jlm
from fewshot_torch import bridge, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.models import lm, unigram

REPO = Path(__file__).resolve().parent.parent
E, H, L, K, Q, B = 128, 256, 12, 2, 2, 4
V_BIG, V_SMALL = 1100, 40
REL = 1e-5
STEPS = 3
BASE = dict(max_len=L, embed_dim=E, hidden_dim=H, num_layers=1,
            compute_dtype="float32", batch_size=B, support_size=K,
            query_size=Q, support_mode="mean_state", data_parallel=False,
            lr=1e-3, cell="pallas")
FULL = dict(support_cache=True, cache_backoff="global", cache_calib=True,
            cache_dynamic=True)
# name: (vocab, head, config changes, eval_mode)
STATS = {
    "fused_plain": (V_BIG, "out_proj", {}, False),
    "fused_full_floor": (V_BIG, "out_proj",
                         dict(**FULL, cache_resp_floor=0.25), False),
    "fused_static_freq_aux": (V_BIG, "out_proj",
                              dict(support_cache=True, cache_calib=True,
                                   cache_calib_freq=True, cache_lm_aux=0.5),
                              False),
    "fused_untied_uniform_eval": (V_BIG, "out_w",
                                  dict(support_cache=True,
                                       tie_embeddings=False,
                                       cache_backoff="uniform",
                                       cache_lm_aux=0.5,
                                       cache_resp_floor=0.25), True),
    "small_static_aux_floor": (V_SMALL, "out_proj",
                               dict(support_cache=True, cache_calib=True,
                                    cache_lm_aux=0.5, cache_resp_floor=0.25),
                               False),
    "small_dynamic_uniform_eval": (V_SMALL, "out_proj",
                                   dict(support_cache=True,
                                        cache_backoff="uniform",
                                        cache_dynamic=True,
                                        cache_resp_floor=0.25), True),
    "dense_big_static_floor": (V_BIG, "out_proj",
                               dict(support_cache=True, cell="scan",
                                    cache_resp_floor=0.25), False),
}
TRAIN = {"fused_full_floor": (V_BIG, "out_proj",
                              dict(**FULL, cache_resp_floor=0.25))}

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
from fewshot.models import lm, unigram
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

def episode(v, i):
    return Episode(*(jnp.asarray(z[f"v{v}_ep{i}_{f}"]) for f in
                     ("support", "support_len", "query", "query_len",
                      "artist")))

for name, (v, kw, ev) in spec["stats"].items():
    cfg = Config(**{**spec["base"], "vocab_size": v, **kw})
    params = tree(f"stats_{name}:")
    if ev:
        total, count = training.make_fed_eval_step(cfg)(params, episode(v, 0))
    else:
        (total, count), grads = jax.value_and_grad(
            lambda p: lm.episodic_nll_stats(p, episode(v, 0), cfg),
            has_aux=True)(params)
        flat(grads, f"stats_{name}_grad:")
    out[f"stats_{name}_total"] = np.asarray(total)
    out[f"stats_{name}_count"] = np.asarray(count)

for name, (v, kw) in spec["train"].items():
    cfg = Config(**{**spec["base"], "vocab_size": v, **kw})
    params = tree(f"train_{name}:")
    opt = training.make_optimizer(cfg)
    state = training.TrainState(params, opt.init(params), jnp.int32(0),
                                jax.random.PRNGKey(0))
    step = training.make_fed_train_step(cfg)
    for i in range(spec["steps"]):
        state, m = step(state, episode(v, i))
        for k, x in m.items():
            out[f"train_{name}_{i}_{k}"] = np.asarray(x)
        if i == 0:
            adam = [s for s in jax.tree.leaves(
                state.opt_state,
                is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState)][0]
            out[f"train_{name}_after0_count"] = np.asarray(adam.count)
            flat(adam.mu, f"train_{name}_after0_mu:")
            flat(adam.nu, f"train_{name}_after0_nu:")
    flat(state.params, f"train_{name}_final:")

songs, lens = jnp.asarray(z["songs"]), jnp.asarray(z["song_len"])
glp = unigram.fit_global(songs, lens, jnp.asarray(z["pool"]), spec["v_uni"])
out["unigram_glp"] = np.asarray(glp)
for i in range(spec["steps"]):
    t, c = unigram.episodic_nll_stats(episode(spec["v_uni"], i), glp,
                                      spec["v_uni"])
    out[f"unigram_{i}"] = np.asarray([t, c])
np.savez(d + "/jax_out.npz", **out)
"""


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _tree(seed, v, head, cfg_kw):
    """A JAX parameter tree (numpy) with the cache groups cfg_kw asks for,
    away from their init values so every term is live."""
    rng = np.random.RandomState(seed)
    f = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    lim = np.sqrt(6.0 / (E + 5 * H))
    tree = {"embed": f(0.3, v, E), "out_b": f(0.1, v),
            "lstm": [{"wx": rng.uniform(-lim, lim, (E, 4 * H)).astype(
                          np.float32),
                      "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(
                          np.float32),
                      "b": f(0.1, 4 * H)}]}
    tree[head] = f(0.1, H, E) if head == "out_proj" else f(0.1, H, v)
    if cfg_kw.get("support_cache"):
        tree["cache_gate"] = {"w": f(0.1, H), "b": np.float32(-0.5)}
        if cfg_kw.get("cache_backoff", "global") == "global":
            tree["cache_prior"] = {
                "u": f(0.5, v), "log_s": np.float32(np.log(0.01 * v) + 0.3)}
        if cfg_kw.get("cache_calib"):
            c = np.arange(1, 33, dtype=np.float32)
            tree["cache_calib"] = {"t": np.log(c) + f(0.2, 32)}
            if cfg_kw.get("cache_calib_freq"):
                tree["cache_calib"]["a"] = f(0.3, 32)
    return tree


def _corpus(v, seed):
    """6 artists of 6 songs; artist a draws from its own 30 words."""
    rng = np.random.RandomState(seed)
    n_art, per = 6, 6
    words = [rng.choice(np.arange(3, v), 30, replace=False)
             for _ in range(n_art)]
    songs = np.zeros((n_art * per, L), np.int64)
    lens = rng.randint(2, L + 1, n_art * per)
    lens[3] = 1
    for s in range(n_art * per):
        songs[s, :lens[s]] = rng.choice(words[s // per], lens[s])
    ids = np.arange(n_art * per).reshape(n_art, per)
    return {"songs": songs, "song_len": lens, "artist_song_ids": ids,
            "artist_num_songs": np.full(n_art, per),
            "song_artist": np.repeat(np.arange(n_art), per)}


def _episode_arrays(corpus, seed) -> dict:
    rng = np.random.RandomState(seed)
    artists = rng.randint(0, len(corpus["artist_num_songs"]), B)
    ids = np.stack([rng.permutation(corpus["artist_song_ids"][a])[:K + Q]
                    for a in artists])
    toks, lens = corpus["songs"][ids], corpus["song_len"][ids]
    return {"support": toks[:, :K], "support_len": lens[:, :K],
            "query": toks[:, K:], "query_len": lens[:, K:],
            "artist": artists}


def _inputs() -> dict:
    z = {}
    for v in (V_BIG, V_SMALL):
        corpus = _corpus(v, seed=v)
        for i in range(STEPS):
            for k, a in _episode_arrays(corpus, 10 + i).items():
                z[f"v{v}_ep{i}_{k}"] = a.astype(np.int32)
        if v == V_SMALL:
            z["songs"] = corpus["songs"].astype(np.int32)
            z["song_len"] = corpus["song_len"].astype(np.int32)
            z["pool"] = np.arange(0, 24, dtype=np.int32)    # artists 0-3
    for i, (name, (v, head, kw, _)) in enumerate(sorted(STATS.items())):
        for k, a in bridge.flatten(_tree(i, v, head, kw)).items():
            z[f"stats_{name}:{k}"] = a
    for name, (v, head, kw) in TRAIN.items():
        for k, a in bridge.flatten(_tree(50, v, head, kw)).items():
            z[f"train_{name}:{k}"] = a
    return z


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_head")
    z = _inputs()
    np.savez(d / "inputs.npz", **z)
    spec = {"base": BASE, "steps": STEPS, "v_uni": V_SMALL,
            "stats": {n: (v, kw, ev) for n, (v, _, kw, ev) in STATS.items()},
            "train": {n: (v, kw) for n, (v, _, kw) in TRAIN.items()}}
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, dict(np.load(d / "jax_out.npz"))


def _sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _episode(z, v, i) -> eps.Episode:
    return eps.Episode(*(torch.tensor(z[f"v{v}_ep{i}_{f}"],
                                      dtype=torch.int64)
                         for f in ("support", "support_len", "query",
                                   "query_len", "artist")))


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _cfg(v, kw) -> Config:
    return Config(**{**BASE, "vocab_size": v, **kw})


# ---------------------------------------------------------------------------
# the cache functions, in this process
# ---------------------------------------------------------------------------

VARIANTS = {
    "uniform": dict(support_cache=True, cache_backoff="uniform"),
    "global": dict(support_cache=True),
    "calib_uniform": dict(support_cache=True, cache_backoff="uniform",
                          cache_calib=True),
    "calib_global": dict(support_cache=True, cache_calib=True),
    "calib_freq": dict(support_cache=True, cache_calib=True,
                       cache_calib_freq=True),
}
VF = 20            # a small vocabulary: counts run past the 32-slot table


def _skewed_support(seed, k=3, length=40):
    """[B, K, L] songs over VF words, one word at 40 %: counts past 32."""
    rng = np.random.RandomState(seed)
    p = np.full(VF - 3, 0.6 / (VF - 4))
    p[0] = 0.4
    toks = 3 + rng.choice(VF - 3, size=(B, k, length), p=p)
    lens = rng.randint(1, length + 1, (B, k))
    toks[np.arange(length)[None, None] >= lens[..., None]] = 0
    return toks.astype(np.int32), lens.astype(np.int32)


def _both_params(tree):
    """(JAX tree, port module) of one numpy tree; the port's leaves are
    leaf tensors that collect grads."""
    return (jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, "cpu"))


def _grads_close(jgrads, params, what=""):
    got = dict(params.named_parameters())
    for k, w in bridge.flatten(jgrads).items():
        g = got[k].grad
        _close(torch.zeros_like(got[k]) if g is None else g, w,
               what=f"{what} {k}")


def test_support_counts_matches_jax():
    toks, lens = _skewed_support(0)
    want = jlm.support_counts(jnp.asarray(toks), jnp.asarray(lens), VF)
    got = lm.support_counts(torch.tensor(toks).long(),
                            torch.tensor(lens).long(), VF)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.max()) > 32                    # past the table


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cache_posterior_matches_jax(variant):
    """cache_posterior_parts and support_log_cache, values and the grads of
    a weighted sum of the log-cache into every cache parameter."""
    kw = VARIANTS[variant]
    toks, lens = _skewed_support(1)
    jp, tp = _both_params(_tree(3, VF, "out_proj", kw))
    rng = np.random.RandomState(2)
    wts = rng.randn(B, VF).astype(np.float32)
    jparts = jlm.cache_posterior_parts(jp, jnp.asarray(toks),
                                       jnp.asarray(lens), VF)
    tparts = lm.cache_posterior_parts(tp, torch.tensor(toks).long(),
                                      torch.tensor(lens).long(), VF)
    for k, g, w in zip(("phi", "total", "s", "p_global"), tparts, jparts):
        _close(g, w, what=k)

    def jloss(p):
        return jnp.sum(jlm.support_log_cache(p, jnp.asarray(toks),
                                             jnp.asarray(lens), VF) * wts)
    jval, jgrads = jax.value_and_grad(jloss)(jp)
    tval = (lm.support_log_cache(tp, torch.tensor(toks).long(),
                                 torch.tensor(lens).long(), VF)
            * torch.tensor(wts)).sum()
    _close(tval, jval, what="log_cache")
    if tval.requires_grad:          # uniform, uncalibrated: no parameters
        tval.backward()
    _grads_close(jgrads, tp, variant)


@pytest.mark.parametrize("variant", ["uniform", "calib_freq"])
def test_dynamic_cache_target_logp_matches_jax(variant):
    toks, lens = _skewed_support(4)
    q_toks, q_lens = _skewed_support(5, k=1, length=L)
    _, targets, mask = jlm.shift_targets(jnp.asarray(q_toks[:, 0]),
                                         jnp.asarray(q_lens[:, 0]))
    jp, tp = _both_params(_tree(6, VF, "out_proj", VARIANTS[variant]))
    wts = np.random.RandomState(7).randn(B, L - 1).astype(np.float32)

    def jfn(p):
        parts = jlm.cache_posterior_parts(p, jnp.asarray(toks),
                                          jnp.asarray(lens), VF)
        return jlm.dynamic_cache_target_logp(*parts, targets, mask)
    want, vjp = jax.vjp(jfn, jp)
    (jgrads,) = vjp(jnp.asarray(wts))
    parts = lm.cache_posterior_parts(tp, torch.tensor(toks).long(),
                                     torch.tensor(lens).long(), VF)
    got = lm.dynamic_cache_target_logp(
        *parts, torch.tensor(np.asarray(targets)).long(),
        torch.tensor(np.asarray(mask)))
    _close(got, want, what="dynamic")
    if got.requires_grad:
        (got * torch.tensor(wts)).sum().backward()
    _grads_close(jgrads, tp, variant)


@pytest.mark.parametrize("v", [VF, V_BIG])
@pytest.mark.parametrize("aux,floor", [(0.0, 0.0), (0.5, 0.0), (0.0, 0.25),
                                       (0.5, 0.25)])
def test_cache_token_nll_matches_jax(v, aux, floor):
    """Both branches around ONEHOT_VOCAB_MAX; grads into the logits, the
    hidden states, the log-cache and the gate."""
    rng = np.random.RandomState(8)
    rows = 3
    logits = (2.0 * rng.randn(rows, L - 1, v)).astype(np.float32)
    hidden = rng.randn(rows, L - 1, H).astype(np.float32)
    log_cache = np.log(rng.dirichlet(np.ones(v), rows)).astype(np.float32)
    targets = rng.randint(0, v, (rows, L - 1))
    mask = np.arange(L - 1)[None] < np.array([[L - 1], [4], [1]])
    jp = {"cache_gate": {"w": jnp.asarray(0.1 * rng.randn(H), jnp.float32),
                         "b": jnp.float32(-0.3)}}

    def jfn(p, lg, hd, lc):
        return jlm.cache_token_nll(p, lg, hd, lc, jnp.asarray(targets),
                                   jnp.asarray(mask), aux, floor)
    (jtotal, jcount), jgrads = jax.value_and_grad(
        lambda *a: jfn(*a), argnums=(0, 1, 2, 3), has_aux=True)(
        jp, jnp.asarray(logits), jnp.asarray(hidden), jnp.asarray(log_cache))
    gate_w = torch.tensor(np.asarray(jp["cache_gate"]["w"]))
    params = lm.LM(torch.zeros(v, E), torch.nn.ModuleList(),
                       torch.zeros(v),
                       cache_gate={"w": gate_w, "b": torch.tensor(-0.3)})
    ins = [torch.tensor(a, requires_grad=True)
           for a in (logits, hidden, log_cache)]
    total, count = lm.cache_token_nll(params, *ins,
                                      torch.tensor(targets).long(),
                                      torch.tensor(mask), aux, floor)
    total.backward()
    _close(total, jtotal, what="total")
    assert float(count) == float(jcount)
    for k, g, w in zip(("logits", "hidden", "log_cache"), ins, jgrads[1:]):
        _close(g.grad, w, what=k)
    _close(params.cache_gate.w.grad, jgrads[0]["cache_gate"]["w"])
    _close(params.cache_gate.b.grad, jgrads[0]["cache_gate"]["b"])


# ---------------------------------------------------------------------------
# the episodic loss, train steps, eval and the unigram floor (Pallas side in
# interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(STATS))
def test_episodic_nll_stats_matches_jax(case, name):
    z, ref = case
    v, _, kw, ev = STATS[name]
    cfg = _cfg(v, kw)
    params = bridge.params_from_numpy(
        bridge.unflatten(_sub(z, f"stats_{name}:")), "cpu")
    assert lm.fused_head_eligible(params, cfg, v) == (
        name.startswith("fused"))
    ep = _episode(z, v, 0)
    if ev:
        total, count = training.make_fed_eval_step(cfg)(params, ep)
    else:
        total, count = lm.episodic_nll_stats(params, ep, cfg)
        total.backward()
        want = _sub(ref, f"stats_{name}_grad:")
        got = dict(params.named_parameters())
        assert set(got) == set(want)
        for k, w in want.items():
            _close(got[k].grad, w, what=k)
    _close(total, ref[f"stats_{name}_total"], what="total")
    assert float(count) == float(ref[f"stats_{name}_count"])


def test_eval_mode_drops_the_aux_and_floor_terms(case):
    """The same episode in train mode (aux and floor on) and eval mode: eval
    reports the pure mixture, which equals a config without the terms."""
    z, _ = case
    v, _, kw, _ = STATS["small_static_aux_floor"]
    params = bridge.params_from_numpy(
        bridge.unflatten(_sub(z, "stats_small_static_aux_floor:")), "cpu")
    ep = _episode(z, v, 0)
    cfg = _cfg(v, kw)
    pure = dataclasses.replace(cfg, cache_lm_aux=0.0, cache_resp_floor=0.0)
    with torch.no_grad():
        ev = lm.episodic_nll_stats(params, ep, cfg, eval_mode=True)[0]
        tr = lm.episodic_nll_stats(params, ep, cfg)[0]
        want = lm.episodic_nll_stats(params, ep, pure)[0]
    assert float(ev) == float(want)
    assert float(tr) != float(want)          # lm_aux moves the train value


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_steps_match_jax(case, name):
    """Loss, tokens and grad norm of each step, Adam's moments after the
    first (the gradients, to 1e-5), and the parameters after three.  Those
    are held to 1 % of the largest update (lr x steps): elements whose
    gradient lies below the fp32 summation noise of their leaf (~1e-8 of
    its largest) get a noisy Adam direction, since Adam divides each
    element by its own RMS (measured: 3e-3 of the largest update)."""
    z, ref = case
    v, _, kw = TRAIN[name]
    cfg = _cfg(v, kw)
    params = bridge.params_from_numpy(
        bridge.unflatten(_sub(z, f"train_{name}:")), "cpu")
    state = training.TrainState(params, training.make_optimizer(cfg).init(
        params), 0, torch.Generator())
    step = training.make_fed_train_step(cfg)
    for i in range(STEPS):
        state, m = step(state, _episode(z, v, i))
        for k in ("loss", "tokens", "grad_norm"):
            _close(m[k], ref[f"train_{name}_{i}_{k}"], what=f"{i} {k}")
        if i == 0:
            for mom in ("mu", "nu"):
                want = _sub(ref, f"train_{name}_after0_{mom}:")
                got = getattr(state.opt_state, mom)
                assert set(got) == set(want)
                for k, w in want.items():
                    _close(got[k], w, what=f"{mom} {k}")
    final = bridge.flatten(bridge.params_to_numpy(state.params))
    want = _sub(ref, f"train_{name}_final:")
    assert set(final) == set(want)
    for k, w in want.items():
        err = float(np.abs(final[k] - w).max())
        assert err <= 1e-2 * cfg.lr * STEPS, (k, err)
    assert final["cache_gate.b"].shape == ()


def test_eval_and_unigram_stats_match_jax(case):
    """Per-batch eval stats on fixed episodes (the fused, eval-mode case
    above covers the network) and the unigram floor: the global fit on a
    song pool, then the Dirichlet posterior per episode; ``evaluate`` and
    ``evaluate_unigram`` add the same per-batch stats."""
    z, ref = case
    songs = torch.tensor(z["songs"]).long()
    lens = torch.tensor(z["song_len"]).long()
    glp = unigram.fit_global(songs, lens, torch.tensor(z["pool"]).long(),
                             V_SMALL)
    _close(glp, ref["unigram_glp"], what="glp")
    for i in range(STEPS):
        t, c = unigram.episodic_nll_stats(_episode(z, V_SMALL, i), glp,
                                          V_SMALL)
        _close(t, ref[f"unigram_{i}"][0], what=f"unigram {i}")
        assert float(c) == float(ref[f"unigram_{i}"][1])
    # the global unigram on a plain batch of songs (task: lm)
    from fewshot.models import unigram as junigram
    jt, jc = junigram.lm_nll_stats(jnp.asarray(z["songs"][:8]),
                                   jnp.asarray(z["song_len"][:8]),
                                   jnp.asarray(ref["unigram_glp"]))
    t, c = unigram.lm_nll_stats(songs[:8], lens[:8], glp)
    _close(t, jt, what="lm unigram")
    assert float(c) == float(jc)


def _corpus_obj(v):
    c = _corpus(v, seed=v)

    class Packed:                      # what evaluate_unigram reads
        song_artist = c["song_artist"]
        splits = {"train": np.arange(4), "val": np.array([4, 5])}
        vocab = range(v)

        @staticmethod
        def device_arrays():
            return c
    return Packed


def test_evaluate_adds_its_batches():
    """evaluate and evaluate_unigram: the mean over num_episodes //
    batch_size batches drawn from the generator, read once."""
    corpus = _corpus_obj(V_SMALL)
    data = eps.put_corpus(corpus, "cpu")
    val = torch.tensor(corpus.splits["val"])
    cfg = _cfg(V_SMALL, dict(support_cache=True, cache_calib=True))
    params = lm.init_lm(cfg, V_SMALL, torch.Generator().manual_seed(0),
                        "cpu")
    got = training.evaluate(cfg, params, data, val,
                            torch.Generator().manual_seed(5),
                            num_episodes=3 * B)
    step = training.make_eval_step(cfg, data, val)
    gen = torch.Generator().manual_seed(5)
    stats = [step(params, gen) for _ in range(3)]
    want = float(sum(t for t, _ in stats)) / float(sum(c for _, c in stats))
    assert abs(got - want) <= 1e-6 * abs(want)
    floor = unigram.evaluate_unigram(cfg, corpus, data, val,
                                     torch.Generator().manual_seed(5),
                                     num_episodes=2 * B)
    pool = torch.tensor(eps.split_song_pool(corpus, "train")).long()
    assert pool.tolist() == list(range(24))
    glp = unigram.fit_global(data.songs, data.song_len, pool, V_SMALL)
    ustep = unigram.make_unigram_eval_step(cfg, data, val, V_SMALL)
    gen = torch.Generator().manual_seed(5)
    stats = [ustep(glp, gen) for _ in range(2)]
    want = float(sum(t for t, _ in stats)) / float(sum(c for _, c in stats))
    assert abs(floor - want) <= 1e-6 * abs(want)
    assert np.isfinite(got) and np.isfinite(floor)


def test_bridge_round_trip_with_cache(case, tmp_path):
    """The cache parameters and their Adam moments (0-d leaves included)
    through the bridge and params.npz, exactly."""
    z, ref = case
    name = sorted(TRAIN)[0]
    tree = bridge.unflatten(_sub(z, f"train_{name}:"))
    assert set(tree) >= {"cache_gate", "cache_prior", "cache_calib"}
    params = bridge.params_from_numpy(tree, "cpu")
    assert params.cache_gate.b.shape == () and \
        params.cache_prior.log_s.shape == ()
    bridge.save_params(params, tmp_path / "params.npz")
    back = bridge.flatten(bridge.params_to_numpy(
        bridge.load_params(tmp_path / "params.npz", "cpu")))
    flat = bridge.flatten(tree)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    pre = f"train_{name}_after0"
    mu = bridge.unflatten(_sub(ref, pre + "_mu:"))
    nu = bridge.unflatten(_sub(ref, pre + "_nu:"))
    st = bridge.adam_state_from_numpy(ref[pre + "_count"], mu, nu, "cpu")
    assert st.mu["cache_prior.log_s"].shape == ()
    assert set(st.mu) == {k for k, _ in params.named_parameters()}
    count, mu2, nu2 = bridge.adam_state_to_numpy(st)
    assert count == 1
    for a, b in ((mu, mu2), (nu, nu2)):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
