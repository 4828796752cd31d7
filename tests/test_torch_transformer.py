"""The port's episodic transformer (fewshot_torch/models/transformer.py and
its branches in models/lm.py, sampling.py, bridge.py) against
fewshot.models.transformer / fewshot.models.lm / fewshot.training /
fewshot.sampling.

* ``transformer_prefix_forward`` (prefix_flash on: the prefix-attention
  twins, the Pallas kernels in interpret mode on the JAX side; and off: the
  einsum paths), 2 layers;
* ``episodic_nll_stats``, value and grads of every parameter, against
  ``jax.value_and_grad``: the fused head+CE route with and without the
  full cache stack, the dense head with the static cache, the einsum
  attention path, support_mode none (``transformer_forward``, with
  cfg.flash off and on: the port's no-prefix route against JAX's einsum
  off the TPU, equal at every position the loss reads), bf16, and remat
  (``jax.checkpoint`` against ``torch.utils.checkpoint``), fp32 and bf16;
* 3 train steps with the full cache stack against
  ``fewshot.training.make_fed_train_step``, and the port continuing the
  JAX run from its parameters and Adam state after one step;
* greedy ``generate`` (KV-cache prefill and decode) token for token
  against ``fewshot.sampling.generate`` under state and none;
* the bridge round trip of the transformer tree and ``params.npz``.

Inputs come from numpy seeds: E=128, nh=2 (hd=64), 2 layers, B=2 episodes
of K=Q=2 songs, L=12, V=1100 (the fused head needs V > 1024 and a
128-aligned width); one query song has length 1, so its first row has no
real key.  The JAX side runs once for the file in a subprocess with
FEWSHOT_PALLAS_INTERPRET=1.  Tolerances, relative to each compared array's
largest magnitude, fp32: 2e-5 (the same arithmetic in another summation
order, through two layers and the cache head); parameters after 3 Adam
steps 1 % of the largest update where the first gradient is resolved
(``_params_close``).  bf16: both
sides round at the same points, but an fp32 sum in another order can flip
a bf16 rounding (2^-8), which later layers carry: the loss is held to 1e-3
and the grads to 5e-2.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch import bridge, sampling, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.models import lm, transformer as tfm

REPO = Path(__file__).resolve().parent.parent
E, NH, LAYERS, L, K, Q, B, V = 128, 2, 2, 12, 2, 2, 2, 1100
STEPS, N_TOK = 3, 8
REL = 2e-5
BASE = dict(model="transformer", vocab_size=V, max_len=L, embed_dim=E,
            num_heads=NH, num_layers=LAYERS, compute_dtype="float32",
            batch_size=B, support_size=K, query_size=Q,
            support_mode="mean_state", data_parallel=False, lr=1e-3,
            cell="pallas")
FULL = dict(support_cache=True, cache_backoff="global", cache_calib=True,
            cache_dynamic=True)
# name: (config changes, relative tolerance of the total, of the grads)
STATS = {
    "fused_full": (FULL, REL, REL),
    "fused_plain": ({}, REL, REL),
    "dense_static": (dict(support_cache=True, cell="scan"), REL, REL),
    "einsum_full": (dict(**FULL, prefix_flash=False), REL, REL),
    "none_fused": (dict(support_mode="none"), REL, REL),
    "none_flash": (dict(support_mode="none", flash=True), REL, REL),
    "state_bf16": (dict(support_mode="state", compute_dtype="bfloat16",
                        **FULL), 1e-3, 5e-2),
    # remat on both sides (jax.checkpoint; the port's torch.utils.checkpoint)
    "with_remat_fused_full": (dict(FULL, remat=True), REL, REL),
    "with_remat_state_bf16": (dict(support_mode="state", remat=True,
                                   compute_dtype="bfloat16", **FULL),
                              1e-3, 5e-2),
}
GREEDY = ("state", "none")

_JAX_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
import optax
from fewshot import sampling, training
from fewshot.config import Config
from fewshot.data.episodes import Episode
from fewshot.models import lm, transformer as tfm
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

params = tree("plain:")
ep = episode(0)
for flash in (True, False) if not spec["train"] else ():
    cfg = Config(**{**spec["base"], "prefix_flash": flash})
    b, k_, sl = ep.support.shape
    _, targets, mask = lm.shift_targets(ep.query, ep.query_len)
    prefix = ep.support.reshape(b, k_ * sl)
    pmask = (jnp.arange(sl) < ep.support_len[..., None]).reshape(b, k_ * sl)
    q_in = ep.query[..., :-1]
    hidden = jax.jit(lambda p: tfm.transformer_prefix_forward(
        p["transformer"], lm.embed(p, prefix), pmask, lm.embed(p, q_in),
        mask, cfg))(params)
    out[f"prefix_forward_{flash}"] = np.asarray(hidden)

for name, kw in spec["stats"].items() if not spec["train"] else ():
    cfg = Config(**{**spec["base"], **kw})
    p = tree(f"stats_{name}:")
    (total, count), grads = jax.jit(jax.value_and_grad(
        lambda p: lm.episodic_nll_stats(p, ep, cfg), has_aux=True))(p)
    flat(grads, f"stats_{name}_grad:")
    out[f"stats_{name}_total"] = np.asarray(total)
    out[f"stats_{name}_count"] = np.asarray(count)
if not spec["train"]:
    np.savez(d + "/jax_out.npz", **out)
    sys.exit()
out = {}

cfg = Config(**{**spec["base"], **spec["full"]})
p = tree("train:")
opt = training.make_optimizer(cfg)
state = training.TrainState(p, opt.init(p), jnp.int32(0),
                            jax.random.PRNGKey(0))
step = training.make_fed_train_step(cfg)
for i in range(spec["steps"]):
    state, m = step(state, episode(i))
    for k, x in m.items():
        out[f"train_{i}_{k}"] = np.asarray(x)
    if i == 0:
        adam = [s for s in jax.tree.leaves(
            state.opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        out["train_after0_count"] = np.asarray(adam.count)
        flat(adam.mu, "train_after0_mu:")
        flat(adam.nu, "train_after0_nu:")
        flat(state.params, "train_after0:")
flat(state.params, "train_final:")

for mode in spec["greedy"]:
    cfg = Config(**{**spec["base"], "support_mode": mode, "top_k": 1})
    toks = sampling.generate(params, ep.support, ep.support_len,
                             jax.random.PRNGKey(0), cfg, spec["n_tok"])
    out[f"greedy_{mode}"] = np.asarray(toks)
np.savez(d + "/jax_out.npz", **out)
"""



# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _tree(seed, kw) -> dict:
    """A JAX transformer LM tree (numpy) with the cache groups kw asks for,
    away from init values so every term is live."""
    rng = np.random.RandomState(seed)
    f = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa

    def glorot(n, m):
        lim = np.sqrt(6.0 / (n + m))
        return rng.uniform(-lim, lim, (n, m)).astype(np.float32)
    layers = [{"ln1": 1.0 + f(0.1, E), "wqkv": glorot(E, 3 * E),
               "wo": glorot(E, E), "ln2": 1.0 + f(0.1, E),
               "w1": glorot(E, 4 * E), "w2": glorot(4 * E, E)}
              for _ in range(LAYERS)]
    tree = {"embed": f(0.3, V, E), "out_b": f(0.1, V),
            "transformer": {"layers": layers, "ln_f": 1.0 + f(0.1, E)}}
    if kw.get("support_cache"):
        tree["cache_gate"] = {"w": f(0.1, E), "b": np.float32(-0.5)}
        if kw.get("cache_backoff", "global") == "global":
            tree["cache_prior"] = {
                "u": f(0.5, V), "log_s": np.float32(np.log(0.01 * V) + 0.3)}
        if kw.get("cache_calib"):
            c = np.arange(1, 33, dtype=np.float32)
            tree["cache_calib"] = {"t": np.log(c) + f(0.2, 32)}
    return tree


def _episodes() -> dict:
    """STEPS fixed episodes; each artist draws from its own 30 words."""
    rng = np.random.RandomState(7)
    n_art, per = 4, 6
    words = [rng.choice(np.arange(3, V), 30, replace=False)
             for _ in range(n_art)]
    songs = np.zeros((n_art * per, L), np.int64)
    lens = rng.randint(2, L + 1, n_art * per)
    for s in range(n_art * per):
        songs[s, :lens[s]] = rng.choice(words[s // per], lens[s])
    z = {}
    for i in range(STEPS):
        artists = rng.randint(0, n_art, B)
        ids = np.stack([a * per + rng.permutation(per)[:K + Q]
                        for a in artists])
        toks, ln = songs[ids], lens[ids].copy()
        if i == 0:
            ln[1, K] = 1          # a query song with no target
        for k, a in (("support", toks[:, :K]), ("support_len", ln[:, :K]),
                     ("query", toks[:, K:]), ("query_len", ln[:, K:]),
                     ("artist", artists)):
            z[f"ep{i}_{k}"] = a.astype(np.int32)
    return z


def _inputs() -> dict:
    z = _episodes()
    for i, (name, (kw, _, _)) in enumerate(sorted(STATS.items())):
        for k, a in bridge.flatten(_tree(i, kw)).items():
            z[f"stats_{name}:{k}"] = a
    for k, a in bridge.flatten(_tree(50, FULL)).items():
        z[f"train:{k}"] = a
    for k, a in bridge.flatten(_tree(60, {})).items():
        z[f"plain:{k}"] = a
    return z


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX side in two subprocesses started together: the forward and
    loss cases, then the train steps and greedy decoding."""
    z = _inputs()
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    procs = []
    for train in (False, True):
        d = tmp_path_factory.mktemp(f"transformer_{int(train)}")
        np.savez(d / "inputs.npz", **z)
        spec = {"base": BASE, "full": FULL, "steps": STEPS, "n_tok": N_TOK,
                "greedy": GREEDY, "train": train,
                "stats": {n: kw for n, (kw, _, _) in STATS.items()}}
        (d / "spec.json").write_text(json.dumps(spec))
        procs.append((d, subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, str(d)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ref = {}
    for d, proc in procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        ref.update(np.load(d / "jax_out.npz"))
    return z, ref


def _sub(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _params(z, prefix):
    return bridge.params_from_numpy(bridge.unflatten(_sub(z, prefix)), "cpu")


def _episode(z, i) -> eps.Episode:
    return eps.Episode(*(torch.tensor(z[f"ep{i}_{f}"], dtype=torch.int64)
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


def _cfg(**kw) -> Config:
    return Config(**{**BASE, **kw})


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False])
def test_prefix_forward_matches_jax(case, flash):
    z, ref = case
    params = _params(z, "plain:")
    ep = _episode(z, 0)
    cfg = _cfg(prefix_flash=flash)
    _, _, mask = lm.shift_targets(ep.query, ep.query_len)
    prefix = ep.support.reshape(B, K * L)
    pmask = (torch.arange(L) < ep.support_len[..., None]).reshape(B, K * L)
    hidden = tfm.transformer_prefix_forward(
        params.transformer, lm.embed(params, prefix), pmask,
        lm.embed(params, ep.query[..., :-1]), mask, cfg)
    _close(hidden, ref[f"prefix_forward_{flash}"], what="hidden")


@pytest.mark.parametrize("name", sorted(STATS))
def test_episodic_nll_stats_matches_jax(case, name):
    z, ref = case
    kw, tol_total, tol_grad = STATS[name]
    cfg = _cfg(**kw)
    params = _params(z, f"stats_{name}:")
    assert lm.fused_head_eligible(params, cfg, V) == (cfg.cell == "pallas")
    total, count = lm.episodic_nll_stats(params, _episode(z, 0), cfg)
    total.backward()
    _close(total, ref[f"stats_{name}_total"], tol_total, "total")
    assert float(count) == float(ref[f"stats_{name}_count"])
    want = _sub(ref, f"stats_{name}_grad:")
    got = dict(params.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k].grad, w, tol_grad, k)


def _params_close(final, ref, lr):
    """The parameters after STEPS Adam steps against JAX's.  An element
    whose first gradient lies below the fp32 summation noise of its leaf
    (1e-5 of the leaf's largest) gets a noisy Adam direction (Adam divides
    by the element's own RMS; measured: one element of a leaf, with
    gradients 4e-7 of the largest and opposite signs in the two runs), so
    it is held to the most Adam moves an element, 2 lr a step; every other
    element to 1 % of the largest update (lr x steps)."""
    g0 = _sub(ref, "train_after0_mu:")
    want = _sub(ref, "train_final:")
    assert set(final) == set(want)
    for k, w in want.items():
        err = np.abs(final[k] - w)
        resolved = np.abs(g0[k]) > 1e-5 * np.abs(g0[k]).max()
        assert float(err.max()) <= 2 * lr * STEPS, (k, float(err.max()))
        assert float(np.where(resolved, err, 0.0).max()) <= \
            1e-2 * lr * STEPS, (k, float(err.max()))


def test_train_steps_match_jax(case):
    """Loss, tokens and grad norm of each step, Adam's moments after the
    first, and the parameters after three (``_params_close``)."""
    z, ref = case
    cfg = _cfg(**FULL)
    params = _params(z, "train:")
    state = training.TrainState(params, training.make_optimizer(cfg).init(
        params), 0, torch.Generator())
    step = training.make_fed_train_step(cfg)
    for i in range(STEPS):
        state, m = step(state, _episode(z, i))
        for k in ("loss", "tokens", "grad_norm"):
            _close(m[k], ref[f"train_{i}_{k}"], what=f"{i} {k}")
        if i == 0:
            for mom in ("mu", "nu"):
                want = _sub(ref, f"train_after0_{mom}:")
                got = getattr(state.opt_state, mom)
                assert set(got) == set(want)
                for k, w in want.items():
                    _close(got[k], w, what=f"{mom} {k}")
    _params_close(bridge.flatten(bridge.params_to_numpy(state.params)), ref,
                  cfg.lr)


def test_port_continues_a_jax_run(case):
    """The JAX run's parameters and ScaleByAdamState after its first step,
    bridged into the port: the port's next two steps land on the JAX
    run's parameters after three."""
    z, ref = case
    cfg = _cfg(**FULL)
    params = _params(ref, "train_after0:")
    opt_state = bridge.adam_state_from_numpy(
        ref["train_after0_count"],
        bridge.unflatten(_sub(ref, "train_after0_mu:")),
        bridge.unflatten(_sub(ref, "train_after0_nu:")), "cpu")
    assert set(opt_state.mu) == {k for k, _ in params.named_parameters()}
    state = training.TrainState(params, opt_state, 1, torch.Generator())
    step = training.make_fed_train_step(cfg)
    for i in range(1, STEPS):
        state, _ = step(state, _episode(z, i))
    _params_close(bridge.flatten(bridge.params_to_numpy(state.params)), ref,
                  cfg.lr)


@pytest.mark.parametrize("mode", GREEDY)
def test_greedy_generate_matches_jax(case, mode):
    """The KV-cache prefill (the no-prefix twin) and the decode steps emit
    JAX's tokens, token for token."""
    z, ref = case
    params = _params(z, "plain:")
    ep = _episode(z, 0)
    cfg = _cfg(support_mode=mode, top_k=1)
    toks = sampling.generate(params, ep.support, ep.support_len,
                             [sampling.row_generator(s, 1) for s in range(B)],
                             cfg, N_TOK)
    np.testing.assert_array_equal(toks.numpy(), ref[f"greedy_{mode}"])


def test_prefill_fills_the_cache_as_the_decode_steps_do(case):
    """The prefix prefilled through the kernels' twin holds the K/V that
    one cached step per position writes (the einsum decode attention)."""
    z, _ = case
    params = _params(z, "plain:")
    cfg = _cfg(support_mode="state")
    ep = _episode(z, 0)
    fast = tfm.init_kv_cache(cfg, B, K * L)
    slow = tfm.init_kv_cache(cfg, B, K * L)
    with torch.no_grad():
        x = lm.embed(params, ep.support.reshape(B, K * L))
        tfm.prefill(params.transformer, x, None, fast, cfg)
        for i in range(K * L):
            tfm.transformer_step(params.transformer, x[:, i], slow, i, cfg)
    assert bool(slow["valid"].all()) and bool(fast["valid"].all())
    for k in ("k", "v"):
        _close(fast[k], slow[k].numpy(), what=k)


def test_bridge_round_trip_of_the_transformer(case, tmp_path):
    """The transformer tree by its flat names (transformer.layers.N.wqkv),
    through the port and params.npz, exactly; init_lm builds the same
    tree as the JAX package (names and shapes)."""
    z, _ = case
    tree = bridge.unflatten(_sub(z, "stats_fused_full:"))
    assert isinstance(tree["transformer"]["layers"], list)
    params = bridge.params_from_numpy(tree, "cpu")
    assert "transformer.layers.1.wqkv" in dict(params.named_parameters())
    bridge.save_params(params, tmp_path / "params.npz")
    back = bridge.flatten(bridge.params_to_numpy(
        bridge.load_params(tmp_path / "params.npz", "cpu")))
    flat = bridge.flatten(tree)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    ours = lm.init_lm(_cfg(**FULL), V, torch.Generator().manual_seed(0),
                      "cpu")
    assert {k: v.shape for k, v in bridge.flatten(
        bridge.params_to_numpy(ours)).items()} == \
        {k: v.shape for k, v in flat.items()}


def test_remat_is_a_later_slice(case):
    """remat was refused before it was ported; now it runs: the port's
    remat grads equal its no-remat grads bit for bit on the remat case's
    weights, and JAX's remat grads within REL."""
    z, ref = case
    ep = _episode(z, 0)
    out = {}
    for remat in (False, True):
        params = _params(z, "stats_with_remat_fused_full:")
        total, _ = lm.episodic_nll_stats(params, ep, _cfg(**FULL,
                                                          remat=remat))
        total.backward()
        out[remat] = {k: p.grad for k, p in params.named_parameters()}
    want = _sub(ref, "stats_with_remat_fused_full_grad:")
    for k, g in out[False].items():
        assert torch.equal(out[True][k], g), k
        _close(out[True][k], want[k], REL, k)
