"""The port's model layer against fewshot.models on bridged weights.

Both packages get the same parameter tree (made with numpy from a seed) and
the same inputs; the port's results must match the JAX package's in fp32
to 1e-5 (the same arithmetic; only summation order differs).  The port's
kernel route (cell="pallas", which runs the kernels' plain twins on the
CPU) is held against the JAX scan cell, whose agreement with the JAX
Pallas kernels tests/test_pallas.py pins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot.config import Config as JConfig
from fewshot.data.episodes import Episode as JEpisode
from fewshot.models import lm as jlm
from fewshot.models import lstm as jlstm
from fewshot_torch import sampling, serve
from fewshot_torch.bridge import (flatten, load_params, params_from_numpy,
                                  params_to_numpy, save_params)
from fewshot_torch.config import Config
from fewshot_torch.data.episodes import Episode
from fewshot_torch.models import lm, lstm

E, H, V = 32, 128, 40
ATOL = 1e-5
KW = dict(vocab_size=64, max_len=24, embed_dim=E, hidden_dim=H,
          num_layers=2, batch_size=4, support_size=3, query_size=1)


def _tree(seed=0, layers=2, e=E, h=H, v=V, head="out_proj"):
    rng = np.random.RandomState(seed)
    f = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    tree = {"embed": f(0.5, v, e), "out_b": f(0.1, v), "lstm": []}
    in_dim = e
    for _ in range(layers):
        lim = np.sqrt(6.0 / (in_dim + 5 * h))
        tree["lstm"].append({
            "wx": rng.uniform(-lim, lim, (in_dim, 4 * h)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (h, 4 * h)).astype(np.float32),
            "b": f(0.1, 4 * h)})
        in_dim = h
    if head == "out_proj":
        tree["out_proj"] = f(0.1, h, e)
    elif head == "out_w":
        tree["out_w"] = f(0.1, h, v)
    return tree


def _jax(tree):
    return {k: ([{kk: jnp.asarray(vv) for kk, vv in l.items()} for l in v]
                if k == "lstm" else jnp.asarray(v)) for k, v in tree.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("head", ["out_proj", "out_w", "none"])
def test_bridge_round_trip_exact(head, tmp_path):
    e = H if head == "none" else E            # tied head with E == H
    tree = _tree(head=head, e=e)
    params = params_from_numpy(tree, device="cpu")
    back = params_to_numpy(params)
    assert set(back) == set(tree)
    for k in tree:
        if k == "lstm":
            for a, b in zip(back[k], tree[k]):
                for kk in a:
                    np.testing.assert_array_equal(a[kk], b[kk])
        else:
            np.testing.assert_array_equal(back[k], tree[k])
    save_params(params, tmp_path / "params.npz")
    again = params_to_numpy(load_params(tmp_path / "params.npz", "cpu"))
    np.testing.assert_array_equal(again["embed"], tree["embed"])
    np.testing.assert_array_equal(again["lstm"][1]["wh"],
                                  tree["lstm"][1]["wh"])


def test_bridge_reads_jax_init_tree():
    """A tree made by fewshot.models.lm.init_lm converts and matches."""
    import jax
    cfg = JConfig(**KW)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), cfg, V)
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(back["out_proj"], tree["out_proj"])
    np.testing.assert_array_equal(back["lstm"][0]["wx"], tree["lstm"][0]["wx"])
    ours = lm.init_lm(Config(**KW), V, torch.Generator().manual_seed(0),
                      "cpu")
    assert {k: np.shape(v) for k, v in params_to_numpy(ours).items()
            if k != "lstm"} == {k: np.shape(v) for k, v in tree.items()
                                if k != "lstm"}


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        params_from_numpy(_tree())
    with pytest.raises(RuntimeError):
        lm.init_lm(Config(**KW), V, torch.Generator().manual_seed(0))


def _seq_inputs(seed=1, b=5, t=11):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, E)).astype(np.float32)
    lens = np.array([t, 1, 6, t - 2, 3])[:b]
    mask = np.arange(t)[None] < lens[:, None]
    mask[0, 4:6] = False                      # a hole mid-sequence
    state = [((0.5 * rng.randn(b, H)).astype(np.float32),
              (0.5 * rng.randn(b, H)).astype(np.float32)) for _ in range(2)]
    return x, mask, state


@pytest.mark.parametrize("cell", ["scan", "pallas"])
@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_forward_matches_jax(cell, layers):
    tree = _tree(layers=layers)
    params = params_from_numpy(tree, "cpu")
    x, mask, state = _seq_inputs()
    state = state[:layers]
    jys, jstate = jlstm.lstm_forward(
        _jax(tree)["lstm"], jnp.asarray(x), mask=jnp.asarray(mask),
        state=[(jnp.asarray(h), jnp.asarray(c)) for h, c in state],
        cell="scan")
    with torch.no_grad():
        ys, st = lstm.lstm_forward(
            params.lstm, torch.tensor(x), mask=torch.tensor(mask),
            state=[(torch.tensor(h), torch.tensor(c)) for h, c in state],
            cell=cell, eval_mode=True)
    _close(ys, jys)
    for (h, c), (jh, jc) in zip(st, jstate):
        _close(h, jh)
        _close(c, jc)


def test_lstm_step_matches_jax():
    tree = _tree()
    params = params_from_numpy(tree, "cpu")
    x, _, state = _seq_inputs()
    for dt, jdt, tol in ((torch.float32, jnp.float32, ATOL),
                         (torch.bfloat16, jnp.bfloat16, 1e-4)):
        jh, jst = jlstm.lstm_step(
            _jax(tree)["lstm"], jnp.asarray(x[:, 0]),
            [(jnp.asarray(h), jnp.asarray(c)) for h, c in state], jdt)
        with torch.no_grad():
            h, st = lstm.lstm_step(
                params.lstm, torch.tensor(x[:, 0]),
                [(torch.tensor(a), torch.tensor(b)) for a, b in state], dt)
        _close(h, jh, tol)
        _close(st[0][1], jst[0][1], tol)


def _episode(seed=2, b=2, k=3, l_=24, v=V):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, l_ + 1, (b, k))
    lens[0, 0] = 1
    toks = rng.randint(4, v, (b, k, l_))
    toks[np.arange(l_)[None, None] >= lens[..., None]] = 0
    return toks.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("cell", ["scan", "pallas"])
@pytest.mark.parametrize("mode", ["state", "mean_state"])
def test_support_state_matches_jax(cell, mode):
    tree = _tree()
    params = params_from_numpy(tree, "cpu")
    toks, lens = _episode()
    jcfg = JConfig(**KW, support_mode=mode)
    cfg = Config(**KW, support_mode=mode, cell=cell)
    jstate = jlm.support_state(_jax(tree), jnp.asarray(toks),
                               jnp.asarray(lens), jcfg, eval_mode=True)
    with torch.no_grad():
        state = lm.support_state(params, torch.tensor(toks).long(),
                                 torch.tensor(lens).long(), cfg,
                                 eval_mode=True)
    for (h, c), (jh, jc) in zip(state, jstate):
        _close(h, jh)
        _close(c, jc)


@pytest.mark.parametrize("rows,folded", [(4 * 130, True), (4 * 30, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_embed_fold_matches_jax(rows, folded, dtype):
    v = 30              # the fold needs V < E*4H/(4H-E) = 34 here
    tree = _tree(v=v)
    params = params_from_numpy(tree, "cpu")
    toks = np.random.RandomState(3).randint(0, v, (4, rows // 4))
    jcfg = JConfig(**KW, compute_dtype=dtype)
    cfg = Config(**KW, compute_dtype=dtype)
    jx, jzx = jlm._lstm_embed(_jax(tree), jnp.asarray(toks), jcfg, None)
    with torch.no_grad():
        x, zx = lm._lstm_embed(params, torch.tensor(toks).long(), cfg)
    assert (zx is not None) == folded == (jzx is not None)
    if folded:
        assert x is None and jx is None
        _close(zx, jzx, ATOL if dtype == "float32" else 1e-4)
    else:
        _close(x, jx)
    _close(lm.embed(params, torch.tensor(toks).long()),
           jlm.embed(_jax(tree), jnp.asarray(toks)))


# 4 rows: two matmuls; 64 rows: the [H, V] pre-contract (V < H*E/(H-E) = 42
# and rows*(H-E) > H*E iff rows > 42)
@pytest.mark.parametrize("rows", [4, 64])
@pytest.mark.parametrize("head", ["out_proj", "out_w"])
def test_head_logits_matches_jax(rows, head):
    tree = _tree(head=head)
    params = params_from_numpy(tree, "cpu")
    hidden = np.tanh(np.random.RandomState(4).randn(rows, H)).astype(
        np.float32)                      # an LSTM output lies in (-1, 1)
    tie = head == "out_proj"
    jcfg = JConfig(**KW, tie_embeddings=tie)
    cfg = Config(**KW, tie_embeddings=tie)
    jlog = jlm.head_logits(_jax(tree), jnp.asarray(hidden), jcfg)
    with torch.no_grad():
        logits = lm.head_logits(params, torch.tensor(hidden), cfg)
    assert logits.shape == (rows, V)
    _close(logits, jlog)


def test_shift_targets_matches_jax():
    toks, lens = _episode()
    ji, jt, jm = jlm.shift_targets(jnp.asarray(toks), jnp.asarray(lens))
    i, t, m = lm.shift_targets(torch.tensor(toks), torch.tensor(lens))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


@pytest.mark.parametrize("change", [dict(model="transformer", remat=True),
                                    dict(support_cache=True),
                                    dict(support_mode="finetune")])
def test_later_slices_raise(change):
    """Each of the three once raised; now each runs.  The transformer's
    remat and finetune (cell='scan', inner SGD per episode): the loss and
    the grads of every parameter equal JAX's on the same weights and
    episode.  The cache head trains, evaluates, generates and serves: the
    decode loop samples from its mixture, static and dynamic."""
    cfg = dataclasses.replace(Config(**KW), **change)
    if not cfg.support_cache:
        params = lm.init_lm(cfg, V, torch.Generator().manual_seed(0), "cpu")
        jcfg = JConfig(**{**KW, **change})
        rng = np.random.RandomState(4)
        lens = rng.randint(3, 11, (2, 4))
        toks = (rng.randint(3, V, (2, 4, 10))
                * (np.arange(10) < lens[..., None]))
        arrs = (toks[:, :3], lens[:, :3], toks[:, 3:], lens[:, 3:],
                np.zeros(2))
        jep = JEpisode(*(jnp.asarray(a, jnp.int32) for a in arrs))
        (jt, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jlm.episodic_nll_stats(p, jep, jcfg), has_aux=True))(
            jax.tree.map(jnp.asarray, params_to_numpy(params)))
        total, _ = lm.episodic_nll_stats(
            params, Episode(*(torch.tensor(a).long() for a in arrs)), cfg)
        total.backward()
        _close(total, jt, ATOL * max(1.0, abs(float(jt))))
        want = flatten(jax.tree.map(np.asarray, jg))
        for k, p in params.named_parameters():
            _close(p.grad, want[k], ATOL * max(1.0, np.abs(want[k]).max()))
        return
    params = lm.init_lm(cfg, V, torch.Generator().manual_seed(0), "cpu")
    assert {"cache_gate.w", "cache_gate.b", "cache_prior.u",
            "cache_prior.log_s"} <= {k for k, _ in params.named_parameters()}
    support = torch.full((2, 3, 8), 4)
    for dynamic in (False, True):
        toks = sampling.generate(
            params, support, torch.full((2, 3), 8),
            [torch.Generator().manual_seed(i) for i in range(2)],
            dataclasses.replace(cfg, cache_dynamic=dynamic), n_tokens=4)
        assert toks.shape == (2, 4) and toks.dtype == torch.int64
        assert bool(((toks >= 0) & (toks < V)).all())
    from fewshot_torch.data.corpus import PackedCorpus
    from fewshot_torch.data.lyrics import tokenize_corpus
    rows = [(f"a{a}", f"s{s}", " ".join(f"w{(a + s + i) % 9}"
                                         for i in range(6)))
            for a in range(3) for s in range(4)]
    vocab, items = tokenize_corpus(rows, vocab_size=V)
    corpus = PackedCorpus.pack(items, vocab, max_len=8, seed=0)
    cfg = dataclasses.replace(cfg, max_len=8, cache_dynamic=True,
                              sample_tokens=4, support_size=2)
    params = lm.init_lm(cfg, len(vocab), torch.Generator().manual_seed(0),
                        "cpu")
    gen = serve.Generator(cfg, corpus, params, batch_size=2, device="cpu")
    try:
        outs = gen.generate(num=2, split="train", episode_seed=3)
    finally:
        gen.close()
    assert len(outs) == 2 and all(0 < o["tokens"] <= 4 for o in outs)
