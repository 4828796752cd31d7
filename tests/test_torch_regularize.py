"""Train-mode dropout and the transformer's remat in the port
(fewshot_torch/models/lm.py ``dropout``, models/transformer.py ``_remat``)
against fewshot's.

Dropout: both sides get the same keep masks, drawn with numpy in call
order (``fewshot.models.lm.dropout`` and the port's ``dropout`` are
monkeypatched in this process to apply them; no file of either package
changes), so the two losses and their grads must agree: the LSTM with the
embedding fold eligible (528 query rows, V=40: dropout must skip the fold,
as in JAX), the LSTM with the cache stack, the transformer's prefix path
and its plain path, the lm task and the finetune variant.  The masks'
shapes, in call order, must be the same on both sides.  The real dropout
draws its masks from the train state's generator: its keep rate and
scale, and an evaluation that ignores it.

Remat: the port's gradients with remat=True equal those without, bit for
bit (the recomputed blocks run the same operations; the attention twins
are deterministic), on the prefix path (prefix_flash on and off), the
plain path (flash on and off) and in bf16.  tests/test_torch_transformer.py
holds them against JAX's remat gradients.  ``lm.take_targets`` (the cache
head's target reads) equals the gather it replaces.

fp32, cell='scan' on the JAX side (in process).  Tolerance: 2e-5 of each
compared array's largest magnitude (the same arithmetic in another order
of fp32 sums).
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
from fewshot_torch import bridge, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.models import lm

RATE = 0.3
REL = 2e-5
FULL = dict(support_cache=True, cache_backoff="global", cache_calib=True,
            cache_dynamic=True, cache_resp_floor=0.25)
BASE = dict(vocab_size=40, max_len=12, embed_dim=64, hidden_dim=128,
            num_layers=2, support_size=2, query_size=2, dropout=RATE,
            support_mode="mean_state", cell="scan", data_parallel=False)
# name: (config changes, episodes per batch)
CASES = {
    "lstm_fold_eligible": ({}, 24),
    "lstm_state_cache": (dict(FULL, support_mode="state", num_layers=1), 3),
    "transformer_prefix_cache": (dict(FULL, model="transformer"), 3),
    "transformer_none": (dict(model="transformer", support_mode="none"), 3),
    "lm_task": (dict(task="lm"), 3),
    "finetune_cache": (dict(FULL, support_mode="finetune", inner_steps=1,
                            inner_lr=0.1, embed_dim=16, hidden_dim=24), 3),
}
L = 12


class MaskStream:
    """Keep masks in call order: the i-th dropout call gets
    RandomState(seed + i)'s draw for its input's shape."""

    def __init__(self, seed: int):
        self.seed, self.shapes = seed, []

    def next(self, shape) -> np.ndarray:
        shape = tuple(int(d) for d in shape)
        rng = np.random.RandomState(self.seed + len(self.shapes))
        self.shapes.append(shape)
        return rng.rand(*shape) < 1.0 - RATE


def _patch(monkeypatch, seed):
    """Both packages' dropout apply the same numpy masks in call order."""
    js, ts = MaskStream(seed), MaskStream(seed)

    def jax_dropout(x, rate, key):
        if key is None or rate <= 0.0:
            return x
        return jnp.where(jnp.asarray(js.next(x.shape)), x / (1.0 - rate),
                         0.0)

    def port_dropout(x, rate, src):
        if src is None or rate <= 0.0:
            return x
        keep = torch.as_tensor(ts.next(x.shape))
        return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))

    monkeypatch.setattr(jlm, "dropout", jax_dropout)
    monkeypatch.setattr(lm, "dropout", port_dropout)
    return js, ts


def _episode(b, seed=0):
    rng = np.random.RandomState(seed)
    v = BASE["vocab_size"]
    lens = rng.randint(2, L + 1, (b, 4))
    toks = rng.randint(3, v, (b, 4, L)) * (np.arange(L) < lens[..., None])
    return (toks[:, :2], lens[:, :2], toks[:, 2:], lens[:, 2:],
            np.zeros((b,), np.int64))


def _close(got, want, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= REL * scale, (
        what, float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dropout_matches_jax_with_the_same_masks(name, monkeypatch):
    change, b = CASES[name]
    kw = {**BASE, **change}
    jcfg, tcfg = JConfig(**kw), Config(**kw)
    params = lm.init_lm(tcfg, kw["vocab_size"],
                        torch.Generator().manual_seed(3), "cpu")
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
    arrs = _episode(b)
    js, ts = _patch(monkeypatch, 11)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    if tcfg.task == "lm":
        toks, lens = arrs[2].reshape(-1, L), arrs[3].reshape(-1)

        def jfn(p):
            return jlm.lm_nll_stats(p, jnp.asarray(toks), jnp.asarray(lens),
                                    jcfg, dropout_key=key)
        total, count = lm.lm_nll_stats(params, torch.tensor(toks),
                                       torch.tensor(lens), tcfg, drop=gen)
    else:
        jep = JEpisode(*(jnp.asarray(a, jnp.int32) for a in arrs))

        def jfn(p):
            return jlm.episodic_nll_stats(p, jep, jcfg, dropout_key=key)
        total, count = lm.episodic_nll_stats(
            params, eps.Episode(*(torch.tensor(a) for a in arrs)), tcfg,
            drop=gen)
    (jt, jc), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jp)
    total.backward()
    assert js.shapes == ts.shapes and len(ts.shapes) == 2, (js.shapes,
                                                            ts.shapes)
    _close(total, jt, "total")
    assert float(count) == float(jc)
    want = bridge.flatten(jax.tree.map(np.asarray, jg))
    for k, p in params.named_parameters():
        _close(p.grad, want[k], k)


def test_dropout_draws_its_masks_from_the_generator():
    x = torch.randn(200, 500)
    a = lm.dropout(x, 0.25, torch.Generator().manual_seed(1))
    b = lm.dropout(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(a[kept], x[kept] / 0.75)
    assert lm.dropout(x, 0.0, torch.Generator()) is x
    assert lm.dropout(x, 0.25, None) is x


def test_dropout_trains_and_evaluation_ignores_it():
    """A train step with dropout runs and takes another step than without;
    evaluation of the same weights is the same with and without."""
    rng = np.random.RandomState(0)
    n_art, per, v = 6, 6, BASE["vocab_size"]
    lens = rng.randint(3, L + 1, n_art * per).astype(np.int32)
    songs = (rng.randint(3, v, (n_art * per, L))
             * (np.arange(L) < lens[:, None])).astype(np.int32)
    data = eps.CorpusOnDevice(
        torch.tensor(songs, dtype=torch.int64),
        torch.tensor(lens, dtype=torch.int64),
        torch.arange(n_art * per).reshape(n_art, per),
        torch.full((n_art,), per))
    split = torch.arange(n_art)
    cfg = Config(**{**BASE, "batch_size": 4, "num_layers": 1})
    off = dataclasses.replace(cfg, dropout=0.0)
    params = {}
    for c in (cfg, off):
        state = training.init_train_state(c, v, device="cpu")
        state, m = training.make_train_step(c, data, split)(state)
        assert np.isfinite(float(m["loss"]))
        params[c.dropout] = state.params
    assert not torch.equal(params[RATE].embed, params[0.0].embed)
    nll = [training.evaluate(c, params[RATE], data, split,
                             torch.Generator().manual_seed(7),
                             num_episodes=8) for c in (cfg, off)]
    assert nll[0] == nll[1]


REMAT = {
    "prefix_flash": dict(support_mode="mean_state"),
    "prefix_einsum": dict(support_mode="mean_state", prefix_flash=False),
    "none_flash": dict(support_mode="none", flash=True),
    "none_einsum": dict(support_mode="none"),
    "state_bf16": dict(support_mode="state", compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", sorted(REMAT))
def test_remat_grads_equal_no_remat_bit_for_bit(name):
    kw = {**BASE, **FULL, "model": "transformer", "dropout": 0.0,
          "num_layers": 3, **REMAT[name]}
    arrs = _episode(3, seed=4)
    out = {}
    for remat in (False, True):
        cfg = Config(**{**kw, "remat": remat})
        params = lm.init_lm(cfg, kw["vocab_size"],
                            torch.Generator().manual_seed(5), "cpu")
        total, _ = lm.episodic_nll_stats(
            params, eps.Episode(*(torch.tensor(a) for a in arrs)), cfg)
        total.backward()
        out[remat] = (total.detach(), {k: p.grad for k, p in
                                       params.named_parameters()})
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[False][1].items():
        assert torch.equal(out[True][1][k], g), k


def test_take_targets_equals_gather():
    """lm.take_targets, which the cache head reads its targets through:
    the gather's values bit for bit and its gradient (fp64: a repeated
    token's gradients are summed in another order), 30 places over 11
    tokens a row.  On the card its backward gives the same bits on every
    run where the gather's does not (chip_smoke.py's remat phase)."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(5, 11), requires_grad=True)
    t = torch.tensor(rng.randint(0, 11, (5, 30)))
    g = torch.tensor(rng.randn(5, 30))
    got, want = lm.take_targets(x, t), x.gather(-1, t)
    assert torch.equal(got, want)
    (gx,), (wx,) = (torch.autograd.grad(y, x, g) for y in (got, want))
    torch.testing.assert_close(gx, wx, rtol=0, atol=1e-12)
