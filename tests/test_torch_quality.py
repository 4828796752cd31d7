"""The port's quality harness (fewshot_torch/quality.py) on the CPU, on a
tiny synthetic lyrics corpus (12 artists x 12 songs):

* a leg's record has the keys of ``scripts/scale_quality.py`` run_leg's
  (the JAX function runs in a subprocess on the same corpus and options);
* the best-val parameters are a copy, not the live tensors the optimizer
  keeps updating, and the test NLL is taken at them;
* early stopping: the leg stops after `patience` evals without an
  improvement of more than 1e-4 (a scripted val curve);
* every val eval scores the same episodes: a fresh generator seeded 7 each
  time (99 for the test split);
* ``main`` with --max_steps 30 --eval_every 10 writes the JSON (curve, card
  line, the cut, no verdict, the score on a JAX episode set), merges into
  an existing JSON, saves the best-val parameters and --set overrides the
  leg's config;
* the band verdict, from the JAX records in ``benchmarks/``;
* JAX's test episodes (``jax_test_episode_set``: the draws of
  ``fewshot.training.evaluate`` under ``PRNGKey(99)``) equal the episodes
  that JAX's own sampler gives for those keys, and the committed sets
  under ``fewshot_torch/quality_episodes/`` have the protocol's shapes.

Run as a script, this file writes those sets from the full-size corpora
that ``python -m fewshot_torch.quality`` builds under ``--root``, and
prints JAX's unigram floors on the same corpora beside the recorded ones
(equal when the corpora and the JAX random streams are the ones of the
recorded runs):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_quality.py \
        [--root DIR]
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch import quality
from fewshot_torch.data.corpus import build_lyrics_corpus
from fewshot_torch.data.synthetic import generate_lyrics_csv

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(embed_dim=16, hidden_dim=32, batch_size=4, cell="scan")
# the options of the key comparison: every conditional key of run_leg's
# record but the finetune ones (cache fields, cache_lm_aux, seed,
# batch_size, cell)
KEYED = dict(support_cache=True, cache_backoff="global", cache_calib=True,
             cache_dynamic=True, cache_lm_aux=1.0, cell="scan",
             batch_size=4)
PROTO = dict(max_steps=4, eval_every=2, steps_per_call=2, patience=8,
             eval_episodes=8)

_JAX_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from argparse import Namespace
from pathlib import Path
from scripts.scale_quality import run_leg
spec = json.loads(sys.argv[1])
leg = run_leg("keys", Path(spec["corpus"]), Namespace(**spec["proto"]),
              seed=1, **spec["over"])
print("KEYS " + json.dumps(sorted(leg)))
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = tmp_path_factory.mktemp("quality")
    csv = d / "lyrics" / "lyrics.csv"
    generate_lyrics_csv(csv, num_artists=12, songs_per_artist=12, seed=0,
                        extra_vocab=300)
    build_lyrics_corpus(csv, d / "lyrics" / "plain", vocab_size=5000,
                        max_len=0, seed=0)
    return d


def test_leg_keys_equal_jax_run_leg(root):
    corpus = str(root / "lyrics" / "plain")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, json.dumps(
            {"corpus": corpus, "proto": PROTO, "over": KEYED})],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    leg = quality.run_leg("keys", Path(corpus), PROTO, device="cpu", seed=1,
                          **{**KEYED, **SMALL})
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    want = json.loads(out.split("KEYS ", 1)[1])
    assert sorted(leg) == want


def test_best_params_copy_early_stop_and_fixed_eval_episodes(root,
                                                             monkeypatch):
    """A scripted val curve 5.0, 4.0, 4.5, 4.6, 4.7 with patience 3: the
    leg stops at the fifth eval, its best is the second, the test NLL is
    taken at a copy of the parameters of that eval, and every val eval
    got a fresh generator in the same state."""
    curve = iter([5.0, 4.0, 4.5, 4.6, 4.7])
    calls = []
    real_evaluate = quality.training.evaluate

    def scripted(cfg, params, data, split, gen, num_episodes=None):
        calls.append({"seed": gen.initial_seed(),
                      "state": gen.get_state().clone(), "params": params,
                      "values": {k: v.detach().clone() for k, v in
                                 params.named_parameters()}})
        if gen.initial_seed() == quality.TEST_SEED:
            return real_evaluate(cfg, params, data, split, gen,
                                 num_episodes)
        return next(curve)

    monkeypatch.setattr(quality.training, "evaluate", scripted)
    art = {}
    proto = dict(PROTO, max_steps=100, patience=3)
    leg = quality.run_leg("stop", root / "lyrics" / "plain", proto,
                          device="cpu", artifacts=art, **SMALL)
    val, test = calls[:-1], calls[-1]
    assert [c["seed"] for c in val] == [quality.VAL_SEED] * 5
    assert all(torch.equal(c["state"], val[0]["state"]) for c in val)
    assert test["seed"] == quality.TEST_SEED
    assert leg["steps_trained"] == 12 and len(leg["curve"]) == 5
    assert leg["best_step"] == art["best_step"] == 6
    assert leg["best_val_nll"] == 4.0
    # the test NLL came from the snapshot, equal to the second eval's
    # parameters, while the live parameters moved on
    assert test["params"] is art["best_params"]
    live = dict(art["params"].named_parameters())
    for k, p in art["best_params"].named_parameters():
        assert torch.equal(p, val[1]["values"][k]), k
        assert p.data_ptr() != live[k].data_ptr()
    assert not torch.equal(art["best_params"].embed, art["params"].embed)
    # a fresh generator per eval: the same episodes, the same NLL
    assert leg["test_nll"] == round(real_evaluate(
        *_eval_args(root, art["best_params"], quality.TEST_SEED)), 4)


def _eval_args(root, params, seed):
    from fewshot_torch.config import Config
    from fewshot_torch.data import episodes as eps
    from fewshot_torch.data.corpus import PackedCorpus
    corpus = PackedCorpus.load(root / "lyrics" / "plain")
    cfg = Config(vocab_size=len(corpus.vocab), max_len=corpus.max_len,
                 support_mode="mean_state", support_size=5, query_size=5,
                 num_layers=2, compute_dtype="bfloat16", **SMALL)
    split = torch.as_tensor(corpus.splits["test"], dtype=torch.int64)
    return (cfg, params, eps.put_corpus(corpus, "cpu"), split,
            torch.Generator().manual_seed(seed), PROTO["eval_episodes"])


def test_main_writes_the_json_and_keeps_existing(root, tmp_path,
                                                 monkeypatch):
    """main writes the leg, merges into an existing JSON, records a cut
    protocol and withholds the verdict of such a leg, saves the best-val
    parameters under --root and scores them on a JAX episode set where
    one is there for the corpus and batch size."""
    monkeypatch.setitem(quality.LEGS, "tiny", ("lyrics/plain", SMALL))
    monkeypatch.setattr(quality, "EPISODE_SETS", tmp_path / "sets")
    quality.EPISODE_SETS.mkdir()
    ids, arts = jax_test_episode_set(root / "lyrics" / "plain", batch=4,
                                     n=8)
    np.savez(quality.episode_set_path("lyrics/plain", 4), song_ids=ids,
             artist=arts, k=np.int32(5), q=np.int32(5))
    out = tmp_path / "q.json"
    out.write_text(json.dumps({"other": {"kept": True}}))
    argv = ["--legs", "tiny", "--root", str(root), "--out", str(out),
            "--device", "cpu", "--max_steps", "30", "--eval_every", "10",
            "--eval_episodes", "8"]
    quality.main(argv)
    first = json.loads(out.read_text())
    assert first["other"] == {"kept": True}
    leg = first["tiny"]
    assert [c["step"] for c in leg["curve"]] == [20, 30]
    assert leg["steps_trained"] == 30 and leg["test_nll"] > 0
    assert first["cards"]["tiny"] is None          # no nvidia-smi here
    assert first["cuts"]["tiny"] == {"max_steps": 30, "eval_every": 10,
                                     "eval_episodes": 8}
    assert first["verdicts"]["tiny"] == {"jax_test_nll_base": None,
                                         "withheld": "protocol cut"}
    on_jax = first["jax_episodes"]["tiny"]
    assert on_jax["episodes"] == 8 and on_jax["test_nll"] > 0
    saved = torch.load(root / "best" / "tiny.pt")
    assert "embed" in saved and all(torch.isfinite(v).all()
                                    for v in saved.values())
    quality.main(argv[:-6] + ["--max_steps", "20", "--set",
                              "support_mode=state"])
    second = json.loads(out.read_text())
    assert second["other"] == {"kept": True}
    assert second["tiny"]["steps_trained"] == 20
    assert second["tiny"]["support_mode"] == "state"
    assert second["overrides"]["tiny"] == ["support_mode=state"]
    assert second["cuts"]["tiny"] == {"max_steps": 20}


def test_band_verdict():
    assert quality.band("plain_cache_full_floor") == 0.02
    assert quality.band("tfm_cache_full_s1") == pytest.approx(0.0446)
    assert quality.jax_leg("midi_plain_cache_floor")["test_nll_base"] == \
        1.357
    assert quality.jax_leg("plain_ft_cache_full")[
        "unigram_floor_test_base"] == 5.0177
    assert quality.jax_leg("midi_plain_cache_dyn") is None
    leg = {"test_nll_base": 4.62, "beats_floor": True}
    v = quality.verdict("plain_cache_full_floor", leg)
    assert v["inside_band"] and v["port_minus_jax"] == 0.0111
    assert v["episodes"] == "port"
    assert not quality.verdict("plain_cache_full_floor",
                               dict(leg, test_nll_base=4.64))["inside_band"]
    assert not quality.verdict("plain_cache_full_floor",
                               dict(leg, beats_floor=False))["inside_band"]
    # on JAX's episodes the verdict takes that score
    v = quality.verdict("plain_cache_full_floor", leg,
                        {"test_nll_base": 4.64})
    assert v["episodes"] == "jax" and not v["inside_band"]
    # JAX's plain leg does not beat its floor: neither must the port's
    assert quality.verdict("plain", {"test_nll_base": 5.84,
                                     "beats_floor": False})["inside_band"]


def jax_test_episode_set(corpus_dir, batch: int, n: int, k: int = 5,
                         q: int = 5, seed: int = quality.TEST_SEED):
    """(song_ids [N, k+q], artists [N]) of the test episodes that
    ``fewshot.training.evaluate`` scores under ``PRNGKey(seed)``: batch i
    from ``fold_in(key, i)``, split as ``_loss_stats`` splits it, then
    ``sample_episode``'s per-episode keys; N = (n // batch) * batch."""
    import jax
    import jax.numpy as jnp
    from fewshot.data import episodes as jeps
    from fewshot.data.corpus import PackedCorpus as JCorpus
    corpus = JCorpus.load(corpus_dir)
    data = jeps.put_corpus(corpus)
    split = jnp.asarray(corpus.splits["test"])
    draw = jax.jit(jax.vmap(
        lambda kk: jeps._sample_one(kk, data, split, k + q)))
    ids, arts = [], []
    for i in range(max(1, n // batch)):
        k_sample, _ = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), i))
        song_ids, _, artist = draw(jax.random.split(k_sample, batch))
        ids.append(np.asarray(song_ids, np.int32))
        arts.append(np.asarray(artist, np.int32))
    return np.concatenate(ids), np.concatenate(arts)


def test_jax_test_episode_set_is_jax_evaluates_draw(root):
    import jax
    import jax.numpy as jnp
    from fewshot.data import episodes as jeps
    from fewshot.data.corpus import PackedCorpus as JCorpus
    corpus_dir = root / "lyrics" / "plain"
    ids, arts = jax_test_episode_set(corpus_dir, batch=4, n=9, k=3, q=2)
    assert ids.shape == (8, 5) and arts.shape == (8,)
    corpus = JCorpus.load(corpus_dir)
    data = jeps.put_corpus(corpus)
    split = jnp.asarray(corpus.splits["test"])
    assert set(arts.tolist()) <= set(corpus.splits["test"].tolist())
    for i in range(2):
        k_sample, _ = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(quality.TEST_SEED), i))
        ep = jeps.sample_episode(k_sample, data, split, 4, k=3, q=2)
        got = np.asarray(data.songs)[ids[4 * i:4 * i + 4]]
        np.testing.assert_array_equal(
            got, np.concatenate([ep.support, ep.query], axis=1))
        np.testing.assert_array_equal(arts[4 * i:4 * i + 4], ep.artist)


@pytest.mark.parametrize("sub,batch,n", [
    ("lyrics/plain", 32, 512), ("lyrics/plain", 16, 512),
    ("lyrics/bpe", 32, 512), ("midi/plain", 32, 256), ("midi/bpe", 32, 256)])
def test_committed_jax_episode_sets(sub, batch, n):
    from fewshot_torch.data import episodes as eps
    ids, arts, k, q = eps.load_episode_set(
        quality.episode_set_path(sub, batch))
    assert ids.shape == (n, 10) and arts.shape == (n,) and (k, q) == (5, 5)


SETS = [("lyrics/plain", 32), ("lyrics/plain", 16), ("lyrics/bpe", 32),
        ("midi/plain", 32), ("midi/bpe", 32)]


def write_jax_episode_sets(root: Path) -> None:
    """Write JAX's test episodes for every leg family and batch size into
    ``fewshot_torch/quality_episodes/``, and print JAX's unigram floors on
    the corpora under root beside the recorded ones."""
    import jax
    import jax.numpy as jnp
    from fewshot.config import Config as JConfig
    from fewshot.data import episodes as jeps
    from fewshot.data.corpus import PackedCorpus as JCorpus
    from fewshot.models.unigram import evaluate_unigram
    quality.EPISODE_SETS.mkdir(exist_ok=True)
    for sub, batch in SETS:
        family = sub.split("/")[0]
        n = quality.PROTOCOLS[family]["eval_episodes"]
        corpus_dir = quality.corpus_dir(root, sub)
        ids, arts = jax_test_episode_set(corpus_dir, batch, n)
        np.savez(quality.episode_set_path(sub, batch), song_ids=ids,
                 artist=arts, k=np.int32(5), q=np.int32(5),
                 split=np.str_("test"), seed=np.int32(quality.TEST_SEED),
                 batch=np.int32(batch))
        corpus = JCorpus.load(corpus_dir)
        cfg = JConfig(vocab_size=len(corpus.vocab), max_len=corpus.max_len,
                      support_size=5, query_size=5, batch_size=batch)
        floor = evaluate_unigram(
            cfg, corpus, jeps.put_corpus(corpus),
            jnp.asarray(corpus.splits["test"]),
            jax.random.PRNGKey(quality.FLOOR_SEED), num_episodes=n)
        tag = {"lyrics/plain": "plain_cache_full_floor",
               "lyrics/bpe": "bpe_cache_freq",
               "midi/plain": "midi_plain_cache_floor",
               "midi/bpe": "midi_bpe_cache_aux"}[sub]
        if batch == 16:
            tag = "plain_ft_cache_full"
        print(json.dumps({"set": sub, "batch": batch, "episodes": len(ids),
                          "jax_unigram_floor_test": round(floor, 4),
                          "recorded": quality.jax_leg(tag)[
                              "unigram_floor_test"]}), flush=True)


if __name__ == "__main__":
    import argparse
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(quality.DEFAULT_ROOT))
    write_jax_episode_sets(Path(ap.parse_args().root))
