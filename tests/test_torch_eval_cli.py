"""The port's evaluate surface against fewshot's, on the CPU.

* ``cli make-eval-set`` writes the same npz arrays as
  ``scripts/make_eval_set.py`` for the same corpus and seed;
* ``cli evaluate --eval_set`` on a checkpoint of bridged JAX weights (JAX's
  init plus noise on every leaf, saved by each package's own checkpoint
  code) prints JAX's ``eval_set_nll_per_token`` within a relative 1e-5
  (REL, as tests/test_torch_cache_head.py), for the LSTM and the
  transformer (each with the full cache stack), on lyrics and on MIDI, and
  on a BPE MIDI corpus also its ``eval_set_nll_per_base_token``;
* the lines of ``evaluate --also_split_eval --per_artist`` and of
  ``--baseline unigram`` are JAX's lines with other numbers (the random
  episodes differ by design), so a script that parses one parses both;
* ``lm.episodic_nll``, ``lm.lm_nll`` and ``training.evaluate_fed`` equal
  JAX's on fixed episodes and bridged weights (REL).

fp32 on both sides; the LSTM on its scan cell and the transformer on its
einsum attention (the kernels' twins are held against the Pallas kernels
elsewhere), so only summation order differs.
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot import training as jtraining
from fewshot.cli import evaluate_main as jevaluate_main
from fewshot.config import load_config as jload_config
from fewshot.config import parse_overrides as jparse
from fewshot.data import corpus as jcorpus
from fewshot.data import episodes as jeps
from fewshot.data import synthetic as jsynthetic
from fewshot.models import lm as jlm
from fewshot.utils import ckpt as jckpt
from fewshot_torch import cli, training
from fewshot_torch.bridge import flatten, params_from_numpy, unflatten
from fewshot_torch.config import load_config, parse_overrides
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.models import lm
from fewshot_torch.utils import ckpt

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve()
                       .parent.parent / "scripts"))
import make_eval_set as jmake_eval_set          # noqa: E402

REL = 1e-5
YAML = {"lyrics": "configs/data/lyrics.yaml", "midi": "configs/data/midi.yaml",
        "lstm": "configs/model/lstm.yaml",
        "transformer": "configs/model/transformer.yaml",
        "task": "configs/task/episodic_cache.yaml"}
SMALL = ["embed_dim=32", "hidden_dim=48", "num_layers=2", "num_heads=2",
         "batch_size=4", "support_size=2", "query_size=2", "eval_episodes=8",
         "cell=scan", "prefix_flash=false", "flash=false",
         "data_parallel=false", "compute_dtype=float32",
         "cache_resp_floor=0.25"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Packed by the JAX package (the port loads them): lyrics, MIDI, and
    MIDI with BPE merges."""
    d = tmp_path_factory.mktemp("corpora")
    jsynthetic.generate_lyrics_csv(d / "l.csv", num_artists=10,
                                   songs_per_artist=6, seed=0)
    jcorpus.build_lyrics_corpus(d / "l.csv", d / "lyrics", vocab_size=120,
                                max_len=24)
    jsynthetic.generate_midi_corpus(d / "raw", num_artists=10,
                                    songs_per_artist=6, seed=0,
                                    notes_range=(4, 8))
    jcorpus.build_midi_corpus(d / "raw", d / "midi", max_len=0)
    jcorpus.build_midi_corpus(d / "raw", d / "midi_bpe", max_len=0,
                              bpe_merges=40)
    return d


def _sets(corpora, corpus_name):
    c = PackedCorpus.load(corpora / corpus_name)
    return c, [f"corpus_dir={corpora / corpus_name}",
               f"max_len={c.max_len}", f"vocab_size={max(len(c.vocab), 120)}",
               *SMALL]


def _args(model, data, ckpt_dir, sets, *extra):
    return ["--data", YAML[data], "--model", YAML[model], "--task",
            YAML["task"], *(["--checkpt_dir", str(ckpt_dir)] if ckpt_dir
                            else []), *extra, "--set", *sets]


def _noised_tree(cfg, v, seed):
    """JAX's init with noise on every leaf, as a numpy tree."""
    tree = jlm.init_lm(jax.random.PRNGKey(seed), cfg, v)
    flat = flatten(jax.tree.map(np.asarray, tree))
    rng = np.random.RandomState(seed)
    return unflatten({k: (np.asarray(a, np.float32)
                          + 0.2 * rng.randn(*np.shape(a))).astype(np.float32)
                      for k, a in flat.items()})


def _checkpoints(tmp_path, model, data, sets, corpus, seed=3):
    """The same weights saved by both packages: (JAX dir, port dir)."""
    yaml = (YAML[data], YAML[model], YAML["task"])
    jcfg = jload_config(*yaml, jparse(sets))
    tcfg = load_config(*yaml, parse_overrides(sets))
    v = len(corpus.vocab)
    tree = _noised_tree(jcfg, v, seed)
    vh = corpus.vocab.content_hash()
    jstate = jtraining.init_train_state(jcfg, v)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, tree))
    jckpt.save_checkpoint(tmp_path / "j", jstate, vh, block=True,
                          hparams=jckpt.hparams_of(jcfg))
    jckpt.wait_for_checkpoints()
    tstate = training.init_train_state(tcfg, v, device="cpu")
    tstate = tstate._replace(params=params_from_numpy(tree, "cpu"))
    ckpt.save_checkpoint(tmp_path / "t", tstate, vh,
                         hparams=ckpt.hparams_of(tcfg))
    return tmp_path / "j", tmp_path / "t"


def _value(out, key):
    m = re.search(rf"^{re.escape(key)}=(\S+)", out, re.M)
    assert m, (key, out)
    return float(m.group(1))


def _template(out):
    """The printed lines with their numbers blanked."""
    return [re.sub(r"-?\d+\.\d+", "#", ln) for ln in out.splitlines()
            if not ln.startswith("warning")]


def test_make_eval_set_matches_jax(corpora, tmp_path, capsys):
    for split, seed in (("val", 0), ("test", 7), ("train", 3)):
        args = ["--corpus", str(corpora / "lyrics"), "--split", split,
                "--episodes", "17", "--k", "2", "--q", "3", "--seed",
                str(seed)]
        jmake_eval_set.main([*args, "--out", str(tmp_path / "j.npz")])
        cli.main(["make-eval-set", *args, "--out", str(tmp_path / "t.npz")])
        j, t = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype, k
            np.testing.assert_array_equal(j[k], t[k])
    out = capsys.readouterr().out
    assert "wrote 17 train episodes (K=2, Q=3)" in out


CASES = [("lstm", "lyrics", "lyrics"), ("transformer", "lyrics", "lyrics"),
         ("lstm", "midi", "midi"), ("transformer", "midi", "midi"),
         ("lstm", "midi", "midi_bpe")]


@pytest.mark.parametrize("model,data,corpus_name", CASES,
                         ids=["-".join(c[::2]) for c in CASES])
def test_evaluate_eval_set_matches_jax(corpora, tmp_path, capsys, model,
                                       data, corpus_name):
    corpus, sets = _sets(corpora, corpus_name)
    jdir, tdir = _checkpoints(tmp_path, model, data, sets, corpus)
    es = tmp_path / "set.npz"
    eps.save_episode_set(es, corpus, "val", 10, 2, 2, seed=1)
    capsys.readouterr()
    jevaluate_main(_args(model, data, jdir, sets, "--eval_set", str(es)))
    jout = capsys.readouterr().out
    cli.main(["evaluate", "--device", "cpu",
              *_args(model, data, tdir, sets, "--eval_set", str(es))])
    tout = capsys.readouterr().out
    keys = ["eval_set_nll_per_token"]
    if corpus.merges:
        keys.append("eval_set_nll_per_base_token")
    for key in keys:
        want, got = _value(jout, key), _value(tout, key)
        assert abs(got - want) <= REL * abs(want), (key, got, want)
    assert _template(tout) == _template(jout)
    assert len(_template(tout)) == len(keys)


@pytest.mark.parametrize("corpus_name", ["lyrics", "midi_bpe"])
def test_evaluate_lines_parse_as_jax(corpora, tmp_path, capsys, corpus_name):
    """--also_split_eval --per_artist, and the unigram baseline: the same
    lines (numbers aside) in the same order."""
    data = "midi" if corpus_name.startswith("midi") else "lyrics"
    corpus, sets = _sets(corpora, corpus_name)
    jdir, tdir = _checkpoints(tmp_path, "lstm", data, sets, corpus)
    es = tmp_path / "set.npz"
    eps.save_episode_set(es, corpus, "test", 6, 2, 2)
    extra = ["--split", "val", "--episodes", "8", "--eval_set", str(es),
             "--also_split_eval", "--per_artist"]
    capsys.readouterr()
    jevaluate_main(_args("lstm", data, jdir, sets, *extra))
    jevaluate_main(_args("lstm", data, None, sets, "--split", "val",
                         "--baseline", "unigram"))
    jout = capsys.readouterr().out
    cli.main(["evaluate", "--device", "cpu",
              *_args("lstm", data, tdir, sets, *extra)])
    cli.main(["evaluate", "--device", "cpu",
              *_args("lstm", data, None, sets, "--split", "val",
                     "--baseline", "unigram")])
    tout = capsys.readouterr().out
    assert _template(tout) == _template(jout)
    lines = _template(tout)
    assert sum(ln.startswith("  artist ") for ln in lines) == \
        len(corpus.splits["val"])
    assert lines[-1] == "val_nll_per_token=# (unigram baseline)"
    if corpus.merges:
        assert "val_nll_per_base_token=# (split compression ratio #)" in lines
    # the fixed set's score is JAX's here too
    want = _value(jout, "eval_set_nll_per_token")
    assert abs(_value(tout, "eval_set_nll_per_token") - want) <= \
        REL * abs(want)


def test_evaluate_refuses_a_mismatched_set_and_a_missing_checkpoint(
        corpora, tmp_path):
    corpus, sets = _sets(corpora, "lyrics")
    es = tmp_path / "set.npz"
    eps.save_episode_set(es, corpus, "val", 4, 3, 1)
    with pytest.raises(SystemExit, match="K=3 Q=1"):
        cli.main(["evaluate", "--device", "cpu",
                  *_args("lstm", "lyrics", None, sets, "--eval_set",
                         str(es))])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        cli.main(["evaluate", "--device", "cpu",
                  *_args("lstm", "lyrics", tmp_path / "none", sets)])


@pytest.fixture(scope="module")
def bridged(corpora):
    """LSTM and transformer weights (JAX init + noise) and fixed episodes
    from the MIDI corpus, as both packages' inputs."""
    corpus = PackedCorpus.load(corpora / "midi")
    out = {}
    for model in ("lstm", "transformer"):
        sets = [f"max_len={corpus.max_len}", *SMALL]
        yaml = (YAML["midi"], YAML[model], YAML["task"])
        jcfg = jload_config(*yaml, jparse(sets))
        tcfg = load_config(*yaml, parse_overrides(sets))
        tree = _noised_tree(jcfg, len(corpus.vocab), seed=5)
        out[model] = (jcfg, tcfg, tree)
    rng = np.random.RandomState(2)
    n = 12
    arts = rng.choice(corpus.splits["train"], n)
    ids = np.stack([corpus.artist_song_ids[a][rng.choice(
        corpus.artist_num_songs[a], 4, replace=False)] for a in arts])
    return corpus, out, ids.astype(np.int32), arts.astype(np.int32)


def _episodes(corpus, ids, arts):
    jdata = jeps.put_corpus(corpus)
    tdata = eps.put_corpus(corpus, "cpu")
    jep = [jeps.gather_episode(jdata, jnp.asarray(ids[i:i + 4]),
                               jnp.asarray(arts[i:i + 4]), 2, 2)
           for i in range(0, len(ids), 4)]
    tep = [eps.gather_episode(tdata, ids[i:i + 4], arts[i:i + 4], 2, 2)
           for i in range(0, len(ids), 4)]
    return jep, tep


@pytest.mark.parametrize("model", ["lstm", "transformer"])
def test_episodic_nll_and_evaluate_fed_match_jax(bridged, model):
    corpus, cases, ids, arts = bridged
    jcfg, tcfg, tree = cases[model]
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, "cpu")
    jep, tep = _episodes(corpus, ids, arts)
    for je, te in zip(jep, tep):
        want = float(jlm.episodic_nll(jparams, je, jcfg))
        with torch.no_grad():
            got = float(lm.episodic_nll(tparams, te, tcfg))
        assert abs(got - want) <= REL * abs(want)

    class Pipe:                      # an iterator of episodes with .batch
        def __init__(self, items):
            self.items, self.batch, self.i = items, 4, 0

        def __next__(self):
            self.i += 1
            return self.items[(self.i - 1) % len(self.items)]

    want = jtraining.evaluate_fed(jcfg, jparams, Pipe(jep), num_episodes=12)
    got = training.evaluate_fed(tcfg, tparams, Pipe(tep), num_episodes=12)
    assert abs(got - want) <= REL * abs(want)
    # any iterator: without .batch, cfg.batch_size episodes a draw
    assert training.evaluate_fed(tcfg, tparams, iter(tep),
                                 num_episodes=12) == got


@pytest.mark.parametrize("model", ["lstm", "transformer"])
def test_lm_nll_matches_jax(bridged, model):
    corpus, cases, ids, _ = bridged
    jcfg, tcfg, tree = cases[model]
    songs = corpus.songs[ids[:, 0]]
    lens = corpus.song_len[ids[:, 0]]
    want = float(jlm.lm_nll(jax.tree.map(jnp.asarray, tree),
                            jnp.asarray(songs), jnp.asarray(lens), jcfg))
    with torch.no_grad():
        got = float(lm.lm_nll(params_from_numpy(tree, "cpu"),
                              torch.as_tensor(songs).long(),
                              torch.as_tensor(lens).long(), tcfg))
    assert abs(got - want) <= REL * abs(want)
