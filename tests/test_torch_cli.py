"""The port's train CLI and checkpoints (fewshot_torch/cli.py,
fewshot_torch/utils/ckpt.py, utils/metrics.py) on the CPU.

A tiny synthetic lyrics corpus (8 artists x 6 songs) is packed into a
temporary directory; the CLI trains a small LSTM with the full cache stack
(``--device cpu``, ``--set`` overrides only).  Checked:

* a save / restore round trip gives the same parameters, Adam state, step
  and sampler generator state, bit for bit;
* 2N steps in one run give the same parameters (``torch.equal``) as N
  steps, a stop, and N more resumed from the checkpoint ("restored
  checkpoint at step N"): the restored generator draws the same episodes,
  and with dropout 0.1 the same dropout masks (drawn from the same
  generator after the episodes);
* a checkpoint of another vocab is refused by ``recover_or_init`` and by
  ``serve_main``; another semantic hyperparameter prints the warning;
* a resume whose step is not a multiple of steps_per_call exits with the
  JAX package's message;
* ``max_to_keep`` keeps the newest three steps, and a step is renamed into
  place (no temporary directory is left);
* ``metrics.jsonl`` holds loss, episodes_per_sec and val_nll lines;
* ``pipeline: host`` exits on ``task: lm`` with the JAX package's message
  and trains an episodic run under ``--debug_nans`` (the checked fed
  step); ``--debug_nans`` passes a finite run, and ``--profile_dir`` writes
  a trace.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fewshot_torch import cli, serve, training
from fewshot_torch.config import Config
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.data.lyrics import tokenize_corpus
from fewshot_torch.utils import ckpt

SET = ["max_len=16", "vocab_size=64", "embed_dim=16", "hidden_dim=32",
       "num_layers=2", "cell=scan", "support_mode=state", "batch_size=4",
       "support_size=2", "query_size=2", "steps_per_call=2",
       "log_interval=2", "eval_interval=4", "checkpoint_interval=2",
       "eval_episodes=8", "support_cache=true", "cache_calib=true",
       "cache_dynamic=true", "data_parallel=false"]


def _pack(seed, tmp, words=30):
    rng = np.random.RandomState(seed)
    vocab_words = [f"w{i}" for i in range(words)]
    rows = []
    for a in range(8):
        prefs = rng.dirichlet(np.ones(words))
        for s in range(6):
            n = rng.randint(6, 14)
            rows.append((f"artist_{a}", f"song_{s}",
                         " ".join(rng.choice(vocab_words, size=n, p=prefs))))
    vocab, items = tokenize_corpus(rows, vocab_size=64)
    corpus = PackedCorpus.pack(items, vocab, max_len=16, seed=0)
    corpus.save(tmp)
    return corpus


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    _pack(7, d)
    return d


def _train(corpus_dir, ckpt_dir, *extra, steps):
    cli.main(["train", "--device", "cpu", "--checkpt_dir", str(ckpt_dir),
              "--set", f"corpus_dir={corpus_dir}", f"max_steps={steps}",
              *SET, *extra])


def _cfg(corpus_dir, **kw):
    from fewshot_torch.config import parse_overrides
    over = parse_overrides([f"corpus_dir={corpus_dir}", *SET])
    return dataclasses.replace(Config(**over), **kw)


def _flat_state(state):
    out = {f"p:{k}": v.detach().clone()
           for k, v in state.params.named_parameters()}
    out.update({f"mu:{k}": v.clone() for k, v in state.opt_state.mu.items()})
    out.update({f"nu:{k}": v.clone() for k, v in state.opt_state.nu.items()})
    out["count"] = state.opt_state.count.clone()
    out["gen"] = state.gen.get_state().clone()
    return out


def test_save_restore_round_trip_is_bit_identical(corpus_dir, tmp_path):
    cfg = _cfg(corpus_dir)
    corpus = PackedCorpus.load(corpus_dir)
    from fewshot_torch.data import episodes as eps
    data = eps.put_corpus(corpus, "cpu")
    split = torch.as_tensor(corpus.splits["train"], dtype=torch.int64)
    state = training.init_train_state(cfg, len(corpus.vocab), device="cpu")
    step = training.make_train_step(cfg, data, split)
    for _ in range(3):
        state, _ = step(state)
    ckpt.save_checkpoint(tmp_path, state, "h", hparams=ckpt.hparams_of(cfg))
    fresh = training.init_train_state(cfg, len(corpus.vocab), seed=9,
                                      device="cpu")
    got, restored = ckpt.recover_or_init(tmp_path, fresh, "h",
                                         ckpt.hparams_of(cfg))
    assert restored and got.step == 3 == state.step
    want, have = _flat_state(state), _flat_state(got)
    assert set(want) == set(have)
    for k in want:
        assert torch.equal(want[k], have[k]), k
    assert ckpt.steps(tmp_path) == [3]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".")]


def _resume_equals_unbroken(corpus_dir, tmp_path, capsys, *extra):
    """8 steps in one run and 4 + 4 resumed: the same states, bit for bit
    (returned)."""
    _train(corpus_dir, tmp_path / "one", *extra, steps=8)
    _train(corpus_dir, tmp_path / "two", *extra, steps=4)
    capsys.readouterr()
    _train(corpus_dir, tmp_path / "two", *extra, steps=8)
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    cfg = _cfg(corpus_dir)
    n_vocab = len(PackedCorpus.load(corpus_dir).vocab)
    states = []
    for name in ("one", "two"):
        init = training.init_train_state(cfg, n_vocab, device="cpu")
        st, restored = ckpt.recover_or_init(tmp_path / name, init)
        assert restored and st.step == 8
        states.append(_flat_state(st))
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    return states[0]


def test_resume_with_dropout_equals_unbroken_run(corpus_dir, tmp_path,
                                                 capsys):
    """dropout 0.1: the masks come from the checkpointed generator, so a
    resumed run is the unbroken one; and they do act (another trajectory
    than dropout 0)."""
    with_drop = _resume_equals_unbroken(corpus_dir, tmp_path / "d", capsys,
                                        "dropout=0.1")
    without = _resume_equals_unbroken(corpus_dir, tmp_path / "n", capsys)
    assert not torch.equal(with_drop["p:embed"], without["p:embed"])
    assert not torch.equal(with_drop["gen"], without["gen"])


def test_resume_equals_unbroken_run(corpus_dir, tmp_path, capsys):
    _resume_equals_unbroken(corpus_dir, tmp_path, capsys)
    # checkpoints at 2, 4, 6, 8 in one run: the newest three are kept
    assert ckpt.steps(tmp_path / "one") == [4, 6, 8]
    lines = [json.loads(x) for x in
             (tmp_path / "one" / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in lines if "loss" in r]
    assert [r["step"] for r in losses] == [2, 4, 6, 8]
    assert all(r["episodes_per_sec"] > 0 and np.isfinite(r["loss"])
               for r in losses)
    assert [r["step"] for r in lines if "val_nll" in r] == [4, 8]


def test_vocab_mismatch_raises(corpus_dir, tmp_path):
    _train(corpus_dir, tmp_path / "ck", steps=2)
    other = tmp_path / "other_corpus"
    _pack(8, other, words=20)
    cfg = _cfg(other)
    corpus = PackedCorpus.load(other)
    assert corpus.vocab.content_hash() != \
        PackedCorpus.load(corpus_dir).vocab.content_hash()
    init = training.init_train_state(cfg, len(corpus.vocab), device="cpu")
    with pytest.raises(ValueError, match="different vocab"):
        ckpt.recover_or_init(tmp_path / "ck", init,
                             corpus.vocab.content_hash())
    with pytest.raises(ValueError, match="different vocab"):
        serve.serve_main(["--device", "cpu", "--checkpt_dir",
                          str(tmp_path / "ck"), "--set",
                          f"corpus_dir={other}", *SET])


def test_hparams_mismatch_warns(corpus_dir, tmp_path, capsys):
    _train(corpus_dir, tmp_path, steps=2)
    cfg = _cfg(corpus_dir, cache_dynamic=False)
    init = training.init_train_state(cfg, len(PackedCorpus.load(
        corpus_dir).vocab), device="cpu")
    capsys.readouterr()
    _, restored = ckpt.recover_or_init(tmp_path, init,
                                       hparams=ckpt.hparams_of(cfg))
    out = capsys.readouterr().out
    assert restored
    assert "trained with cache_dynamic=True but the config says " \
        "cache_dynamic=False" in out


def test_misaligned_resume_exits(corpus_dir, tmp_path):
    _train(corpus_dir, tmp_path, "steps_per_call=1", "log_interval=1",
           "eval_interval=0", "checkpoint_interval=0", steps=3)
    assert ckpt.latest_step(tmp_path) == 3
    with pytest.raises(SystemExit, match="not a multiple of steps_per_call"):
        _train(corpus_dir, tmp_path, steps=8)


def test_host_pipeline_raises_and_debug_nans_runs(corpus_dir, tmp_path):
    """pipeline: host is refused for task: lm (as the JAX package refuses
    it) and trains an episodic run one fed step a call under --debug_nans;
    --debug_nans and --profile_dir (a trace of steps 10-20, one step a
    chunk) run a finite run to its end."""
    with pytest.raises(SystemExit, match="pipeline: host supports only"):
        _train(corpus_dir, tmp_path / "a", "pipeline=host", "task=lm",
               "support_cache=false", "cache_calib=false",
               "cache_dynamic=false", steps=2)
    cli.main(["train", "--device", "cpu", "--debug_nans", "--checkpt_dir",
              str(tmp_path / "h"), "--set", f"corpus_dir={corpus_dir}",
              "max_steps=4", *SET, "pipeline=host"])
    assert ckpt.latest_step(tmp_path / "h") == 4
    cli.main(["train", "--device", "cpu", "--debug_nans", "--profile_dir",
              str(tmp_path / "prof"), "--checkpt_dir", str(tmp_path / "b"),
              "--set", f"corpus_dir={corpus_dir}", "max_steps=20", *SET])
    assert ckpt.latest_step(tmp_path / "b") == 20
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_serve_main_reads_the_latest_step(corpus_dir, tmp_path, monkeypatch):
    """serve_main restores a training run's latest step (a bare params.npz
    directory too) and hands the parameters to the server."""
    _train(corpus_dir, tmp_path / "run", steps=4)
    seen = {}

    class Stop(Exception):
        pass

    def fake_generator(cfg, corpus, params, batch, device):
        seen["params"] = params
        raise Stop
    monkeypatch.setattr(serve, "Generator", fake_generator)
    for d in ("run", "bare"):
        if d == "bare":
            from fewshot_torch.bridge import save_params
            save_params(seen["params"], tmp_path / "bare" / "params.npz")
        with pytest.raises(Stop):
            serve.serve_main(["--device", "cpu", "--checkpt_dir",
                              str(tmp_path / d), "--set",
                              f"corpus_dir={corpus_dir}", *SET])
    init = training.init_train_state(_cfg(corpus_dir), len(
        PackedCorpus.load(corpus_dir).vocab), device="cpu")
    want, _ = ckpt.recover_or_init(tmp_path / "run", init)
    for (k, a), (_, b) in zip(want.params.named_parameters(),
                              seen["params"].named_parameters()):
        assert torch.equal(a, b), k
