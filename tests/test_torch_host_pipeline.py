"""The port's host episode pipeline against fewshot.data.host_pipeline.

* The batches: ``fewshot_torch.data.host_pipeline.HostEpisodePipeline`` on
  the CPU gives the JAX pipeline's arrays, equal element for element, for
  3 seeds x 5 batches of ``tiny_corpus`` (both draw from
  ``np.random.RandomState(seed)`` in the same order);
* a rank's batch (rank r of a world of W) is rows [r B/W, (r+1) B/W) of
  the world-of-one batch, and a batch size that W does not divide raises;
* 5 fed train steps from the same weights (JAX's init, bridged; cell=scan,
  fp32, dropout 0, grad clip 1) on the two pipelines' episodes: the
  port's loss, token count and grad norm at every step within 1e-5
  relative of JAX's ``make_fed_train_step`` (only the order of fp32 sums
  differs), and ``evaluate_fed`` on the val pipelines within 1e-6
  relative;
* ``pipeline: host`` through the port's train CLI on the CPU: the train
  pipeline seeded ``seed``, the val pipeline ``seed + 1``, val NLL
  logged; a resume at step 4 restores it and re-seeds the train pipeline
  with ``seed + 4``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
from fewshot import training as jax_training
from fewshot.config import Config as JaxConfig
from fewshot.data.host_pipeline import HostEpisodePipeline as JaxPipeline
from fewshot_torch import bridge, cli, training
from fewshot_torch.config import Config
from fewshot_torch.data.host_pipeline import HostEpisodePipeline

B, K, Q = 8, 2, 2
REL = 1e-5
EVAL_REL = 1e-6
FIELDS = ("support", "support_len", "query", "query_len", "artist")
CFG = dict(vocab_size=64, max_len=24, embed_dim=16, hidden_dim=24,
           num_layers=1, batch_size=B, support_size=K, query_size=Q,
           lr=5e-3, pipeline="host", data_parallel=False, cell="scan",
           compute_dtype="float32", dropout=0.0, grad_clip=1.0)


def _draw(pipe, n):
    try:
        return [[np.asarray(x) for x in next(pipe)] for _ in range(n)]
    finally:
        pipe.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_equal_jax(tiny_corpus, seed):
    want = _draw(JaxPipeline(tiny_corpus, "train", B, K, Q, seed=seed), 5)
    got = _draw(HostEpisodePipeline(tiny_corpus, "train", B, K, Q,
                                    seed=seed, device="cpu"), 5)
    for w, g in zip(want, got):
        for name, a, b in zip(FIELDS, w, g):
            assert b.dtype == np.int64 and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_rows_are_a_slice(tiny_corpus, world):
    full = _draw(HostEpisodePipeline(tiny_corpus, "train", B, K, Q, seed=5,
                                     device="cpu"), 2)
    rows = B // world
    for r in range(world):
        part = _draw(HostEpisodePipeline(tiny_corpus, "train", B, K, Q,
                                         seed=5, device="cpu", rank=r,
                                         world=world), 2)
        for f, p in zip(full, part):
            for a, b in zip(f, p):
                np.testing.assert_array_equal(a[r * rows:(r + 1) * rows], b)
    with pytest.raises(ValueError, match="not divisible"):
        HostEpisodePipeline(tiny_corpus, "train", 6, K, Q, device="cpu",
                            world=4)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def test_fed_steps_and_eval_track_jax(tiny_corpus):
    jcfg = JaxConfig(**CFG)
    cfg = Config(**CFG)
    jstate = jax_training.init_train_state(jcfg, 64)
    tree = jax.tree.map(np.asarray, jstate.params)
    params = bridge.params_from_numpy(tree, "cpu")
    state = training.TrainState(params, training.make_optimizer(cfg).init(
        params), 0, torch.Generator().manual_seed(0))

    jstep = jax_training.make_fed_train_step(jcfg)
    step = training.make_fed_train_step(cfg)
    jpipe = JaxPipeline(tiny_corpus, "train", B, K, Q, seed=11)
    pipe = HostEpisodePipeline(tiny_corpus, "train", B, K, Q, seed=11,
                               device="cpu")
    try:
        for i in range(5):
            jstate, jm = jstep(jstate, next(jpipe))
            state, m = step(state, next(pipe))
            for k in ("loss", "tokens", "grad_norm"):
                assert _rel(m[k], jm[k]) <= REL, (i, k, m[k], jm[k])
    finally:
        jpipe.close()
        pipe.close()

    jval = JaxPipeline(tiny_corpus, "val", B, K, Q, seed=3, prefetch=1)
    val = HostEpisodePipeline(tiny_corpus, "val", B, K, Q, seed=3,
                              prefetch=1, device="cpu")
    try:
        want = jax_training.evaluate_fed(jcfg, jstate.params, jval,
                                         num_episodes=16)
        got = training.evaluate_fed(cfg, state.params, val,
                                    num_episodes=16)
    finally:
        jval.close()
        val.close()
    assert _rel(got, want) <= EVAL_REL, (got, want)


def test_cli_host_pipeline_and_reseeded_resume(tiny_corpus, tmp_path,
                                               monkeypatch, capsys):
    from fewshot_torch.data.corpus import PackedCorpus
    corpus_dir = tmp_path / "corpus"
    PackedCorpus(**{f.name: getattr(tiny_corpus, f.name) for f in
                    dataclasses.fields(PackedCorpus)}).save(corpus_dir)
    seeds = []

    class Recording(HostEpisodePipeline):
        def __init__(self, corpus, split, *a, seed=0, **kw):
            seeds.append((split, seed))
            super().__init__(corpus, split, *a, seed=seed, **kw)
    monkeypatch.setattr(cli, "HostEpisodePipeline", Recording)
    ck = tmp_path / "ck"
    sets = ["--set", f"corpus_dir={corpus_dir}", "max_len=24",
            "vocab_size=64", "embed_dim=16", "hidden_dim=24",
            "num_layers=1", f"batch_size={B}", f"support_size={K}",
            f"query_size={Q}", "pipeline=host", "data_parallel=false",
            "cell=scan", "log_interval=2", "eval_interval=2",
            "eval_episodes=8", "checkpoint_interval=2", "seed=3"]
    cli.main(["train", "--device", "cpu", "--checkpt_dir", str(ck), *sets,
              "max_steps=4"])
    assert seeds == [("train", 3), ("val", 4)]
    cli.main(["train", "--device", "cpu", "--checkpt_dir", str(ck), *sets,
              "max_steps=6"])
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    assert seeds[2:] == [("train", 3 + 4), ("val", 4)]
    recs = [json.loads(x) for x in
            (ck / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "val_nll" in r] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert json.loads((ck / "6" / "step.json").read_text())["step"] == 6


def test_stress_close_and_producer_error(tiny_corpus):
    """Under a switch interval of 1 us the consumer still gets the
    sequential draws, in order; close() ends the producer thread while it
    is blocked on a full queue; a producer failure is raised by the next
    draw instead of hanging it."""
    import sys
    want = _draw(HostEpisodePipeline(tiny_corpus, "train", B, K, Q, seed=7,
                                     device="cpu"), 12)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = HostEpisodePipeline(tiny_corpus, "train", B, K, Q, seed=7,
                                   prefetch=1, device="cpu")
        got = [[np.asarray(x) for x in next(pipe)] for _ in range(12)]
        pipe.close()
    finally:
        sys.setswitchinterval(old)
    assert not pipe._thread.is_alive()
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)

    broken = dataclasses.replace(tiny_corpus, songs=tiny_corpus.songs[:1])
    pipe = HostEpisodePipeline(broken, "train", B, K, Q, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            next(pipe)
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
