"""Serving with a batch's rows sharded over a list of devices.

``Generator(devices=["cpu", "cpu"])`` splits each batch into contiguous
row chunks, one a device, each drawn, primed and decoded against its own
replica of the parameters; per-row generators make a row's tokens
independent of the layout, so the continuations equal the single-device
``Generator(device="cpu")``'s, text and artist, for two seeds and both
models (the shape of tests/test_serve.py's multichip check); chunks of
distinct devices decode at the same time, each in its own thread.  The
batch is
rounded up to a multiple of the device count, and ``serve_main`` exits
under several processes, as the JAX server does.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from fewshot_torch import serve as serve_mod
from fewshot_torch.config import Config
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.data.lyrics import tokenize_corpus
from fewshot_torch.models.lm import init_lm
from fewshot_torch.serve import Generator

LSTM = Config(vocab_size=64, max_len=24, embed_dim=16, hidden_dim=128,
              num_layers=2, batch_size=8, support_size=2, query_size=1,
              sample_tokens=12, cell="pallas", support_mode="state")
TFM = dataclasses.replace(LSTM, model="transformer", embed_dim=32,
                          num_heads=2, num_layers=2, support_mode="state")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(7)
    words = [f"w{i}" for i in range(30)]
    rows = []
    for a in range(8):
        prefs = rng.dirichlet(np.ones(len(words)))
        for s in range(6):
            n = rng.randint(8, 20)
            rows.append((f"artist_{a}", f"song_{s}",
                         " ".join(rng.choice(words, size=n, p=prefs))))
    vocab, items = tokenize_corpus(rows, vocab_size=64)
    return PackedCorpus.pack(items, vocab, max_len=24, seed=0)


@pytest.mark.parametrize("cfg", [LSTM, TFM], ids=["lstm", "transformer"])
def test_sharded_rows_equal_single_device(corpus, cfg):
    params = init_lm(cfg, len(corpus.vocab), torch.Generator().manual_seed(0),
                     "cpu")
    plain = Generator(cfg, corpus, params, batch_size=8, device="cpu")
    sharded = Generator(cfg, corpus, params, batch_size=8,
                        devices=["cpu", "cpu"])
    try:
        assert sharded.batch == 8 and len(sharded._replicas) == 2
        assert sharded._replicas[0][0] is not sharded._replicas[1][0]
        for seed in (3, 11):
            a = plain.generate(num=8, split="train", episode_seed=seed)
            b = sharded.generate(num=8, split="train", episode_seed=seed)
            assert [r["text"] for r in a] == [r["text"] for r in b]
            assert [r["artist"] for r in a] == [r["artist"] for r in b]
    finally:
        plain.close()
        sharded.close()


@pytest.mark.parametrize("cfg", [LSTM, TFM], ids=["lstm", "transformer"])
def test_distinct_devices_decode_concurrently(corpus, cfg, monkeypatch):
    """Two distinct devices ("cpu" and "cpu:0") get a thread each, and the
    continuations are still the single-device ones."""
    params = init_lm(cfg, len(corpus.vocab), torch.Generator().manual_seed(0),
                     "cpu")
    threads = set()
    run_chunk = Generator._run_chunk

    def spy(self, *args):
        threads.add(threading.get_ident())
        return run_chunk(self, *args)
    monkeypatch.setattr(Generator, "_run_chunk", spy)
    plain = Generator(cfg, corpus, params, batch_size=8, device="cpu")
    sharded = Generator(cfg, corpus, params, batch_size=8,
                        devices=["cpu", "cpu:0"])
    try:
        assert len(sharded._groups) == 2 and sharded._pool is not None
        for seed in (3, 11):
            a = plain.generate(num=8, split="train", episode_seed=seed)
            threads.clear()
            b = sharded.generate(num=8, split="train", episode_seed=seed)
            assert len(threads) == 2
            assert [r["text"] for r in a] == [r["text"] for r in b]
            assert [r["artist"] for r in a] == [r["artist"] for r in b]
    finally:
        plain.close()
        sharded.close()


def test_batch_rounds_up_and_serve_main_refuses_processes(corpus, tmp_path,
                                                          monkeypatch):
    params = init_lm(LSTM, len(corpus.vocab),
                     torch.Generator().manual_seed(0), "cpu")
    gen = Generator(LSTM, corpus, params, batch_size=4,
                    devices=["cpu"] * 3)
    try:
        assert gen.batch == 6
        assert len(gen.generate(num=6, split="train", episode_seed=1)) == 6
    finally:
        gen.close()
    corpus.save(tmp_path)
    from fewshot_torch.parallel import distributed
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(serve_mod, "Generator", None)   # never reached
    with pytest.raises(SystemExit, match="one process"):
        serve_mod.serve_main(["--data", "configs/data/lyrics.yaml",
                              "--model", "configs/model/lstm.yaml",
                              "--task", "configs/task/episodic.yaml",
                              "--device", "cpu", "--set",
                              f"corpus_dir={tmp_path}",
                              "max_len=24"])

