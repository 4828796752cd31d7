"""The port's serving tier: an HTTP round trip against a live server on
the CPU, mirroring tests/test_serve.py, and the no-CUDA refusal."""

import concurrent.futures as cf
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fewshot_torch.config import Config
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.data.lyrics import tokenize_corpus
from fewshot_torch.models.lm import init_lm
from fewshot_torch.serve import Generator, serve

CFG = Config(vocab_size=64, max_len=24, embed_dim=16, hidden_dim=128,
             num_layers=2, batch_size=4, support_size=2, query_size=1,
             sample_tokens=12, cell="pallas", support_mode="state",
             data_parallel=False)


@pytest.fixture(scope="module")
def corpus():
    """The same 8-artist corpus as tests/conftest.py, built by the port."""
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


@pytest.fixture(scope="module")
def server(corpus):
    params = init_lm(CFG, len(corpus.vocab),
                     torch.Generator().manual_seed(0), "cpu")
    gen = Generator(CFG, corpus, params, batch_size=4, device="cpu")
    srv = serve(gen, host="127.0.0.1", port=0)        # ephemeral port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    gen.close()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as resp:
        body = json.loads(resp.read())
    assert resp.status == 200
    assert body["status"] == "ok" and body["model"] == "lstm"
    assert body["device"] == "cpu" and body["batch"] == 4


def test_generate(server):
    status, body = _post(server, {"num": 2, "split": "train",
                                  "episode_seed": 1})
    assert status == 200
    outs = body["continuations"]
    assert len(outs) == 2
    for rec in outs:
        assert isinstance(rec["text"], str) and rec["text"]
        assert rec["artist"].startswith("artist_")
        assert 0 < rec["tokens"] <= CFG.sample_tokens


def test_generate_by_artist(server, corpus):
    name = corpus.artist_names[3]
    status, body = _post(server, {"num": 1, "artist": name,
                                  "temperature": 0.5})
    assert status == 200
    assert body["continuations"][0]["artist"] == name


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"artist": "nobody_ever"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"split": "bogus"})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"num": [1]})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=30)
    assert e.value.code == 404


def test_seed_reproducible_regardless_of_batching(server):
    """A request's output must not depend on what it was coalesced with."""
    _, ref = _post(server, {"num": 1, "split": "train", "episode_seed": 42})
    with cf.ThreadPoolExecutor(max_workers=3) as ex:
        noise1 = ex.submit(_post, server, {"num": 2, "split": "train",
                                           "episode_seed": 7})
        target = ex.submit(_post, server, {"num": 1, "split": "train",
                                           "episode_seed": 42})
        noise2 = ex.submit(_post, server, {"num": 1, "split": "train",
                                           "episode_seed": 9,
                                           "temperature": 0.4})
        for f in (noise1, noise2):
            assert f.result(timeout=120)[0] == 200
        status, got = target.result(timeout=120)
    assert status == 200
    timing = {k: got["continuations"][0][k] for k in ("latency_s",
                                                        "queue_s")}
    assert got["continuations"][0] == {**ref["continuations"][0], **timing}


def test_latency_counts_the_queue_wait(server):
    """latency_s runs from the request's submission to its result, so it
    holds queue_s, the wait before its batch's device call (three full
    batches at once: some wait behind another's call)."""
    with cf.ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(_post, server, {"num": 4, "split": "train",
                                          "episode_seed": s})
                for s in range(3)]
        recs = [f.result(timeout=120)[1]["continuations"][0] for f in futs]
    for rec in recs:
        assert rec["latency_s"] >= rec["queue_s"] >= 0
        assert rec["latency_s"] > 0


def test_generator_without_cuda_raises(corpus, monkeypatch):
    params = init_lm(CFG, len(corpus.vocab),
                     torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(CFG, corpus, params, batch_size=4)


def test_midi_serving_is_a_later_slice(corpus):
    """The later slice has landed: a MIDI config is served, under the
    grammar masks built over the corpus vocab (tests/test_torch_serve_midi.py
    drives MIDI serving over HTTP)."""
    import dataclasses
    from fewshot_torch.data.midi import grammar_masks
    params = init_lm(CFG, len(corpus.vocab),
                     torch.Generator().manual_seed(0), "cpu")
    gen = Generator(dataclasses.replace(CFG, dataset="midi"), corpus, params,
                    device="cpu")
    try:
        assert torch.equal(gen.token_masks,
                           torch.as_tensor(grammar_masks(corpus.vocab)))
    finally:
        gen.close()
