"""MIDI serving: the HTTP round trip of tests/test_torch_serve.py against a
live server of a MIDI model on the CPU.

A model on an event corpus answers with each continuation's ``events`` and
its count of decoded ``notes``; under the grammar masks every continuation
is whole SHIFT->PITCH->DUR->VEL groups, each one a note.  A BPE corpus is
served without masks, its merged tokens expanded to base events.  As in
fewshot/serve.py, a row's output does not depend on what it was batched
with.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from fewshot_torch.config import Config
from fewshot_torch.data.corpus import build_midi_corpus
from fewshot_torch.data.synthetic import generate_midi_corpus
from fewshot_torch.models.lm import init_lm
from fewshot_torch.serve import Generator, serve

KINDS = ["SHIFT", "PITCH", "DUR", "VEL"]


def _cfg(corpus, **kw):
    return Config(dataset="midi", vocab_size=len(corpus.vocab),
                  max_len=corpus.max_len, embed_dim=16, hidden_dim=128,
                  num_layers=2, batch_size=4, support_size=2, query_size=1,
                  sample_tokens=24, cell="pallas", support_mode="mean_state",
                  top_k=0, data_parallel=False, **kw)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("midi_serve")
    generate_midi_corpus(d / "raw", num_artists=8, songs_per_artist=4,
                         seed=1, notes_range=(4, 8))
    return (build_midi_corpus(d / "raw", d / "plain", max_len=0),
            build_midi_corpus(d / "raw", d / "bpe", max_len=0,
                              bpe_merges=30))


def _server(cfg, corpus):
    params = init_lm(cfg, len(corpus.vocab),
                     torch.Generator().manual_seed(0), "cpu")
    gen = Generator(cfg, corpus, params, batch_size=4, device="cpu")
    srv = serve(gen, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return gen, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def midi_server(corpora):
    gen, srv, url = _server(_cfg(corpora[0]), corpora[0])
    yield gen, url
    srv.shutdown()
    gen.close()


def test_healthz_names_midi(midi_server):
    _, url = midi_server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["dataset"] == "midi" and body["device"] == "cpu"


@pytest.mark.parametrize("payload", [
    {"num": 4, "split": "train", "episode_seed": 2},
    {"num": 1, "split": "val", "temperature": 0.5, "episode_seed": 9},
    {"num": 2, "artist": "artist_003", "episode_seed": 4}])
def test_generate_whole_note_groups(midi_server, payload):
    gen, url = midi_server
    assert gen.token_masks is not None and gen.token_masks.shape[0] == 4
    status, body = _post(url, payload)
    assert status == 200
    outs = body["continuations"]
    assert len(outs) == payload["num"]
    for rec in outs:
        assert "text" not in rec
        kinds = [e.split("_")[0] for e in rec["events"]]
        assert len(kinds) == rec["tokens"] and len(kinds) % 4 == 0
        assert kinds == KINDS * (len(kinds) // 4)
        assert rec["notes"] == len(kinds) // 4
        if "artist" in payload:
            assert rec["artist"] == payload["artist"]


def test_rows_do_not_depend_on_their_batch(midi_server):
    gen, _ = midi_server
    alone = gen.generate(num=1, split="train", artist=2, episode_seed=5)
    full = gen.generate(num=4, split="train", artist=2, episode_seed=5)
    assert alone[0]["events"] == full[0]["events"]


def test_bpe_corpus_serves_unmasked_and_expanded(corpora):
    corpus = corpora[1]
    gen, srv, url = _server(_cfg(corpus), corpus)
    try:
        assert gen.token_masks is None
        status, body = _post(url, {"num": 4, "split": "train",
                                   "episode_seed": 1})
        assert status == 200
        events = [e for rec in body["continuations"] for e in rec["events"]]
        assert events and all("+" not in e for e in events)
        assert all(e.split("_")[0] in KINDS + ["<unk>"] for e in events)
        toks = gen._run_batch(np.full(4, 1, np.int32),
                              np.arange(4, dtype=np.int64),
                              np.ones(4, np.float32))
        assert (toks >= 204).any()            # merge tokens were drawn
    finally:
        srv.shutdown()
        gen.close()
