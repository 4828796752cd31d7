"""FewShotModel (fewshot_torch/models/base.py): the contract of
tests/test_base_model.py, on the CPU, plus the MIDI grammar and the device
rule.

train / step, eval of a split and of one episode, sample_artist, save and
recover_or_init (bit-identical parameters, another seed's init replaced,
an empty directory left alone); a MIDI model samples whole note groups
under the grammar masks; without a card, the default device raises.
"""

import numpy as np
import pytest
import torch

from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.data import midi as tmidi
from fewshot_torch.data.corpus import build_midi_corpus
from fewshot_torch.data.synthetic import generate_midi_corpus
from fewshot_torch.data.vocab import EOS, PAD
from fewshot_torch.models.base import FewShotModel

CFG = Config(vocab_size=64, max_len=24, embed_dim=16, hidden_dim=24,
             num_layers=1, batch_size=8, support_size=2, query_size=2,
             sample_tokens=10, lr=5e-3, data_parallel=False)


def test_contract(tiny_corpus, tmp_path):
    model = FewShotModel(CFG, tiny_corpus, device="cpu")

    # train
    first = model.train(1)
    for _ in range(10):
        last = model.train(1)
    assert model.step == 11
    assert np.isfinite(first) and np.isfinite(last)

    # eval: split average and a single episode
    nll = model.eval(split="val", num_episodes=8)
    assert 0 < nll < np.log(64) + 1
    ep = eps.sample_episode(torch.Generator().manual_seed(0), model.data,
                            torch.as_tensor(tiny_corpus.splits["val"]).long(),
                            4, k=2, q=2)
    ep_nll = model.eval(episode=ep)
    assert np.isfinite(ep_nll)
    assert model.eval(split="val", num_episodes=8) == nll   # same episodes

    # sample
    toks, artists = model.sample_artist(split="test", num=2, seed=1)
    assert toks.shape == (2, CFG.sample_tokens)
    assert toks.min() >= 0 and toks.max() < 64
    assert set(artists.tolist()) <= set(tiny_corpus.splits["test"].tolist())
    again, _ = model.sample_artist(split="test", num=2, seed=1)
    np.testing.assert_array_equal(toks, again)

    # save / recover_or_init
    model.save(tmp_path / "ck")
    model2 = FewShotModel(CFG, tiny_corpus, seed=123, device="cpu")
    assert model2.recover_or_init(tmp_path / "ck")
    assert model2.step == model.step
    for (k, a), (_, b) in zip(model2.state.params.named_parameters(),
                              model.state.params.named_parameters()):
        assert torch.equal(a, b), k
    assert model2.eval(split="val", num_episodes=8) == \
        model.eval(split="val", num_episodes=8)
    # fresh dir -> init
    model3 = FewShotModel(CFG, tiny_corpus, device="cpu")
    assert not model3.recover_or_init(tmp_path / "nothing_here")
    assert model3.step == 0


def test_midi_model_samples_under_the_grammar(tmp_path):
    generate_midi_corpus(tmp_path / "raw", num_artists=6, songs_per_artist=5,
                         seed=0, notes_range=(4, 8))
    corpus = build_midi_corpus(tmp_path / "raw", tmp_path / "c", max_len=0)
    cfg = Config(dataset="midi", vocab_size=len(corpus.vocab),
                 max_len=corpus.max_len, embed_dim=16, hidden_dim=24,
                 num_layers=1, batch_size=4, support_size=2, query_size=2,
                 sample_tokens=24, top_k=0, data_parallel=False)
    model = FewShotModel(cfg, corpus, device="cpu")
    model.train(2)
    toks, _ = model.sample_artist(split="train", num=4, seed=3)
    kinds = ["SHIFT", "PITCH", "DUR", "VEL"]
    for row in toks:
        row = [int(t) for t in row]
        body = row[:row.index(EOS)] if EOS in row else row
        assert PAD not in body and len(body) % 4 == 0
        assert [corpus.vocab.tokens[t].split("_")[0] for t in body] == \
            kinds * (len(body) // 4)
        assert len(tmidi.events_to_notes(corpus.vocab.decode(row))) == \
            len(body) // 4


def test_default_device_is_the_card(tiny_corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        FewShotModel(CFG, tiny_corpus)
