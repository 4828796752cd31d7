"""The port's BPE tier (fewshot_torch/data/bpe.py, the pack-time BPE of
corpus.py, episodes.base_token_ratio) against fewshot's.

* ``learn_bpe`` learns fewshot's merges, in fewshot's order, and the same
  extended vocab, on random integer streams (skewed so counts tie) for
  several merge counts and ``min_count`` values;
* ``encode`` gives fewshot's ids and ``expand`` inverts it exactly;
* a BPE lyrics corpus packed by either package is the other's (arrays,
  vocab, merges, pre-BPE lengths) and loads in both;
* ``base_token_ratio`` equals fewshot's over each split's pool and over a
  fixed set's query songs, and is 1.0 without merges.

Everything is exact (integer ids; the ratio is a quotient of the same
integer sums).
"""

import numpy as np
import pytest

from fewshot.data import bpe as jbpe
from fewshot.data import corpus as jcorpus
from fewshot.data import episodes as jeps
from fewshot.data import synthetic as jsynthetic
from fewshot.data.vocab import SPECIALS as JSPECIALS, Vocab as JVocab
from fewshot_torch.data import bpe as tbpe
from fewshot_torch.data import corpus as tcorpus
from fewshot_torch.data import episodes as teps
from fewshot_torch.data.vocab import SPECIALS, Vocab


def _streams(seed, n=40, v=30):
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.full(v, 0.3))
    out = []
    for _ in range(n):
        s = list(rng.choice(v, size=rng.randint(0, 30), p=p) + 4)
        # specials inside a stream never merge
        if s and rng.rand() < 0.3:
            s.insert(rng.randint(len(s)), int(rng.randint(0, 4)))
        out.append([int(x) for x in s])
    return out


def _vocabs(v=30):
    words = [f"w{i}" for i in range(v)]
    return Vocab(SPECIALS + words), JVocab(JSPECIALS + words)


@pytest.mark.parametrize("seed,merges,min_count", [
    (0, 10, 2), (1, 60, 2), (2, 200, 2), (3, 40, 5), (4, 25, 1)])
def test_learn_bpe_matches_jax(seed, merges, min_count):
    seqs = _streams(seed)
    tv, jv = _vocabs()
    t_vocab, t_merges = tbpe.learn_bpe(seqs, tv, merges, min_count)
    j_vocab, j_merges = jbpe.learn_bpe(seqs, jv, merges, min_count)
    assert t_merges == j_merges
    assert t_vocab.tokens == j_vocab.tokens
    assert len(t_merges) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_expand_round_trip(seed):
    seqs = _streams(seed)
    tv, jv = _vocabs()
    _, merges = tbpe.learn_bpe(seqs, tv, 50)
    _, j_merges = jbpe.learn_bpe(seqs, jv, 50)
    shorter = 0
    for s in seqs + _streams(seed + 10):        # unseen streams too
        enc = tbpe.encode(s, merges)
        assert enc == jbpe.encode(s, j_merges)
        assert tbpe.expand(enc, merges) == s
        assert tbpe.expand(np.asarray(enc, np.int32), merges) == s
        shorter += len(enc) < len(s)
    assert shorter > 0


def test_merges_file_round_trip(tmp_path):
    tv, _ = _vocabs()
    _, merges = tbpe.learn_bpe(_streams(5), tv, 20)
    tbpe.save_merges(merges, tmp_path / "t.json")
    assert tbpe.load_merges(tmp_path / "t.json") == merges
    assert jbpe.load_merges(tmp_path / "t.json") == merges


def _same_corpus(a, b):
    for k in ("songs", "song_len", "song_artist", "artist_song_ids",
              "artist_num_songs", "base_song_len"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for k in a.splits:
        np.testing.assert_array_equal(a.splits[k], b.splits[k])
    assert a.vocab.tokens == b.vocab.tokens
    assert [tuple(m) for m in a.merges] == [tuple(m) for m in b.merges]


@pytest.fixture(scope="module")
def bpe_corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    jsynthetic.generate_lyrics_csv(d / "l.csv", num_artists=10,
                                   songs_per_artist=6, seed=2)
    t = tcorpus.build_lyrics_corpus(d / "l.csv", d / "t", vocab_size=80,
                                    max_len=0, seed=1, bpe_merges=30)
    j = jcorpus.build_lyrics_corpus(d / "l.csv", d / "j", vocab_size=80,
                                    max_len=0, seed=1, bpe_merges=30)
    return d, t, j


def test_bpe_corpus_matches_jax_and_loads_in_both(bpe_corpora):
    d, t, j = bpe_corpora
    _same_corpus(t, j)
    assert len(t.merges) == 30 and len(t.vocab) == 80 + 30
    assert (t.song_len <= t.base_song_len).all()
    _same_corpus(tcorpus.PackedCorpus.load(d / "j"), j)
    _same_corpus(jcorpus.PackedCorpus.load(d / "t"), t)
    # decoding expands the merges back to the base tokens
    s = 3
    ids = t.songs[s, :t.song_len[s]]
    words = t.decode(ids)
    assert len(words) == t.base_song_len[s] - 2
    assert all("+" not in w for w in words)
    assert words == j.vocab.decode(jbpe.expand(ids, j.merges))


def test_base_token_ratio_matches_jax(bpe_corpora, tmp_path):
    _, t, j = bpe_corpora
    for split in ("train", "val", "test"):
        got = teps.base_token_ratio(t, split)
        assert got == jeps.base_token_ratio(j, split)
        assert 0 < got < 1
    teps.save_episode_set(tmp_path / "s.npz", t, "val", 12, 2, 3, seed=4)
    ids, _, k, _ = teps.load_episode_set(tmp_path / "s.npz")
    songs = np.asarray(ids)[:, k:].ravel()
    assert teps.base_token_ratio(t, "test", song_ids=songs) == \
        jeps.base_token_ratio(j, "test", song_ids=songs)
    plain = tcorpus.PackedCorpus(t.songs, t.song_len, t.song_artist,
                                 t.artist_song_ids, t.artist_num_songs,
                                 t.splits, t.artist_names, t.vocab)
    assert teps.base_token_ratio(plain, "val") == 1.0
