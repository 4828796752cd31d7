"""Packed corpus: dense int32 arrays that episode assembly gathers from.

Port of ``fewshot/data/corpus.py`` (pack, save, load, ``device_arrays``,
``make_splits``, ``build_lyrics_corpus``, ``build_midi_corpus`` and the
pack-time BPE).  It reads and writes the same ``corpus.npz`` /
``meta.json`` / ``vocab.json`` / ``bpe.json`` files, so a corpus packed by
either package serves both.  Lyrics are tokenized and MIDI files parsed by
the native library (``data/native.py``) unless a builder is given
``native=False`` (the Python paths, the same bytes).

Arrays (all int32):
    songs            [S, max_len]  BOS + tokens + EOS, PAD-padded/truncated
    song_len         [S]           true length incl. BOS/EOS
    song_artist      [S]           owning artist id
    artist_song_ids  [A, M]        song ids per artist, padded with slot 0
    artist_num_songs [A]           valid prefix length of each artist row
    splits[name]     [n]           artist ids per split (train/val/test)
    base_song_len    [S]           BPE corpora only: pre-BPE length + framing
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from fewshot_torch.data import bpe
from fewshot_torch.data import lyrics as lyrics_mod
from fewshot_torch.data import midi as midi_mod
from fewshot_torch.data.vocab import BOS, EOS, PAD, SPECIALS, Vocab

SPLIT_FRACS = {"train": 0.8, "val": 0.1, "test": 0.1}


@dataclass
class PackedCorpus:
    songs: np.ndarray
    song_len: np.ndarray
    song_artist: np.ndarray
    artist_song_ids: np.ndarray
    artist_num_songs: np.ndarray
    splits: dict[str, np.ndarray]
    artist_names: list[str] = field(default_factory=list)
    vocab: Vocab | None = None
    merges: list = field(default_factory=list)   # BPE merge table (bpe.py)
    base_song_len: np.ndarray | None = None      # pre-BPE lengths (+framing)

    @property
    def max_len(self) -> int:
        return int(self.songs.shape[1])

    @property
    def num_artists(self) -> int:
        return int(self.artist_song_ids.shape[0])

    @classmethod
    def pack(cls, items: list[tuple[str, str, list[int]]], vocab: Vocab,
             max_len: int, seed: int = 0) -> "PackedCorpus":
        """Pack (artist, song, ids) tuples; ids exclude BOS/EOS framing.

        max_len <= 0 means auto: longest song + framing, rounded up to a
        multiple of 8 (the recurrence runs max_len steps, so a loose budget
        wastes serial time)."""
        if max_len <= 0:
            longest = max((len(ids) for _, _, ids in items), default=0)
            max_len = ((longest + 2 + 7) // 8) * 8
        artists = sorted({a for a, _, _ in items})
        aidx = {a: i for i, a in enumerate(artists)}
        n_songs = len(items)

        songs = np.full((n_songs, max_len), PAD, np.int32)
        song_len = np.zeros(n_songs, np.int32)
        song_artist = np.zeros(n_songs, np.int32)
        per_artist: dict[int, list[int]] = {i: [] for i in range(len(artists))}
        for i, (a, _, ids) in enumerate(items):
            framed = [BOS] + list(ids[: max_len - 2]) + [EOS]
            songs[i, : len(framed)] = framed
            song_len[i] = len(framed)
            song_artist[i] = aidx[a]
            per_artist[aidx[a]].append(i)

        max_songs = max(len(v) for v in per_artist.values())
        artist_song_ids = np.zeros((len(artists), max_songs), np.int32)
        artist_num_songs = np.zeros(len(artists), np.int32)
        for ai, ids in per_artist.items():
            artist_song_ids[ai, : len(ids)] = ids
            artist_num_songs[ai] = len(ids)

        splits = make_splits(len(artists), seed)
        return cls(songs, song_len, song_artist, artist_song_ids,
                   artist_num_songs, splits, artists, vocab)

    def save(self, corpus_dir: str | Path) -> None:
        d = Path(corpus_dir)
        d.mkdir(parents=True, exist_ok=True)
        extra = ({"base_song_len": self.base_song_len}
                 if self.base_song_len is not None else {})
        np.savez_compressed(
            d / "corpus.npz", songs=self.songs, song_len=self.song_len,
            song_artist=self.song_artist, artist_song_ids=self.artist_song_ids,
            artist_num_songs=self.artist_num_songs, **extra,
            **{f"split_{k}": v for k, v in self.splits.items()})
        (d / "meta.json").write_text(json.dumps(
            {"artist_names": self.artist_names}))
        if self.vocab is not None:
            self.vocab.save(d / "vocab.json")
        if self.merges:
            bpe.save_merges(self.merges, d / "bpe.json")

    @classmethod
    def load(cls, corpus_dir: str | Path) -> "PackedCorpus":
        d = Path(corpus_dir)
        z = np.load(d / "corpus.npz")
        splits = {k[len("split_"):]: z[k] for k in z.files
                  if k.startswith("split_")}
        meta = json.loads((d / "meta.json").read_text()) \
            if (d / "meta.json").exists() else {}
        vocab = Vocab.load(d / "vocab.json") \
            if (d / "vocab.json").exists() else None
        merges = (bpe.load_merges(d / "bpe.json")
                  if (d / "bpe.json").exists() else [])
        return cls(z["songs"], z["song_len"], z["song_artist"],
                   z["artist_song_ids"], z["artist_num_songs"], splits,
                   meta.get("artist_names", []), vocab, merges,
                   z["base_song_len"] if "base_song_len" in z.files
                   else None)

    def decode(self, ids) -> list[str]:
        """Token ids -> token strings (specials dropped), BPE merges
        expanded to base tokens first."""
        if self.merges:
            ids = bpe.expand(ids, self.merges)
        return self.vocab.decode(ids)

    def device_arrays(self) -> dict[str, np.ndarray]:
        """The arrays episode assembly needs (episodes.put_corpus)."""
        return {
            "songs": self.songs,
            "song_len": self.song_len,
            "artist_song_ids": self.artist_song_ids,
            "artist_num_songs": self.artist_num_songs,
        }


def support_coverage_estimate(corpus: PackedCorpus, k: int,
                              split: str = "train", n_episodes: int = 256,
                              seed: int = 0) -> float:
    """Monte-Carlo estimate of the fraction of query target tokens that
    appear in the episode's K support songs (``fewshot/data/corpus.py``
    support_coverage_estimate, the same draws).

    Near 1 the K-shot count posterior is already near-optimal at init: the
    cache head's gate routes to it and the LM branch's gradient starves, so
    the train CLI keys its warning on this.  Episodes are drawn as the
    device sampler draws them (an artist, then K+1 distinct songs where it
    has them).  Host numpy."""
    rng = np.random.default_rng(seed)
    artists = corpus.splits.get(split)
    if artists is None or len(artists) == 0:
        return 0.0
    # support + query need 2 songs; an artist with fewer than K+1 reuses
    # songs in the sampler, which only raises coverage
    artists = [a for a in np.asarray(artists)
               if corpus.artist_num_songs[a] >= 2]
    if not artists:
        return 0.0
    covered = total = 0
    for _ in range(n_episodes):
        a = artists[rng.integers(len(artists))]
        n = int(corpus.artist_num_songs[a])
        ids = corpus.artist_song_ids[a, :n]
        pick = rng.choice(n, size=min(k + 1, n), replace=False)
        sup, q = ids[pick[:-1]], ids[pick[-1]]
        sup_tokens = np.unique(corpus.songs[sup][
            np.arange(corpus.max_len) < corpus.song_len[sup][:, None]])
        # targets are positions 1..len-1 (BOS is never a target)
        qlen = int(corpus.song_len[q])
        q_targets = corpus.songs[q, 1:qlen]
        covered += int(np.isin(q_targets, sup_tokens).sum())
        total += q_targets.size
    return covered / max(total, 1)


def make_splits(num_artists: int, seed: int = 0,
                fracs: dict[str, float] = SPLIT_FRACS) -> dict[str, np.ndarray]:
    """Deterministic artist-level split.

    Needs >= 3 artists.  For tiny corpora where the test fraction rounds to
    zero, test aliases val rather than being empty."""
    if num_artists < 3:
        raise ValueError(
            f"make_splits needs >= 3 artists for train/val/test, got "
            f"{num_artists}")
    perm = np.random.RandomState(seed).permutation(num_artists)
    n_train = max(1, int(round(num_artists * fracs["train"])))
    n_val = max(1, int(round(num_artists * fracs["val"])))
    n_train = min(n_train, num_artists - 2)
    return {
        "train": np.sort(perm[:n_train]).astype(np.int32),
        "val": np.sort(perm[n_train:n_train + n_val]).astype(np.int32),
        "test": np.sort(perm[n_train + n_val:]).astype(np.int32)
        if num_artists > n_train + n_val
        else np.sort(perm[n_train:n_train + n_val]).astype(np.int32),
    }


def _apply_bpe(items, vocab, bpe_merges: int):
    """Learn and apply BPE at pack time: (the extended vocab, the
    re-encoded items, the merge table, the pre-BPE song lengths + framing
    for the per-base-token rescale)."""
    vocab, merges = bpe.learn_bpe([ids for _, _, ids in items], vocab,
                                  bpe_merges)
    base_len = np.asarray([len(ids) + 2 for _, _, ids in items], np.int32)
    items = [(a, s, bpe.encode(ids, merges)) for a, s, ids in items]
    return vocab, items, merges, base_len


def _pack_and_save(items, vocab, out_dir, max_len: int, seed: int,
                   bpe_merges: int) -> PackedCorpus:
    merges, base_len = [], None
    if bpe_merges > 0:
        vocab, items, merges, base_len = _apply_bpe(items, vocab, bpe_merges)
    corpus = PackedCorpus.pack(items, vocab, max_len, seed)
    corpus.merges = merges
    corpus.base_song_len = base_len
    corpus.save(out_dir)
    return corpus


def build_lyrics_corpus(csv_path: str | Path, out_dir: str | Path,
                        vocab_size: int, max_len: int, seed: int = 0,
                        bpe_merges: int = 0, native: bool = True
                        ) -> PackedCorpus:
    """CSV -> tokens -> vocab (-> BPE) -> packed corpus, saved under
    out_dir."""
    rows = lyrics_mod.read_lyrics_csv(csv_path)
    vocab, items = lyrics_mod.tokenize_corpus(rows, vocab_size, native)
    return _pack_and_save(items, vocab, out_dir, max_len, seed, bpe_merges)


def build_midi_corpus(midi_root: str | Path, out_dir: str | Path,
                      max_len: int, seed: int = 0,
                      bpe_merges: int = 0, native: bool = True
                      ) -> PackedCorpus:
    """Per-artist directories of ``.mid`` files -> event tokens (-> BPE)
    -> packed corpus, saved under out_dir.  The event vocab is closed
    (``midi.full_event_vocab``), so there is no counting pass; a file with
    no notes is skipped."""
    if native:
        from fewshot_torch.data import native as native_mod
        parse = native_mod.parse_midi
    else:
        parse = midi_mod.parse_midi
    vocab = Vocab(SPECIALS + midi_mod.full_event_vocab())
    items: list[tuple[str, str, list[int]]] = []
    for adir in sorted(p for p in Path(midi_root).iterdir() if p.is_dir()):
        for mid in sorted(adir.glob("*.mid")):
            notes = parse(mid)
            if notes:
                items.append((adir.name, mid.stem,
                              vocab.encode(midi_mod.notes_to_events(notes))))
    return _pack_and_save(items, vocab, out_dir, max_len, seed, bpe_merges)
