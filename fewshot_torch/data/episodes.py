"""Episode assembly: per-row song choice, then one gather on the device.

Port of ``fewshot/data/episodes.py`` (``put_corpus``, ``_choose_songs``,
``sample_episode_for_artists``, ``gather_episode``).  The packed corpus is
moved to the device once; an episode is then a gather of song rows.

Song choice follows the JAX sampler's semantics: an artist with at least
K+Q songs gives K+Q distinct songs, uniformly without replacement; for an
artist with fewer, the first n ranks are a permutation of its n songs and
the overflow ranks draw with replacement.  Each row draws from its own
``torch.Generator`` (a CPU generator, so a seed picks the same songs on any
device), which makes a row's episode independent of its batch neighbours.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Episode(NamedTuple):
    """One meta-batch of episodes (int64 tensors on the corpus device)."""
    support: torch.Tensor      # [B, K, L]
    support_len: torch.Tensor  # [B, K]
    query: torch.Tensor        # [B, Q, L]
    query_len: torch.Tensor    # [B, Q]
    artist: torch.Tensor       # [B]


class CorpusOnDevice(NamedTuple):
    """The packed-corpus arrays after the one-time upload."""
    songs: torch.Tensor             # [S, L]
    song_len: torch.Tensor          # [S]
    artist_song_ids: torch.Tensor   # [A, M]
    artist_num_songs: torch.Tensor  # [A]


def put_corpus(corpus, device: torch.device | str) -> CorpusOnDevice:
    """Upload a PackedCorpus (or its device_arrays dict) to `device`."""
    d = corpus.device_arrays() if hasattr(corpus, "device_arrays") else corpus

    def put(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    return CorpusOnDevice(
        songs=put(d["songs"]), song_len=put(d["song_len"]),
        artist_song_ids=put(d["artist_song_ids"]),
        artist_num_songs=put(d["artist_num_songs"]))


def _choose_songs(gen: torch.Generator, n: int, n_songs: int) -> torch.Tensor:
    """Slots [n_songs] into one artist's song row of valid length n."""
    take = min(n, n_songs)
    slots = torch.randperm(n, generator=gen)[:take]
    if take < n_songs:      # overflow ranks: with replacement
        extra = torch.randint(0, max(n, 1), (n_songs - take,), generator=gen)
        slots = torch.cat([slots, extra])
    return slots


def sample_episode_for_artists(generators: Sequence[torch.Generator],
                               data: CorpusOnDevice, artists: torch.Tensor,
                               *, k: int, q: int) -> Episode:
    """Episodes for GIVEN artist ids (serving: per-request artists).

    generators: one CPU torch.Generator per row; artists [B] int."""
    if k + q > data.artist_song_ids.shape[1]:
        raise ValueError(
            f"episode needs k+q={k + q} songs but the corpus's largest "
            f"artist has only {data.artist_song_ids.shape[1]}")
    artists = torch.as_tensor(artists, dtype=torch.int64,
                              device=data.songs.device)
    counts = data.artist_num_songs[artists].tolist()
    if len(generators) != len(counts):
        raise ValueError("need one generator per row")
    slots = torch.stack([_choose_songs(g, int(n), k + q)
                         for g, n in zip(generators, counts)])
    slots = slots.to(data.songs.device)
    song_ids = data.artist_song_ids[artists[:, None], slots]   # [B, k+q]
    return gather_episode(data, song_ids, artists, k, q)


def gather_episode(data: CorpusOnDevice, song_ids: torch.Tensor,
                   artist: torch.Tensor, k: int, q: int) -> Episode:
    """Materialize an Episode from explicit song indices [B, k+q]."""
    song_ids = torch.as_tensor(song_ids, dtype=torch.int64,
                               device=data.songs.device)
    tokens = data.songs[song_ids]
    lens = data.song_len[song_ids]
    return Episode(support=tokens[:, :k], support_len=lens[:, :k],
                   query=tokens[:, k:], query_len=lens[:, k:],
                   artist=torch.as_tensor(artist, device=data.songs.device))
