"""Episode assembly: song choice, then one gather on the device.

Port of ``fewshot/data/episodes.py`` (``put_corpus``, ``_choose_songs``,
``sample_episode``, ``sample_episode_for_artists``, ``sample_lm_batch``,
``split_song_pool``, ``base_token_ratio``, the fixed episode sets
``save_episode_set`` / ``load_episode_set``, ``gather_episode``).  The
packed corpus is moved to the device once; an episode is then a gather of
song rows.

Song choice follows the JAX sampler's semantics: an artist with at least
K+Q songs gives K+Q distinct songs, uniformly without replacement; for an
artist with fewer, the first n ranks are a permutation of its n songs and
the overflow ranks draw with replacement.

Two samplers.  Serving (``sample_episode_for_artists``) draws each row from
its own CPU ``torch.Generator``, so a seed picks the same songs on any
device and a row's episode is independent of its batch neighbours.
Training (``sample_episode``) runs as torch ops on the corpus device from
one generator on that device: a uniform artist of the split, then the
top-(K+Q) of Gumbel noise over the artist's valid song slots, with no host
synchronisation, so a train step can later be captured in a CUDA graph.
The random numbers differ from JAX's threefry streams for the same seed.
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


def sample_episode(gen: torch.Generator, data: CorpusOnDevice,
                   split_artists: torch.Tensor, batch_size: int, *, k: int,
                   q: int) -> Episode:
    """A meta-batch of episodes, sampled on the corpus device.

    gen: a generator on the corpus device; split_artists [A_split] int64
    artist ids on that device.  Per row: a uniform artist of the split,
    then K+Q song slots as the top of masked Gumbel noise (distinct, uniform
    without replacement); ranks past the artist's song count draw uniformly
    with replacement.  Returns an Episode with support [B,k,L], query
    [B,q,L]."""
    n_songs = k + q
    width = data.artist_song_ids.shape[1]
    if n_songs > width:
        raise ValueError(
            f"episode needs k+q={n_songs} songs but the corpus's largest "
            f"artist has only {width}")
    dev = data.songs.device
    pick = torch.randint(0, split_artists.shape[0], (batch_size,),
                         generator=gen, device=dev)
    artists = split_artists[pick]                               # [B]
    rows = data.artist_song_ids[artists]                        # [B, M]
    n = data.artist_num_songs[artists]                          # [B]
    u = torch.rand((batch_size, width), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    slot_ids = torch.arange(width, device=dev)
    scores = torch.where(slot_ids < n[:, None], gumbel,
                         torch.full_like(gumbel, -float("inf")))
    slots = scores.topk(n_songs, dim=1).indices                 # [B, k+q]
    # overflow ranks (fewer than k+q songs): uniform with replacement
    u = torch.rand((batch_size, n_songs), generator=gen, device=dev)
    n_valid = n.clamp_min(1)[:, None]
    fallback = torch.minimum((u * n_valid).long(), n_valid - 1)
    ranks = torch.arange(n_songs, device=dev)
    slots = torch.where(ranks < n[:, None], slots, fallback)
    song_ids = rows.gather(1, slots)
    return gather_episode(data, song_ids, artists, k, q)


def sample_lm_batch(gen: torch.Generator, data: CorpusOnDevice,
                    song_pool: torch.Tensor, batch_size: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """A plain LM batch: B songs uniform over a split's song pool, on the
    corpus device.  Returns (tokens [B, L], lengths [B])."""
    pick = torch.randint(0, song_pool.shape[0], (batch_size,), generator=gen,
                         device=data.songs.device)
    ids = song_pool[pick]
    return data.songs[ids], data.song_len[ids]


def split_song_pool(corpus, split: str) -> np.ndarray:
    """Host-side: all song ids whose artist belongs to `split` (int32)."""
    artists = set(int(a) for a in corpus.splits[split])
    mask = np.array([int(a) in artists for a in corpus.song_artist])
    return np.nonzero(mask)[0].astype(np.int32)


def base_token_ratio(corpus, split: str | None = None,
                     song_ids: np.ndarray | None = None) -> float:
    """targets(BPE) / targets(base): the factor that turns an NLL per BPE
    token into one per base token (exact in expectation over episodes),
    over a split's song pool or over explicit song ids (a fixed set's query
    songs).  1.0 for a corpus without merges."""
    if not (corpus.merges and corpus.base_song_len is not None):
        return 1.0
    pool = song_ids if song_ids is not None else split_song_pool(corpus,
                                                                 split)
    bpe_t = np.maximum(corpus.song_len[pool] - 1, 0).sum()
    base_t = np.maximum(corpus.base_song_len[pool] - 1, 0).sum()
    return float(bpe_t) / max(float(base_t), 1.0)


def save_episode_set(path, corpus, split: str, n: int, k: int, q: int,
                     seed: int = 0) -> None:
    """Draw n episodes' song indices on the host and save them (npz).

    The draws are the JAX package's (``np.random.RandomState(seed)``), so
    both packages write the same arrays for the same seed, and a set frozen
    by either scores in both: an evaluation on a set is the same across
    runs, batch sizes and sampler changes."""
    rng = np.random.RandomState(seed)
    artists = np.asarray(corpus.splits[split])
    song_ids = np.zeros((n, k + q), np.int32)
    ep_artist = np.zeros((n,), np.int32)
    for i in range(n):
        a = int(artists[rng.randint(len(artists))])
        row = corpus.artist_song_ids[a][: int(corpus.artist_num_songs[a])]
        take = rng.choice(len(row), size=min(k + q, len(row)),
                          replace=False)
        while len(take) < k + q:
            take = np.concatenate([take, rng.choice(len(row), size=1)])
        song_ids[i] = row[take]
        ep_artist[i] = a
    np.savez(path, song_ids=song_ids, artist=ep_artist,
             k=np.int32(k), q=np.int32(q), split=np.str_(split))


def load_episode_set(path) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(song_ids [N, k+q], artist [N], k, q) of a saved episode set."""
    z = np.load(path, allow_pickle=False)
    return z["song_ids"], z["artist"], int(z["k"]), int(z["q"])


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
