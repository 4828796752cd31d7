"""Episode draws, worked out again from the generator's seed.

The train step draws its episodes on the device from the generator that
the benchmark seeds (``TrainState.gen``).  ``device_draw`` is a frozen
copy of that draw's algorithm (a uniform artist of the split, then the
top K+Q of masked Gumbel noise over the artist's song slots, overflow
ranks uniform with replacement): with a generator on the same device in
the same state it picks the same songs, so the reference scores the
episodes the program trained on without reading them from the program.
The sample cells draw their episodes with this same function, as the
benchmark's own traffic.
"""

from __future__ import annotations

import numpy as np
import torch


def corpus_tensors(corpus, device) -> dict:
    """The packed corpus's arrays on `device` (int64)."""
    def put(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)
    return {"songs": put(corpus.songs), "song_len": put(corpus.song_len),
            "artist_song_ids": put(corpus.artist_song_ids),
            "artist_num_songs": put(corpus.artist_num_songs)}


def device_draw(gen: torch.Generator, data: dict, split: torch.Tensor,
                batch: int, k: int, q: int) -> dict:
    """Song ids [B, K+Q] and artists [B] of one batch of episodes."""
    n_songs = k + q
    width = data["artist_song_ids"].shape[1]
    dev = data["songs"].device
    pick = torch.randint(0, split.shape[0], (batch,), generator=gen,
                         device=dev)
    artists = split[pick]
    rows = data["artist_song_ids"][artists]
    n = data["artist_num_songs"][artists]
    u = torch.rand((batch, width), generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    slot = torch.arange(width, device=dev)
    scores = torch.where(slot < n[:, None], gumbel,
                         torch.full_like(gumbel, -float("inf")))
    slots = scores.topk(n_songs, dim=1).indices
    u = torch.rand((batch, n_songs), generator=gen, device=dev)
    n_valid = n.clamp_min(1)[:, None]
    fallback = torch.minimum((u * n_valid).long(), n_valid - 1)
    ranks = torch.arange(n_songs, device=dev)
    slots = torch.where(ranks < n[:, None], slots, fallback)
    return {"song_ids": rows.gather(1, slots), "artist": artists}


def gather(data: dict, song_ids: torch.Tensor, k: int) -> dict:
    """Support and query tokens and lengths of song ids [B, K+Q]."""
    tok = data["songs"][song_ids]
    lens = data["song_len"][song_ids]
    return {"support": tok[:, :k], "support_len": lens[:, :k],
            "query": tok[:, k:], "query_len": lens[:, k:]}
