"""Host-streaming episode pipeline for corpora too large for the device.

Port of ``fewshot/data/host_pipeline.py``.  The packed corpus stays in host
RAM; a background thread assembles [B, K+Q, L] episode batches with numpy
(only the selected songs cross PCIe, not the corpus) and hands them to the
device ahead of the step that reads them.  The train step takes the episode
as an argument (``training.make_fed_train_step``).

The draws are the JAX package's: ``np.random.RandomState(seed)``, a
uniform artist of the split, K+Q of its songs without replacement (a
permutation of a short pool, then draws with replacement), in the same
order of calls, so the same seed gives the same episodes array for array.

The card side:

* the producer writes each batch into one of ``prefetch + 1`` pinned host
  buffers, allocated once (``cudaHostAlloc`` per batch would be slow), as
  int32, the five arrays back to back;
* it copies the buffer to the device with ``non_blocking=True`` on a side
  stream of the pipeline's device, widens it to int64 there (the port's
  ``Episode`` holds int64: the copy moves half the bytes), and records an
  event after both;
* a pinned buffer is written again only after its event has completed;
* ``__next__`` makes the consumer's current stream wait on the event and
  calls ``record_stream`` on each tensor, so that the caching allocator
  does not hand the memory back to the side stream while the step reads
  it.

On the CPU there is no pinning and no stream; the batches are the same.

Data parallelism: ``rank`` and ``world`` split the batch as JAX's
``NamedSharding(mesh, P("data"))`` splits a process-identical host array:
every rank draws the same full batch from the same seed and keeps rows
[r B/W, (r+1) B/W); only those rows are copied.  ``batch`` stays the full
batch size (``training.evaluate_fed`` counts draws by it).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from fewshot_torch.data.episodes import Episode
from fewshot_torch.device import resolve_device


class HostEpisodePipeline:
    """Background-threaded episode prefetcher over a host-resident corpus."""

    def __init__(self, corpus, split: str, batch_size: int, k: int, q: int,
                 seed: int = 0, prefetch: int = 2,
                 device: torch.device | str | None = None, rank: int = 0,
                 world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{world} processes")
        self.corpus = corpus
        self.batch = batch_size
        self.k, self.q = k, q
        self.device = resolve_device(device)
        self.rows = batch_size // world
        self._lo = rank * self.rows
        self._rng = np.random.RandomState(seed)
        self._artists = [int(a) for a in corpus.splits[split]]
        self._songs_of = {
            a: corpus.artist_song_ids[a][: int(corpus.artist_num_songs[a])]
            for a in self._artists}
        n, length = k + q, corpus.max_len
        b = self.rows
        # int32 fields of one batch, back to back in one buffer
        self._shapes = [(b, k, length), (b, k), (b, q, length), (b, q), (b,)]
        self._sizes = [int(np.prod(s)) for s in self._shapes]
        self._numel = b * n * (length + 1) + b
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._ring = prefetch + 1
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- host-side assembly ---------------------------------------------------

    def _one_episode(self):
        artist = self._artists[self._rng.randint(len(self._artists))]
        pool = self._songs_of[artist]
        n = self.k + self.q
        if len(pool) >= n:
            ids = self._rng.choice(pool, size=n, replace=False)
        else:
            ids = np.concatenate([
                self._rng.permutation(pool),
                self._rng.choice(pool, size=n - len(pool))])
        return ids, artist

    def _make_batch(self, out: np.ndarray) -> None:
        """Draw the full batch (every rank draws all of it, so the random
        stream is the same) and write this rank's rows into `out`."""
        c = self.corpus
        song_ids = np.zeros((self.batch, self.k + self.q), np.int32)
        artists = np.zeros((self.batch,), np.int32)
        for b in range(self.batch):
            song_ids[b], artists[b] = self._one_episode()
        song_ids = song_ids[self._lo:self._lo + self.rows]
        tokens = c.songs[song_ids]          # [b, K+Q, L] gather on host
        lens = c.song_len[song_ids]
        fields = (tokens[:, : self.k], lens[:, : self.k],
                  tokens[:, self.k:], lens[:, self.k:],
                  artists[self._lo:self._lo + self.rows])
        pos = 0
        for f, size in zip(fields, self._sizes):
            out[pos:pos + size] = np.asarray(f, np.int32).reshape(-1)
            pos += size

    def _episode(self, flat: torch.Tensor) -> Episode:
        parts = torch.split(flat, self._sizes)
        return Episode(*(p.view(s) for p, s in zip(parts, self._shapes)))

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            if self.device.type == "cuda":
                self._produce_cuda()
            else:
                while not self._stop.is_set():
                    host = np.empty(self._numel, np.int32)
                    self._make_batch(host)
                    flat = torch.from_numpy(host).to(torch.int64)
                    if not self._put((self._episode(flat), None)):
                        return
        except Exception as e:              # noqa: BLE001 - raised in __next__
            self._put((None, e))

    def _produce_cuda(self) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream(self.device)
            ring = [torch.empty(self._numel, dtype=torch.int32,
                                pin_memory=True) for _ in range(self._ring)]
            done: list = [None] * self._ring
            i = 0
            while not self._stop.is_set():
                slot = i % self._ring
                if done[slot] is not None:
                    done[slot].synchronize()    # its last copy has landed
                self._make_batch(ring[slot].numpy())
                with torch.cuda.stream(stream):
                    flat = ring[slot].to(self.device, non_blocking=True)
                    flat = flat.to(torch.int64)
                    event = torch.cuda.Event()
                    event.record(stream)
                done[slot] = event
                if not self._put((self._episode(flat), event)):
                    return
                i += 1

    # -- consumer ---------------------------------------------------------------

    def __next__(self) -> Episode:
        ep, event = self._queue.get()
        if ep is None:
            raise RuntimeError("the episode producer failed") from event
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for x in ep:
                x.record_stream(current)
        return ep

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
