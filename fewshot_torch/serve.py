"""Serving tier: few-shot continuations over HTTP from one or more devices.

Port of ``fewshot/serve.py`` (LSTM or transformer; lyrics or MIDI).  One
process loads the corpus and parameters once, warms the sampler, and
serves:

    GET  /healthz                    -> {"status": "ok", ...}
    POST /generate                   -> {"continuations": [...]}
        {"artist": <name or id>,     # support drawn from this artist, or
         "episode_seed": 0,          #   a random split artist if omitted
         "num": 4,                   # continuations (padded to batch size)
         "temperature": 0.8,         # optional, per request
         "split": "test"}

Concurrent requests are coalesced by one batching worker thread into a call
of the fixed batch size; the HTTP layer is the stdlib ThreadingHTTPServer,
so health checks never wait behind generation.  Each row's episode and
noise come from generators seeded by the row's own seed, so a request's
output does not depend on what it was batched with.

Models with the cache head (``support_cache``) sample from its mixture.
A MIDI model (``dataset: midi``) samples under the event grammar's masks
(``grammar_sampling``; not for a BPE corpus, whose merged tokens span
phases) and answers with each continuation's ``events`` and its count of
decoded ``notes`` in place of ``text``; BPE tokens are expanded to base
tokens first.
Run: ``python -m fewshot_torch.serve --data … --model … --task …
[--checkpt_dir DIR] [--serve_batch N] [--device cuda|cpu] [--set K=V …]``;
DIR is a training run's checkpoint directory (its latest step is served)
or a directory holding a bare ``params.npz``.

Several cards (``Generator(devices=[...])``; ``serve_main`` takes every
visible card under ``data_parallel``): the batch is rounded up to a
multiple of the device count and its rows are split into contiguous
chunks, one a device; each chunk's episode draw, support pass and decode
run on its device against that device's replica of the parameters (and of
the grammar masks), and the outputs are concatenated in row order.  The
chunks of distinct devices decode at the same time, one thread a device
(the decode waits on its device every few steps, so one thread would run
the devices one after another); chunks that share a device run in turn,
since a persistent kernel needs its card to itself.  The
per-row generators make a row's tokens independent of the layout, so they
equal the single-device output token for token where a device gets as
many rows as the single device does; in bf16 on the card a GEMM over
another row count can round differently (cuBLAS picks its kernel by
shape) and move a sampled token near a tie.  Serving is one process:
launched with the ``FEWSHOT_*`` variables of several processes it exits,
as the JAX server does.
"""

from __future__ import annotations

import contextlib
import copy
import json
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from fewshot_torch import sampling as sampling_mod
from fewshot_torch.data import episodes as eps
from fewshot_torch.data import midi as midi_mod
from fewshot_torch.data.lyrics import detokenize
from fewshot_torch.device import resolve_device
from fewshot_torch.models import lm as lm_mod


class _Request:
    """One /generate call waiting for its rows of a batched device call.
    latency: seconds from its submission to its result; queue_s: the part
    of it before its batch's device call began."""

    __slots__ = ("num", "artist_id", "split", "seed", "temperature",
                 "event", "toks", "artists", "t_submit", "queue_s",
                 "latency", "error")

    def __init__(self, num, artist_id, split, seed, temperature):
        self.num = num
        self.artist_id = artist_id
        self.split = split
        self.seed = seed
        self.temperature = temperature
        self.event = threading.Event()
        self.toks = self.artists = self.latency = self.error = None
        self.t_submit = time.perf_counter()
        self.queue_s = None


class Generator:
    """The warm sampler behind the HTTP handler, with request batching.

    The first queued request opens a window of `batch_deadline_ms`; what
    arrives in time shares one device call.  Unused rows are padded with
    the first request's artist and temperature.  device=None means CUDA
    (and raises without a card); `devices`, a list, shards each batch's
    rows over those devices (the module docstring)."""

    def __init__(self, cfg, corpus, params, batch_size: int | None = None,
                 batch_deadline_ms: float = 5.0,
                 device: torch.device | str | None = None,
                 devices: list | None = None):
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        lm_mod.check_supported(cfg)
        self.cfg = cfg
        self.corpus = corpus
        n = len(self.devices)
        self.batch = -(-(batch_size or max(4, cfg.batch_size)) // n) * n
        self.deadline = batch_deadline_ms / 1e3
        # one replica of the parameters, corpus and masks per device (the
        # first device's parameters are the caller's module, moved)
        self._replicas = [
            (params.to(d) if i == 0 else copy.deepcopy(params).to(d),
             eps.put_corpus(corpus, d),
             sampling_mod.grammar_masks(cfg, corpus, d))
            for i, d in enumerate(self.devices)]
        self.params, self.data, self.token_masks = self._replicas[0]
        # the chunks of each distinct device, decoded by one thread each
        self._groups: dict = {}
        for i, d in enumerate(self.devices):
            self._groups.setdefault(d, []).append(i)
        self._pool = (ThreadPoolExecutor(len(self._groups))
                      if len(self._groups) > 1 else None)
        self.splits = {k: np.asarray(v) for k, v in corpus.splits.items()}
        self._artist_index = {name: i for i, name
                              in enumerate(corpus.artist_names)}
        self._queue: "queue.Queue[_Request | None]" = queue.Queue()
        self._carry: _Request | None = None
        self._worker = threading.Thread(target=self._batch_worker,
                                        daemon=True)
        self._worker.start()
        self.warm_s = self._warmup()

    def close(self) -> None:
        """Stop the batching worker (requests after this never complete)."""
        self._queue.put(None)
        self._worker.join(timeout=60)
        if self._pool is not None:
            self._pool.shutdown()

    # -- device call over fully per-row specs ---------------------------------

    def _run_batch(self, artists: np.ndarray, seeds: np.ndarray,
                   temps: np.ndarray) -> np.ndarray:
        rows = len(seeds) // len(self.devices)

        def run_group(dev, chunks):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                return [self._run_chunk(
                    dev, *self._replicas[i], artists[i * rows:(i + 1) * rows],
                    seeds[i * rows:(i + 1) * rows],
                    temps[i * rows:(i + 1) * rows]).cpu().numpy()
                    for i in chunks]
        if self._pool is None:
            outs = [run_group(d, c) for d, c in self._groups.items()]
        else:
            outs = [f.result() for f in [self._pool.submit(run_group, d, c)
                                         for d, c in self._groups.items()]]
        by_chunk = {}
        for chunks, out in zip(self._groups.values(), outs):
            by_chunk.update(zip(chunks, out))
        return np.concatenate([by_chunk[i] for i in range(len(by_chunk))])

    def _run_chunk(self, dev, params, data, masks, artists, seeds, temps):
        """One device's rows: the episode draw, support pass and decode."""
        ep_gens = [sampling_mod.row_generator(s, 0) for s in seeds]
        gen_gens = [sampling_mod.row_generator(s, 1, dev) for s in seeds]
        ep = eps.sample_episode_for_artists(
            ep_gens, data, torch.as_tensor(artists),
            k=self.cfg.support_size, q=self.cfg.query_size)
        return sampling_mod.generate(
            params, ep.support, ep.support_len, gen_gens, self.cfg,
            temperature=torch.as_tensor(temps, device=dev),
            token_masks=masks)

    def _row_specs(self, req: _Request, rng: np.random.RandomState):
        """Resolve one request into per-row (artist, seed, temp) arrays."""
        if req.artist_id is not None:
            artists = np.full(req.num, req.artist_id, np.int32)
        else:
            pool = self.splits[req.split]
            artists = rng.choice(pool, size=req.num).astype(np.int32)
        seeds = np.full(req.num, req.seed, np.int64) + np.arange(req.num)
        temp = (self.cfg.temperature if req.temperature is None
                else req.temperature)
        return artists, seeds, np.full(req.num, temp, np.float32)

    def _collect(self, first: _Request) -> list[_Request]:
        """Requests that share one call: `first` plus what arrives in time."""
        reqs = [first]
        rows = first.num
        deadline = time.perf_counter() + self.deadline
        while rows < self.batch:
            remain = deadline - time.perf_counter()
            if remain <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remain)
            except queue.Empty:
                break
            if nxt is None:                   # close(): finish this batch
                self._queue.put(None)
                break
            if rows + nxt.num > self.batch:
                self._carry = nxt             # runs in the next batch
                break
            reqs.append(nxt)
            rows += nxt.num
        return reqs

    def _batch_worker(self) -> None:
        while True:
            first = self._carry or self._queue.get()
            self._carry = None
            if first is None:
                return
            reqs = self._collect(first)
            try:
                specs = [self._row_specs(
                    r, np.random.RandomState(r.seed & 0x7FFFFFFF))
                    for r in reqs]
                artists = np.concatenate([s[0] for s in specs])
                seeds = np.concatenate([s[1] for s in specs])
                temps = np.concatenate([s[2] for s in specs])
                pad = self.batch - len(artists)
                if pad > 0:
                    artists = np.concatenate([artists,
                                              np.repeat(artists[:1], pad)])
                    seeds = np.concatenate([seeds, seeds[:1] + 7777
                                            + np.arange(pad)])
                    temps = np.concatenate([temps,
                                            np.repeat(temps[:1], pad)])
                t0 = time.perf_counter()
                for r in reqs:
                    r.queue_s = t0 - r.t_submit
                toks = self._run_batch(artists, seeds, temps)
                pos = 0
                for r in reqs:
                    r.toks = toks[pos:pos + r.num]
                    r.artists = artists[pos:pos + r.num]
                    pos += r.num
            except Exception as e:                        # noqa: BLE001
                # the worker must outlive a failed batch; each waiting
                # request re-raises the error in its own thread
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.event.set()

    def _warmup(self) -> float:
        t0 = time.perf_counter()
        self._submit(1, None, next(iter(self.splits)), 0, None)
        return time.perf_counter() - t0

    def _submit(self, num, artist_id, split, seed, temperature) -> _Request:
        req = _Request(num, artist_id, split, seed, temperature)
        self._queue.put(req)
        req.event.wait()
        req.latency = time.perf_counter() - req.t_submit
        if req.error is not None:
            raise req.error
        return req

    def generate(self, num: int, split: str = "test",
                 artist: str | int | None = None, episode_seed: int = 0,
                 temperature: float | None = None) -> list[dict]:
        artist_id = None
        if artist is not None:
            if isinstance(artist, str) and not artist.isdigit():
                if artist not in self._artist_index:
                    raise KeyError(f"unknown artist {artist!r}")
                artist_id = self._artist_index[artist]
            else:
                artist_id = int(artist)
                if not 0 <= artist_id < self.corpus.num_artists:
                    raise KeyError(f"artist id {artist_id} out of range")
        if split not in self.splits:
            raise KeyError(f"unknown split {split!r}")
        num = max(1, min(num, self.batch))

        req = self._submit(num, artist_id, split, episode_seed, temperature)
        out = []
        for i in range(num):
            words = self.corpus.decode(req.toks[i])
            a = int(req.artists[i])
            name = (self.corpus.artist_names[a]
                    if self.corpus.artist_names else str(a))
            rec = {"artist": name, "tokens": len(words),
                   "latency_s": round(req.latency, 4),
                   "queue_s": round(req.queue_s, 4)}
            if self.cfg.dataset == "midi":
                rec["events"] = words
                rec["notes"] = len(midi_mod.events_to_notes(words))
            else:
                rec["text"] = detokenize(words)
            out.append(rec)
        return out


def make_handler(gen: Generator):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "model": gen.cfg.model,
                                  "dataset": gen.cfg.dataset,
                                  "device": str(gen.device),
                                  "batch": gen.batch,
                                  "warmup_s": round(gen.warm_s, 2)})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                temp = req.get("temperature")
                outs = gen.generate(
                    num=int(req.get("num", 1)),
                    split=req.get("split", "test"),
                    artist=req.get("artist"),
                    episode_seed=int(req.get("episode_seed", 0)),
                    temperature=float(temp) if temp is not None else None)
                self._reply(200, {"continuations": outs})
            except KeyError as e:
                self._reply(400, {"error": str(e)})
            except (TypeError, ValueError) as e:      # incl. JSONDecodeError
                self._reply(400, {"error": f"bad request: {e}"})
            except Exception as e:                        # noqa: BLE001
                # device-side failures must still get an HTTP response,
                # never a dropped connection
                self._reply(500, {"error": f"internal error: {e}"})

    return Handler


def serve(gen: Generator, host: str = "127.0.0.1", port: int = 8476
          ) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(gen))


def serve_main(argv=None) -> None:
    from fewshot_torch.cli import _setup
    from fewshot_torch.parallel.distributed import process_count
    from fewshot_torch.utils.ckpt import hparams_of, restore_params

    def flags(p):
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, default=8476)
        p.add_argument("--serve_batch", type=int, default=None)
    args, cfg, corpus = _setup(argv, flags)
    if process_count() > 1:
        # each server's own HTTP stream would drive divergent collectives
        sys.exit("fewshot_torch.serve is one process; launch it without "
                 "FEWSHOT_COORDINATOR / FEWSHOT_NUM_PROCESSES (serving "
                 "shards its rows over the local cards instead)")
    device = resolve_device(args.device)
    # data_parallel on a bare "cuda" shards the rows over every visible card
    where = {"device": device}
    if cfg.data_parallel and device.type == "cuda" and device.index is None \
            and torch.cuda.device_count() > 1:
        where = {"devices": [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())]}
    if args.checkpt_dir:
        # the latest step of a training run's directory, or a bare
        # params.npz; another vocab raises, other semantic hparams warn
        params = restore_params(
            args.checkpt_dir, device,
            corpus.vocab.content_hash() if corpus.vocab else "",
            hparams_of(cfg))
        if params is None:
            sys.exit(f"no checkpoint found in {args.checkpt_dir}")
    else:
        params = lm_mod.init_lm(cfg, len(corpus.vocab),
                                torch.Generator().manual_seed(cfg.seed),
                                device)
    gen = Generator(cfg, corpus, params, args.serve_batch, **where)
    server = serve(gen, args.host, args.port)
    print(f"serving on http://{args.host}:{args.port} "
          f"(devices {', '.join(map(str, gen.devices))}, warmup "
          f"{gen.warm_s:.1f}s, batch {gen.batch})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    serve_main()
