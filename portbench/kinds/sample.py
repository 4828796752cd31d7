"""Offline batch sampling: a closed loop of back-to-back calls of the
program's ``sampling.generate``, each over jobs x continuations rows.

A call draws `jobs` episodes of the test split's artists (the benchmark's
own draw, ``reference/episodes.py``, from the call's seed), repeats each
job's support songs over its `continuations` rows, gives every row a
generator of its own, decodes `tokens` tokens and copies them to the host.
The first continuation of every job decodes greedily (temperature 0): the
reference judges those rows.  Set-up makes one call of the same shapes.

Traffic parameters (traffic/<mix>.json): jobs, continuations, tokens,
check_rows (greedy rows the reference reads after the window), trace_calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.reference import check, episodes as ref_eps, model as ref

# a call's seed and each row's generator seed from the run's sub-seed
CALL_STRIDE, ROW_STRIDE = 7919, 1_000_003

# the CPU tests' tiny mix, and the on-card control test's fewer rows
TINY = {"jobs": 4, "continuations": 2, "tokens": 12, "check_rows": 8,
        "trace_calls": 1}
SMALL = {"jobs": 4, "continuations": 8, "check_rows": 8}


class Run:
    def __init__(self, cell, seed: int, device, corpus_root):
        self.cell, self.device = cell, torch.device(device)
        s_w, self.s_calls, self.s_check = inputs.sub_seeds(seed, 3)
        corpus = inputs.corpus(cell.config["corpus"], corpus_root)
        self.vocab = len(corpus.vocab)
        self.cfg = program.config(cell.config, self.vocab, corpus.max_len)
        self.spec = dict(cell.config, max_len=corpus.max_len)
        self.data = ref_eps.corpus_tensors(corpus, self.device)
        self.split = torch.as_tensor(np.asarray(corpus.splits["test"]),
                                     dtype=torch.int64, device=self.device)
        w = inputs.weights(cell.config, self.vocab, s_w, self.device)
        self.w0 = program.clone(w)
        self.params = program.model(cell.config, self.cfg, w)
        t = cell.traffic
        self.jobs, self.cont = int(t["jobs"]), int(t["continuations"])
        self.tokens = int(t["tokens"])
        self.kept = []      # (song ids [J, K+Q], greedy rows' tokens [J, n])
        self.bad_calls = 0  # calls that returned an id outside the vocab
        self.returned = self.decoded = 0    # tokens of the kept calls

    def call(self, index: int):
        """One sampling call; returns (tokens [rows, n] on the host, the
        jobs' song ids on the host)."""
        from fewshot_torch import sampling
        seed = (self.s_calls + index * CALL_STRIDE) % 2 ** 63
        k = self.cfg.support_size
        d = ref_eps.device_draw(
            torch.Generator(device=self.device).manual_seed(seed), self.data,
            self.split, self.jobs, k, self.cfg.query_size)
        ep = ref_eps.gather(self.data, d["song_ids"], k)
        rows = self.jobs * self.cont
        support = ep["support"].repeat_interleave(self.cont, 0)
        support_len = ep["support_len"].repeat_interleave(self.cont, 0)
        temps = torch.full((rows,), float(self.cfg.temperature),
                           device=self.device)
        temps[::self.cont] = 0.0
        gens = [torch.Generator(device=self.device).manual_seed(
            (seed * ROW_STRIDE + r) % 2 ** 63) for r in range(rows)]
        toks = sampling.generate(self.params, support, support_len, gens,
                                 self.cfg, n_tokens=self.tokens,
                                 temperature=temps)
        return toks.cpu(), d["song_ids"].cpu()

    def keep(self, toks, ids) -> int:
        """Keep a call's greedy rows for the check; its returned tokens."""
        self.kept.append((ids, toks[::self.cont].clone()))
        self.bad_calls += int(bool(((toks < 0) | (toks >= self.vocab)).any()))
        returned = int(check.row_lengths(toks, ref.EOS).sum())
        self.returned += returned
        self.decoded += toks.numel()
        return returned

    def decode_steps(self, toks) -> int:
        """Decode steps the call ran: all, unless every row ended and the
        loop's early exit (tested every 8 tokens) cut it."""
        n = toks.shape[1]
        ended = (toks == ref.EOS).any(1)
        if not bool(ended.all()):
            return n
        m = int(check.row_lengths(toks, ref.EOS).max())
        return min(n, max(8, -(-m // 8) * 8))

    def window(self, seconds: float):
        calls, tokens = 0, 0
        t0 = time.perf_counter()
        while True:
            toks, ids = self.call(calls)
            tokens += self.keep(toks, ids)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return calls, tokens, time.perf_counter() - t0

    def traced(self, calls: int):
        """Two profiled windows of `calls` calls each (device activity
        alone, then with host operations), and what the first one's calls
        returned; every call's rows are kept for the check."""
        from portbench.trace import profiled
        got = []

        def go():
            for _ in range(calls):
                got.append(self.call(len(got)))
        trace = profiled(go, self.device)
        host_trace = profiled(go, self.device, host=True)
        for toks, ids in got:
            self.keep(toks, ids)
        info = [{"decode_steps": self.decode_steps(toks),
                 "row_tokens": check.row_lengths(toks, ref.EOS).numpy(),
                 "support_len": self.support_len(ids).repeat(self.cont,
                                                             axis=0)}
                for toks, ids in got[:calls]]
        return trace, host_trace, info

    def support_len(self, ids) -> np.ndarray:
        k = self.cfg.support_size
        return self.data["song_len"][ids[:, :k].to(self.device)].cpu().numpy()

    def release(self) -> None:
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def sample_rows(self) -> list:
        """(call, job) of the greedy rows the reference reads: drawn from
        the seed, the longest row among them."""
        rows = [(c, j) for c, (_, t) in enumerate(self.kept)
                for j in range(t.shape[0])]
        rng = np.random.default_rng(self.s_check)
        n = min(int(self.cell.traffic["check_rows"]), len(rows))
        pick = [rows[i] for i in rng.choice(len(rows), n, replace=False)]
        lens = {r: int(check.row_lengths(self.kept[r[0]][1][r[1]:r[1] + 1],
                                         ref.EOS)[0]) for r in rows}
        longest = max(rows, key=lambda r: lens[r])
        if longest not in pick:
            pick[0] = longest
        return pick

    def rows_of(self, pick):
        k = self.cfg.support_size
        ids = torch.stack([self.kept[c][0][j] for c, j in pick])
        toks = torch.stack([self.kept[c][1][j] for c, j in pick])
        ep = ref_eps.gather(self.data, ids.to(self.device), k)
        return ep["support"], ep["support_len"], toks.to(self.device)

    def reference_logp(self, pick, rnd=ref.exact, chunk: int = 8, **fault):
        ref.strict_fp32()
        support, slen, toks = self.rows_of(pick)
        out = []
        with torch.no_grad():
            for lo in range(0, len(pick), chunk):
                sl = slice(lo, lo + chunk)
                out.append(ref.served_logp(self.w0, self.spec, support[sl],
                                           slen[sl], toks[sl], rnd, **fault))
        return torch.cat(out), toks

    def numbers(self, control: bool = False) -> dict:
        """served_gap of the sampled greedy rows, and the share of the
        decoded positions that the calls returned (not compared); with
        control, the gaps of the tokens that the control and the cache's
        faults (the reference put in the program's place) put first."""
        pick = self.sample_rows()
        logp, toks = self.reference_logp(pick)
        lens = check.row_lengths(toks, ref.EOS)
        out = {"served_gap": check.served_gap(logp, toks, lens),
               "rows": len(pick), "tokens": int(lens.sum()),
               "returned_share": self.returned / max(self.decoded, 1)}
        if control:
            for name, kw in (("control_gap", {"rnd": ref.fp8}),
                             ("no_cache_gap", {"cache": False}),
                             ("static_cache_gap", {"dynamic": False})):
                other, _ = self.reference_logp(pick, **kw)
                out[name] = check.control_gap(logp, other, lens)
        return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        corpus_root, t_start: float) -> dict:
    r = Run(cell, seed, device, corpus_root)
    r.call(-1)                                   # warm the call's shapes
    program.synchronize(r.device)
    out = {}
    if trace:
        calls = int(cell.traffic["trace_calls"])
        tr, host_tr, info = r.traced(calls)
        out["ctx"] = {"kind": "sample", "spec": r.spec, "vocab": r.vocab,
                      "trace": tr, "host_trace": host_tr, "calls": info,
                      "window_s": tr.window_s, "busy_s": tr.busy_s()}
        out["attempted"] = 2 * calls
    else:
        setup_s = time.perf_counter() - t_start
        calls, tokens, elapsed = r.window(seconds)
        out["attempted"] = calls
        out["e2e"] = {"sample_tokens_per_s": tokens / elapsed,
                      "setup_s": setup_s}
    out["failed"] = r.bad_calls
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(r.device)
                                if r.device.type == "cuda" else 0)
    r.release()
    out["numbers"] = r.numbers()
    return out


def readings(cell, seed: int, control: bool, device, corpus_root,
             calls: int = 2) -> dict:
    """The numbers of one seed for ``portbench.prove``, over `calls` calls
    at the cell's load: "program", and with control also "control" and
    the faults "no_cache" and "static_cache"."""
    r = Run(cell, seed, device, corpus_root)
    for i in range(calls):
        r.keep(*r.call(i))
    r.release()
    nums = r.numbers(control=control)
    out = {"program": {k: nums[k] for k in ("served_gap", "rows", "tokens",
                                            "returned_share")}}
    if control:
        out["control"] = {"served_gap": nums["control_gap"]}
        out["no_cache"] = {"served_gap": nums["no_cache_gap"]}
        out["static_cache"] = {"served_gap": nums["static_cache_gap"]}
    return out
