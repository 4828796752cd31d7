"""Training traffic: the program's train step on its device sampler, in
calls of ``make_multi_step`` (steps_per_call steps a call), back to back.

Set-up builds one train state from the seed (the benchmark's weights, the
optimizer's state, the sampler's generator) and one step function, drives
them through the first ``check_steps`` steps in calls that the window's
factory (``make_multi_step``) builds, and hands the same state to the
window.  The reference follows those first steps from the same weights on
the same episodes: it draws them again from the generator's seed
(``reference/episodes.py``).

Traffic parameters (traffic/<mix>.json): steps_per_call, check_steps,
trace_calls (calls under the profiler in a ``--trace 1`` run).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs, program
from portbench.reference import check, episodes as ref_eps, model as ref

B1 = 0.9    # Adam's first-moment decay: mu after one step is (1 - B1) g

# the CPU tests' tiny mix, and the on-card control test's (the cell's own)
TINY = {"steps_per_call": 2, "check_steps": 3, "trace_calls": 1}
SMALL: dict = {}


class Run:
    def __init__(self, cell, seed: int, device, corpus_root):
        from fewshot_torch import training
        from fewshot_torch.data import episodes as eps
        self.cell, self.device = cell, torch.device(device)
        s_w, s_gen = inputs.sub_seeds(seed, 2)
        self.s_gen = s_gen
        corpus = inputs.corpus(cell.config["corpus"], corpus_root)
        self.vocab = len(corpus.vocab)
        self.cfg = program.config(cell.config, self.vocab, corpus.max_len)
        self.spec = dict(cell.config, max_len=corpus.max_len)
        self.ref_data = ref_eps.corpus_tensors(corpus, self.device)
        self.split = torch.as_tensor(np.asarray(corpus.splits["train"]),
                                     dtype=torch.int64, device=self.device)
        w = inputs.weights(cell.config, self.vocab, s_w, self.device)
        self.w0 = program.clone(w)
        params = program.model(cell.config, self.cfg, w)
        opt = training.make_optimizer(self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(s_gen)
        self.state = training.TrainState(params, opt.init(params), 0, gen)
        self.step = training.make_train_step(
            self.cfg, eps.put_corpus(corpus, self.device), self.split)
        self.spc = int(cell.traffic["steps_per_call"])
        self.multi = training.make_multi_step(self.step, self.spc)
        self.batch = self.cfg.batch_size

    # -- set-up: the first steps, which the reference follows -------------
    def first_steps(self) -> dict:
        """The first check_steps steps in two calls built by the window's
        own factory: one step (the first gradient is read from the
        optimizer's state after it), then a call of the rest (its loss is
        the last step's)."""
        from fewshot_torch import training
        n = int(self.cell.traffic["check_steps"])
        self.state, m = training.make_multi_step(self.step, 1)(self.state)
        losses = {1: m["loss"]}
        grad = {k: v / (1.0 - B1) for k, v in self.state.opt_state.mu.items()}
        if n > 1:
            self.state, m = training.make_multi_step(self.step, n - 1)(
                self.state)
            losses[n] = m["loss"]
        change = {k: p.detach() - self.w0[k]
                  for k, p in self.state.params.named_parameters()}
        return {"steps": n, "losses": {i: float(x) for i, x in
                                       losses.items()}, "grad": grad,
                "change": change}

    # -- the window --------------------------------------------------------
    def window(self, seconds: float):
        """(steps, seconds, call losses): calls until the host clock passes
        `seconds`, then a synchronize."""
        losses = []
        t0 = time.perf_counter()
        while True:
            self.state, m = self.multi(self.state)
            losses.append(m["loss"])
            if time.perf_counter() - t0 >= seconds:
                break
        program.synchronize(self.device)
        return len(losses) * self.spc, time.perf_counter() - t0, losses

    def traced(self, calls: int):
        """Two profiled windows of `calls` calls each (device activity
        alone, then with host operations), and the lengths of the episodes
        that the first one's steps drew."""
        from portbench.trace import profiled
        gen_state = self.state.gen.get_state()

        def go():
            for _ in range(calls):
                self.state, _ = self.multi(self.state)
        trace = profiled(go, self.device)
        host_trace = profiled(go, self.device, host=True)
        gen = torch.Generator(device=self.device)
        gen.set_state(gen_state)
        lens = []
        for _ in range(calls * self.spc):
            d = ref_eps.device_draw(gen, self.ref_data, self.split,
                                    self.batch, self.cfg.support_size,
                                    self.cfg.query_size)
            ep = ref_eps.gather(self.ref_data, d["song_ids"],
                                self.cfg.support_size)
            lens.append((ep["support_len"].cpu().numpy(),
                         ep["query_len"].cpu().numpy()))
        return trace, host_trace, lens

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.state = self.step = self.multi = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------
    def episodes(self, batch: int | None = None) -> list:
        gen = torch.Generator(device=self.device).manual_seed(self.s_gen)
        out = []
        for _ in range(int(self.cell.traffic["check_steps"])):
            d = ref_eps.device_draw(gen, self.ref_data, self.split,
                                    self.batch, self.cfg.support_size,
                                    self.cfg.query_size)
            ep = ref_eps.gather(self.ref_data, d["song_ids"],
                                self.cfg.support_size)
            if batch is not None:       # a fault: rows left out
                ep = {k: v[:batch] for k, v in ep.items()}
            out.append(ep)
        return out

    def reference(self, rnd=ref.exact, batch: int | None = None) -> dict:
        ref.strict_fp32()
        losses, grad, last = ref.adam_steps(self.w0, self.spec,
                                            self.episodes(batch), rnd)
        return {"losses": losses, "grad": grad,
                "change": {k: last[k] - self.w0[k] for k in last}}


def run(cell, seed: int, seconds: float, trace: bool, device,
        corpus_root, t_start: float) -> dict:
    r = Run(cell, seed, device, corpus_root)
    prog = r.first_steps()
    program.synchronize(r.device)
    out = {"attempted": prog["steps"],
           "failed": sum(1 for x in prog["losses"].values()
                         if not np.isfinite(x))}
    if trace:
        calls = int(cell.traffic["trace_calls"])
        tr, host_tr, lens = r.traced(calls)
        out["ctx"] = {"kind": "train", "spec": r.spec, "vocab": r.vocab,
                      "trace": tr, "host_trace": host_tr,
                      "steps": calls * r.spc, "episodes": lens,
                      "window_s": tr.window_s, "busy_s": tr.busy_s()}
        out["attempted"] += 2 * calls * r.spc
    else:
        setup_s = time.perf_counter() - t_start
        steps, elapsed, losses = r.window(seconds)
        bad = sum(1 for x in losses if not torch.isfinite(x).item())
        out["attempted"] += steps
        out["failed"] += bad * r.spc
        out["e2e"] = {"train_eps_per_s": steps * r.batch / elapsed,
                      "setup_s": setup_s}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(r.device)
                                if r.device.type == "cuda" else 0)
    r.release()
    out["numbers"] = check.train_numbers(prog, r.reference())
    return out


def readings(cell, seed: int, control: bool, device, corpus_root,
             calls: int = 2) -> dict:
    """The numbers of one seed for ``portbench.prove``: "program", and
    with control also "control" and the fault "half_batch".  No window:
    set-up and the first steps, as a run makes them (calls is unused)."""
    r = Run(cell, seed, device, corpus_root)
    prog = r.first_steps()
    program.synchronize(r.device)
    r.release()
    want = r.reference()
    out = {"program": check.train_numbers(prog, want)}
    if control:
        out["control"] = check.train_numbers(r.reference(ref.fp8), want)
        out["half_batch"] = check.train_numbers(
            r.reference(batch=r.batch // 2), want)
    return out
