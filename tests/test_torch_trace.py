"""The program's profiler spans (``fewshot_torch.utils.metrics.span``) on
the CPU with tiny models: off, a span is one shared null context; under a
profiler, the train step and the sampler record their phases as nested,
disjoint ranges, one ``sample.decode_step`` a step the loop ran, one
``sample.sync`` an early-exit test and, in the transformer's steps, one
``sample.attend`` a layer; and the profiler changes no token, loss or
parameter."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fewshot_torch import sampling, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.vocab import EOS, PAD
from fewshot_torch.models.lm import init_lm
from fewshot_torch.utils import metrics

V, L, N_TOK = 40, 12, 20
PHASES = ["episodes.draw", "model.forward", "model.backward", "optim.apply"]
SAMPLE = ["sample.support", "sample.noise", "sample.decode"]


def _cfg(model="lstm", **kw):
    return Config(**{**dict(
        model=model, vocab_size=V, max_len=L, embed_dim=16, hidden_dim=32,
        num_layers=1, num_heads=2, batch_size=4, support_size=2,
        query_size=2, cell="scan", flash=False, prefix_flash=False,
        support_mode="mean_state" if model == "lstm" else "state",
        support_cache=True, cache_dynamic=True, compute_dtype="float32",
        top_k=0, sample_tokens=N_TOK, lr=1e-2), **kw})


def _corpus():
    rng = np.random.RandomState(0)
    counts = np.array([5, 6, 4, 7])
    n = int(counts.sum())
    lens = rng.randint(3, L + 1, n)
    songs = np.zeros((n, L), np.int64)
    for s in range(n):
        songs[s, :lens[s]] = rng.randint(3, V, lens[s])
    ids = np.full((len(counts), counts.max()), -1, np.int64)
    start = 0
    for a, c in enumerate(counts):
        ids[a, :c] = np.arange(start, start + c)
        start += c
    return eps.put_corpus({"songs": songs, "song_len": lens,
                           "artist_song_ids": ids,
                           "artist_num_songs": counts}, "cpu")


def _support(b=3):
    rng = np.random.RandomState(6)
    lens = rng.randint(2, L, (b, 2))
    sup = rng.randint(4, V, (b, 2, L))
    sup[np.arange(L)[None, None] >= lens[..., None]] = PAD
    return torch.tensor(sup).long(), torch.tensor(lens).long()


def _recorded(fn):
    """(fn's result, the profiler's events) with fn run under a CPU
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _named(events, name):
    return sorted((e for e in events if e.name == name),
                  key=lambda e: e.time_range.start)


def _span_children(event, names):
    """The direct children of `event` among the program's spans, by
    start."""
    return sorted((c for c in event.cpu_children if c.name in names),
                  key=lambda c: c.time_range.start)


def _disjoint_in_order(spans):
    return all(a.time_range.end <= b.time_range.start
               for a, b in zip(spans, spans[1:]))


def test_span_is_one_shared_null_context_without_a_profiler():
    a, b = metrics.span("train.step"), metrics.span("sample.decode")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a as got:
        assert got is None


def _train(record: bool, steps=3):
    cfg = _cfg()
    state = training.init_train_state(cfg, V, seed=5, device="cpu")
    multi = training.make_multi_step(
        training.make_train_step(cfg, _corpus(), torch.arange(4)), steps)
    if not record:
        return multi(state), None
    return _recorded(lambda: multi(state))


def test_train_step_spans_hold_the_four_phases_in_order():
    _, events = _train(record=True)
    steps = _named(events, "train.step")
    assert len(steps) == 3
    assert _disjoint_in_order(steps)
    for step in steps:
        kids = _span_children(step, PHASES)
        assert [k.name for k in kids] == PHASES
        assert _disjoint_in_order(kids)
    for name in PHASES:
        assert all(e.cpu_parent is not None
                   and e.cpu_parent.name == "train.step"
                   for e in _named(events, name))


def test_the_profiler_changes_no_loss_or_parameter():
    (plain, m0), _ = _train(record=False)
    (traced, m1), _ = _train(record=True)
    assert torch.equal(m0["loss"], m1["loss"])
    for (k, p), (_, q) in zip(plain.params.named_parameters(),
                              traced.params.named_parameters()):
        assert torch.equal(p, q), k
    for k in plain.opt_state.mu:
        assert torch.equal(plain.opt_state.mu[k], traced.opt_state.mu[k])


def _generate(model, record, eos_bias=0.0, early_exit=True, **kw):
    if eos_bias:    # the LM's EOS alone, no cache mixture to dilute it
        kw = dict(kw, support_cache=False, cache_dynamic=False)
    cfg = _cfg(model, **kw)
    params = init_lm(cfg, V, torch.Generator().manual_seed(1), "cpu")
    with torch.no_grad():
        params.out_b[EOS] += eos_bias
    sup, lens = _support()
    gens = [sampling.row_generator(s, 1) for s in range(3)]

    def go():
        return sampling.generate(params, sup, lens, gens, cfg,
                                 early_exit=early_exit)
    return _recorded(go) if record else (go(), None)


def _steps_and_tests(toks):
    """Decode steps the loop runs, and its early-exit tests, from the
    tokens: a test every EXIT_CHECK_EVERY steps until all rows ended."""
    every = sampling.EXIT_CHECK_EVERY
    n = toks.shape[1]
    ended_by = [row.index(EOS) + 1 if EOS in row else None
                for row in toks.tolist()]
    steps = n
    if None not in ended_by:
        last = max(ended_by)
        steps = min(n, max(every, -(-last // every) * every))
    tests = len([i for i in range(1, steps + 1) if i % every == 0
                 and i < n])
    return steps, tests


@pytest.mark.parametrize("model", ["lstm", "transformer"])
@pytest.mark.parametrize("eos_bias", [0.0, 50.0])
def test_generate_spans(model, eos_bias):
    """One sample.generate holding support, noise and decode, disjoint and
    in that order; one decode_step a step run and one sync an early-exit
    test, under decode.  eos_bias 50 ends every row at its first token,
    so the loop stops at its first test."""
    toks, events = _generate(model, True, eos_bias)
    gen, = _named(events, "sample.generate")
    kids = _span_children(gen, SAMPLE)
    assert [k.name for k in kids] == SAMPLE
    assert _disjoint_in_order(kids)
    steps, tests = _steps_and_tests(toks)
    if eos_bias:
        assert (toks[:, 0] == EOS).all()
        assert steps == sampling.EXIT_CHECK_EVERY < N_TOK
    else:
        assert steps == N_TOK
    assert len(_named(events, "sample.decode")) == 1
    got_steps = _named(events, "sample.decode_step")
    got_tests = _named(events, "sample.sync")
    assert len(got_steps) == steps and len(got_tests) == tests
    for e in got_steps + got_tests:
        assert e.cpu_parent.name == "sample.decode"
    assert _disjoint_in_order(sorted(
        got_steps + got_tests, key=lambda e: e.time_range.start))
    _check_attend_spans(events, model, _cfg(model).num_layers, steps)


def _check_attend_spans(events, model, layers, steps):
    """The transformer's decode attention: one sample.attend a layer a
    decode step, each inside a sample.decode_step; none in the LSTM's."""
    attend = _named(events, "sample.attend")
    assert len(attend) == (layers * steps if model == "transformer" else 0)
    assert all(e.cpu_parent.name == "sample.decode_step" for e in attend)
    for step in _named(events, "sample.decode_step"):
        kids = _span_children(step, ["sample.attend"])
        assert len(kids) == (layers if model == "transformer" else 0)
        assert _disjoint_in_order(kids)


def test_decode_attention_spans_one_per_layer_a_step():
    toks, events = _generate("transformer", True, num_layers=2)
    steps, _ = _steps_and_tests(toks)
    _check_attend_spans(events, "transformer", 2, steps)


def test_no_early_exit_runs_every_step_and_no_test():
    toks, events = _generate("lstm", True, 50.0, early_exit=False)
    assert len(_named(events, "sample.decode_step")) == N_TOK
    assert _named(events, "sample.sync") == []


@pytest.mark.parametrize("model", ["lstm", "transformer"])
def test_the_profiler_changes_no_token(model):
    plain, _ = _generate(model, False)
    traced, _ = _generate(model, True)
    assert torch.equal(plain, traced)


def test_finetune_nests_a_generate_per_row():
    cfg_kw = dict(support_mode="finetune", support_cache=False,
                  cache_dynamic=False, inner_steps=1)
    toks, events = _generate("lstm", True, **cfg_kw)
    gens = _named(events, "sample.generate")
    outer = [e for e in gens if e.cpu_parent is None
             or e.cpu_parent.name != "sample.generate"]
    assert len(outer) == 1 and len(gens) == 1 + toks.shape[0]
    assert all(e.cpu_parent is outer[0] for e in gens if e is not outer[0])


def test_eval_steps_record_draw_and_forward_alone():
    cfg = _cfg()
    params = training.init_train_state(cfg, V, seed=2, device="cpu").params
    step = training.make_eval_step(cfg, _corpus(), torch.arange(4))
    _, events = _recorded(lambda: step(params, torch.Generator()
                                       .manual_seed(0)))
    assert [e.name for e in sorted(
        (e for e in events if e.name in PHASES + ["train.step"]),
        key=lambda e: e.time_range.start)] == PHASES[:2]
