"""A run with the timed path broken underneath comes out not correct,
for each fault the cell can have; and at the configuration's fp32 the
reference agrees with the program's CPU path."""

import pytest
from conftest import workloads

import fewshot_torch.models.lm as lm_mod
import fewshot_torch.models.lstm as lstm_mod
import fewshot_torch.models.transformer as tfm_mod
import fewshot_torch.sampling as sampling_mod
import fewshot_torch.training as training_mod
from fewshot_torch.data.episodes import Episode


def _half_batch(orig):
    def half(params, ep, cfg, **kw):
        n = ep.support.shape[0] // 2
        return orig(params, Episode(*(x[:n] for x in ep)), cfg, **kw)
    return half


def test_train_state_unchanged(run_tiny, monkeypatch):
    monkeypatch.setattr(training_mod.Optimizer, "update_",
                        lambda self, *a, **k: None)
    rc, res, _ = run_tiny("lstm_cache.train")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["change_rel"]["value"] == pytest.approx(1.0)


def test_train_multi_step_state_not_advanced(run_tiny, monkeypatch):
    """The checked steps go through the window's own factory: a call of
    several steps that hands back its input state comes out not correct."""
    orig = training_mod.make_multi_step

    def make_multi_step(step, k):
        multi = orig(step, k)
        if k <= 1:
            return multi

        def stale(state):
            params = list(state.params.parameters())
            kept = [p.detach().clone() for p in params]
            _, metrics = multi(state)
            with lm_mod.torch.no_grad():
                for p, v in zip(params, kept):
                    p.copy_(v)
            return state, metrics
        return stale
    monkeypatch.setattr(training_mod, "make_multi_step", make_multi_step)
    rc, res, _ = run_tiny("lstm_cache.train")
    assert rc == 0 and res["correct"] is False


def test_train_half_the_batch(run_tiny, monkeypatch):
    monkeypatch.setattr(lm_mod, "episodic_nll_stats",
                        _half_batch(lm_mod.episodic_nll_stats))
    rc, res, _ = run_tiny("lstm_cache.train")
    assert rc == 0 and res["correct"] is False


def test_sample_state_unchanged(run_tiny, monkeypatch):
    orig_lstm, orig_tfm = lstm_mod.lstm_step, tfm_mod.transformer_step

    def lstm_step(layers, x, state, dt=None):
        h, _ = orig_lstm(layers, x, state, dt)
        return h, state

    def transformer_step(params, x_t, cache, idx, cfg):
        frozen = {k: v.clone() for k, v in cache.items()}
        h, _ = orig_tfm(params, x_t, frozen, idx, cfg)
        return h, cache
    monkeypatch.setattr(lstm_mod, "lstm_step", lstm_step)
    monkeypatch.setattr(tfm_mod, "transformer_step", transformer_step)
    for w in ("lstm_cache.sample", "tfm_cache.sample"):
        rc, res, _ = run_tiny(w)
        assert rc == 0 and res["correct"] is False, (w, res["checks"])


def test_sample_half_the_batch(run_tiny, monkeypatch):
    orig = sampling_mod.generate

    def generate(params, support, support_len, generators, cfg, n_tokens,
                 temperature=None, **kw):
        n = support.shape[0] // 2
        out = orig(params, support[:n], support_len[:n], generators[:n],
                   cfg, n_tokens, temperature[:n], **kw)
        rest = out.new_full((support.shape[0] - n, out.shape[1]), 0)
        return lm_mod.torch.cat([out, rest])
    monkeypatch.setattr(sampling_mod, "generate", generate)
    for w in ("lstm_cache.sample", "tfm_cache.sample"):
        rc, res, _ = run_tiny(w)
        assert rc == 0 and res["correct"] is False, (w, res["checks"])


def test_sample_token_altered(run_tiny, monkeypatch):
    orig = sampling_mod.filtered_sample

    def altered(noise, logits, *a, **k):
        return (orig(noise, logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(sampling_mod, "filtered_sample", altered)
    for w in ("lstm_cache.sample", "tfm_cache.sample"):
        rc, res, _ = run_tiny(w)
        assert rc == 0 and res["correct"] is False, (w, res["checks"])


def test_sample_without_the_cache_branch(run_tiny, monkeypatch):
    """The decode loop's cache mixture carries weight in the compared
    greedy rows: sampling from the LM branch alone comes out not correct."""
    def lm_only(params, logits, hidden, log_cache):
        return lm_mod.torch.log_softmax(logits.float(), dim=-1)
    monkeypatch.setattr(lm_mod, "cache_mixed_logp", lm_only)
    for w in ("lstm_cache.sample", "tfm_cache.sample"):
        rc, res, _ = run_tiny(w)
        assert rc == 0 and res["correct"] is False, (w, res["checks"])


@pytest.mark.parametrize("workload", workloads())
def test_reference_agrees_with_the_program_in_fp32(run_tiny, workload):
    """At fp32 the program's plain route and the reference compute the
    same function: the numbers sit at round-off (the parameters' change a
    decade above: Adam's first steps divide each gradient entry by its own
    size, so round-off in a near-zero entry moves its change by up to lr)."""
    rc, res, err = run_tiny(workload, compute_dtype="float32")
    assert rc == 0, err
    assert res["correct"] is True
    for name, c in res["checks"].items():
        assert c["value"] < (1e-3 if name.startswith("change") else 1e-4), \
            name
