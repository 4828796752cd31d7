"""The roofline and FLOP counts against hand counts at small shapes."""

import itertools

import numpy as np
import pytest

from portbench.counts import attention, flops, head_ce, recurrence
from portbench.peaks import bound_s


def test_recurrence_counts_by_hand():
    # 3 rows, 4 steps, H = 2: h Wh is [3, 2] x [2, 8] a step
    byts, ops = recurrence.forward(3, 4, 2)
    assert ops == 2 * 3 * 2 * 8 * 4
    assert byts == (3 * 4 * 8 * 2 + 8 * 2 * 2 + 8 * 4 + 3 * 4
                    + 3 * 4 * 2 * 2 + 4 * 3 * 2 * 4)
    byts, ops = recurrence.backward(3, 4, 2)
    assert ops == 2 * (2 * 3 * 2 * 8 * 4)
    assert byts == (3 * 4 * 2 * 2 * 2 + 3 * 4 * 8 * 2 * 2 + 8 * 2 * 6
                    + 8 * 4 + 4 * 3 * 2 * 4)


def test_recurrence_step_is_both_passes_both_directions():
    spec = {"batch_size": 2, "support_size": 3, "query_size": 1,
            "max_len": 5, "hidden_dim": 4, "num_layers": 2}
    want = 0.0
    for rows, steps in ((6, 5), (2, 4)):
        want += 2 * (bound_s(*recurrence.forward(rows, steps, 4))
                     + bound_s(*recurrence.backward(rows, steps, 4)))
    assert recurrence.train_step_bound_s(spec) == pytest.approx(want)


def test_head_ce_counts_by_hand():
    byts, ops = head_ce.forward(10, 4, 7)
    assert ops == 2 * 10 * 4 * 7
    assert byts == 10 * 4 * 2 + 7 * 4 * 2 + 7 * 4 + 10 * 8 + 10 * 8
    _, ops = head_ce.backward(10, 4, 7)
    assert ops == 3 * 2 * 10 * 4 * 7


def _brute_pairs(valid_keys_per_query):
    return sum(valid_keys_per_query)


def test_attention_pairs_by_enumeration():
    rng = np.random.default_rng(0)
    k, l, q = 3, 6, 2
    sl = rng.integers(1, l + 1, size=(4, k))
    ql = rng.integers(1, l + 1, size=(4, q))
    for b in range(4):
        real = [kk * l + i for kk in range(k) for i in range(sl[b, kk])]
        brute = sum(sum(1 for key in real if key <= p) for p in real)
        assert attention.prefix_pairs(sl[b:b + 1])[0] == brute
    brute = 0
    for b, j in itertools.product(range(4), range(q)):
        for t in range(ql[b, j] - 1):
            brute += sl[b].sum() + t + 1
    assert attention.query_pairs(sl, ql) == brute
    toks = np.array([3, 0, 5, 1])
    brute = sum(sl[r].sum() * n + n * (n + 1) // 2
                for r, n in enumerate(toks))
    assert attention.decode_pairs(sl, toks) == brute


def test_lstm_flops_by_hand():
    spec = {"model": "lstm", "embed_dim": 3, "hidden_dim": 5,
            "num_layers": 2, "max_len": 4}
    tok = 2 * (3 + 5) * 20 + 2 * (5 + 5) * 20
    assert flops.lstm_token(spec) == tok
    head = 2 * 5 * 3 + 2 * 3 * 11
    assert flops.head_token(spec, 11) == head
    sl = np.full((2, 3), 4)
    ql = np.full((2, 1), 4)
    fwd = (2 * 3 * 4 + 2 * 1 * 3) * tok + 2 * 1 * 3 * head
    assert flops.train_step(spec, 11, sl, ql) == 3 * fwd
    got = flops.sample_call(spec, 11, sl, np.array([2, 1]))
    assert got == 2 * 3 * 4 * tok + 3 * tok + 3 * head


def test_transformer_flops_by_hand():
    spec = {"model": "transformer", "embed_dim": 4, "mlp_ratio": 2,
            "num_layers": 2, "max_len": 3, "num_heads": 2}
    block = 2 * 4 * 12 + 2 * 4 * 4 + 2 * 2 * 4 * 8
    assert flops.block_token(spec) == block
    sl = np.array([[3, 1]])
    ql = np.array([[3]])
    prefix = 6 * (1 * block + 2 * 4 * 8) + 1 * 16 * \
        int(attention.prefix_pairs(sl).sum())
    query = 2 * 2 * block + 2 * 16 * attention.query_pairs(sl, ql)
    head = 2 * 4 * 9
    assert flops.train_step(spec, 9, sl, ql) == 3 * (prefix + query
                                                    + 2 * head)
