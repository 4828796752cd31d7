"""The fused head + cross-entropy (kernels 5-6): logits h2 W + b over the
vocabulary, their logsumexp and target entry, and the backward's dh2, dW
and db.  The backward needs the logits again (three products); storing
them instead would cost more bytes than the products' time."""

from __future__ import annotations

from portbench.peaks import bound_s


def forward(rows: int, d: int, v: int, item: int = 2):
    ops = 2 * rows * d * v
    byts = rows * d * item + v * d * item + v * 4 + rows * 8 + rows * 4 * 2
    return byts, ops


def backward(rows: int, d: int, v: int, item: int = 2):
    ops = 3 * 2 * rows * d * v
    byts = (rows * d * item + v * d * item + v * 4 + rows * 8 + rows * 4 * 3
            + rows * d * 4 + v * d * 4 + v * 4)
    return byts, ops


def train_step_bound_s(spec: dict, vocab: int) -> float:
    """The query rows B Q (L - 1), head width E (the tied table's)."""
    rows = spec["batch_size"] * spec["query_size"] * (spec["max_len"] - 1)
    d = spec["embed_dim"]
    return bound_s(*forward(rows, d, vocab)) + bound_s(*backward(rows, d,
                                                                 vocab))
