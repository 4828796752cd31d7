"""The LSTM recurrence (kernels 1-4): h @ Wh and the gates over the
steps, given the input projection zx; per layer and pass, bf16 streams."""

from __future__ import annotations

from portbench.peaks import bound_s


def forward(rows: int, steps: int, h: int, item: int = 2):
    """(bytes, ops) of one layer's forward over [rows, steps]."""
    ops = 2 * rows * steps * h * 4 * h
    byts = (rows * steps * 4 * h * item        # zx in
            + 4 * h * h * item + 4 * h * 4     # Wh, b
            + rows * steps                     # mask
            + rows * steps * h * item          # ys out
            + 4 * rows * h * 4)                # h0, c0 in; hT, cT out
    return byts, ops


def backward(rows: int, steps: int, h: int, item: int = 2):
    """(bytes, ops) of one layer's BPTT: dh Wh^T and h^T dz."""
    ops = 2 * 2 * rows * steps * h * 4 * h
    byts = (rows * steps * h * item * 2        # dys, ys in
            + rows * steps * 4 * h * item * 2  # zx in, dzx out
            + 4 * h * h * (item + 4)           # Wh in, dWh out
            + 4 * h * 4                        # db out
            + 4 * rows * h * 4)                # dhT, dcT in; dh0, dc0 out
    return byts, ops


def train_step_bound_s(spec: dict) -> float:
    """Least device time of one train step's recurrences: both layers of
    the support pass [B K, L] and the query pass [B Q, L - 1], forward
    and backward."""
    b, k, q = spec["batch_size"], spec["support_size"], spec["query_size"]
    l, h = spec["max_len"], spec["hidden_dim"]
    total = 0.0
    for rows, steps in ((b * k, l), (b * q, l - 1)):
        for part in (forward, backward):
            total += spec["num_layers"] * bound_s(*part(rows, steps, h))
    return total
