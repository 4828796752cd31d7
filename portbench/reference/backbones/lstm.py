"""The LSTM's hidden states: the support songs run from a zero state and
their final states, averaged over the K songs (mean-state support), start
the query or the served row."""

from __future__ import annotations

import torch

from portbench.reference.model import lstm_run


def episode_hidden(p: dict, spec: dict, support, support_len, inputs,
                   in_mask, rnd) -> torch.Tensor:
    b, k, l = support.shape
    q_ = inputs.shape[1]
    emb = p["embed"]
    steps = torch.arange(l, device=support.device)
    flat = support.reshape(b * k, l)
    smask = steps < support_len.reshape(b * k)[:, None]
    _, st = lstm_run(p, emb[flat], smask, None, rnd)
    st = [(h.reshape(b, k, -1).mean(1).repeat_interleave(q_, 0),
           c.reshape(b, k, -1).mean(1).repeat_interleave(q_, 0))
          for h, c in st]
    hid, _ = lstm_run(p, emb[inputs.reshape(b * q_, -1)],
                      in_mask.reshape(b * q_, -1), st, rnd)
    return hid


def served_hidden(p: dict, spec: dict, support, support_len, inputs,
                  rnd) -> torch.Tensor:
    r = inputs.shape[0]
    k, l = support.shape[1:]
    emb = p["embed"]
    steps = torch.arange(l, device=inputs.device)
    smask = steps < support_len.reshape(r * k)[:, None]
    _, st = lstm_run(p, emb[support.reshape(r * k, l)], smask, None, rnd)
    st = [(h.reshape(r, k, -1).mean(1), c.reshape(r, k, -1).mean(1))
          for h, c in st]
    hid, _ = lstm_run(p, emb[inputs], None, st, rnd)
    return hid
