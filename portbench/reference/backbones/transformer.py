"""The transformer's hidden states: the K support songs, padded to L each,
are one prefix that the query or the served row follows; the prefix's
pad positions take no part as keys."""

from __future__ import annotations

import torch

from portbench.reference.model import tfm_run


def episode_hidden(p: dict, spec: dict, support, support_len, inputs,
                   in_mask, rnd) -> torch.Tensor:
    b, k, l = support.shape
    q_ = inputs.shape[1]
    emb = p["embed"]
    prefix = support.reshape(b, k * l)
    pmask = (torch.arange(l, device=support.device)
             < support_len[..., None]).reshape(b, k * l)
    seq = torch.cat([prefix.repeat_interleave(q_, 0),
                     inputs.reshape(b * q_, -1)], dim=1)
    valid = torch.cat([pmask.repeat_interleave(q_, 0),
                       in_mask.reshape(b * q_, -1)], dim=1)
    hid = tfm_run(p, emb[seq], valid, spec.get("num_heads", 0), rnd)
    return hid[:, k * l:]


def served_hidden(p: dict, spec: dict, support, support_len, inputs,
                  rnd) -> torch.Tensor:
    r, n = inputs.shape
    k, l = support.shape[1:]
    emb = p["embed"]
    dev = inputs.device
    pmask = (torch.arange(l, device=dev)
             < support_len[..., None]).reshape(r, k * l)
    seq = torch.cat([support.reshape(r, k * l), inputs], dim=1)
    valid = torch.cat([pmask, torch.ones(r, n, dtype=torch.bool,
                                         device=dev)], dim=1)
    return tfm_run(p, emb[seq], valid, spec["num_heads"], rnd)[:, k * l:]
