"""The numbers that decide ``correct``, each from two readings.

Training (per cell, over the first steps of the object the window
drives):
  loss_rel    the largest relative gap of a step's loss (loss1_rel: the
              first step's, before any update);
  grad_rel    the first gradient as the optimizer got it: the worst leaf's
              gap of norms, over the larger of that leaf's reference norm
              and the median leaf's;
  change_rel  the parameters' change over the first steps, the same
              measure, leaving out leaves whose reference gradient is
              under a thousandth of the median leaf's (Adam moves those by
              round-off alone).
  grad_diff_rel, change_diff_rel
              the same two, by the worst leaf's norm of the difference
              over the same denominator (compared where the gap of norms
              does not separate the control from the program: rounding
              errors that point every way move a leaf's norm by their
              square, a systematic one by itself);
Serving of sampled rows:
  served_gap  the widest gap by which a served greedy token's reference
              log-prob lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics

import torch

ROUND_OFF = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tensors.items()}


def worst_leaf(prog: dict, ref: dict, leaves=None, diff: bool = False):
    """(gap, leaf): max over leaves of | |prog| - |ref| | (diff: |prog -
    ref|) over max(|ref|, the median leaf's |ref|)."""
    leaves = sorted(ref) if leaves is None else leaves
    rn = _norms({k: ref[k] for k in leaves})
    pn = _norms({k: prog[k].float() - ref[k].float() if diff else prog[k]
                 for k in leaves})
    med = statistics.median(rn.values())
    gaps = {k: (pn[k] if diff else abs(pn[k] - rn[k])) / max(rn[k], med,
                                                              1e-30)
            for k in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(ref_grad: dict) -> list:
    """Leaves whose reference gradient is not nought to rounding."""
    rn = _norms(ref_grad)
    med = statistics.median(rn.values())
    return sorted(k for k, v in rn.items() if v >= ROUND_OFF * med)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog/ref: {"losses": .., "grad": {leaf: g}, "change": {leaf: d}};
    the reference's losses are a list of every step's, the program's a
    {step (from 1): loss} of the steps its calls returned, or a list."""
    got = prog["losses"]
    if not isinstance(got, dict):
        got = dict(enumerate(got, 1))
    steps = [abs(a - ref["losses"][i - 1]) / abs(ref["losses"][i - 1])
             for i, a in sorted(got.items())]
    moving = moving_leaves(ref["grad"])
    grad, grad_leaf = worst_leaf(prog["grad"], ref["grad"])
    change, change_leaf = worst_leaf(prog["change"], ref["change"], moving)
    grad_d, grad_d_leaf = worst_leaf(prog["grad"], ref["grad"], diff=True)
    change_d, change_d_leaf = worst_leaf(prog["change"], ref["change"],
                                         moving, diff=True)
    return {"loss_rel": max(steps), "loss1_rel": steps[0],
            "grad_rel": grad, "change_rel": change,
            "grad_diff_rel": grad_d, "change_diff_rel": change_d,
            "loss_rel_steps": steps,
            "worst": {"grad_rel": grad_leaf, "change_rel": change_leaf,
                      "grad_diff_rel": grad_d_leaf,
                      "change_diff_rel": change_d_leaf}}


def row_lengths(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """Tokens a row returned: up to and with its first EOS, else all."""
    n = tokens.shape[1]
    is_eos = tokens == eos
    first = torch.where(is_eos.any(1), is_eos.float().argmax(1),
                        torch.full_like(tokens[:, 0], n - 1))
    return first + 1


def served_gap(ref_logp: torch.Tensor, tokens: torch.Tensor,
               lengths: torch.Tensor) -> float:
    """Widest gap of a served token below the reference's best, over each
    row's returned tokens.  ref_logp [R, n, V], tokens [R, n]."""
    best = ref_logp.max(-1).values
    got = ref_logp.gather(-1, tokens[..., None])[..., 0]
    live = torch.arange(tokens.shape[1], device=tokens.device) \
        < lengths[:, None]
    return float(((best - got) * live).max())


def control_gap(ref_logp: torch.Tensor, ctl_logp: torch.Tensor,
                lengths: torch.Tensor) -> float:
    """The same gap for the token that the control puts first at each
    position of the same rows."""
    return served_gap(ref_logp, ctl_logp.argmax(-1), lengths)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers the limits
    name; a number that is missing or not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
