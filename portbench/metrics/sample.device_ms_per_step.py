"""Layer: decode loop (sampling.py).  Device busy ms per decode step: the
union of the device's operations in the traced calls (their episode
gather, support pass and decode loop) over their decode steps.  Moves
sample_tokens_per_s."""

from portbench.metrics._common import decode_steps


def read(ctx):
    if ctx["kind"] != "sample" or ctx["busy_s"] <= 0:
        return None
    return ctx["busy_s"] * 1e3 / decode_steps(ctx)
