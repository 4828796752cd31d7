"""Layer: decode loop (sampling.py).  Kernels launched per decode step in
the traced calls (the profiler's kernel count over the decode steps).
Moves sample_tokens_per_s."""

from portbench.metrics._common import decode_steps


def read(ctx):
    if ctx["kind"] != "sample":
        return None
    n = len(ctx["trace"].kernels())
    return n / decode_steps(ctx) if n else None
