"""Layer: decode loop (sampling.py).  Device busy ms per decode step
inside the program's ``sample.decode`` spans (the loop, its early-exit
tests included) over its ``sample.decode_step`` spans, from the
host-recorded pass.  Moves sample_tokens_per_s."""

from portbench.metrics._spans import busy_ms_per


def read(ctx):
    return busy_ms_per(ctx, "sample.decode", "sample.decode_step")
