"""Layer: decode loop (sampling.py).  Kernels launched per decode step
inside the program's ``sample.decode`` spans over its
``sample.decode_step`` spans, from the host-recorded pass.  Moves
sample_tokens_per_s."""

from portbench.metrics._spans import kernels_per


def read(ctx):
    return kernels_per(ctx, "sample.decode", "sample.decode_step")
