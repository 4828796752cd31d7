"""Layer: the noise (sampling.py).  Kernels launched per sampling call
inside the program's ``sample.noise`` spans (the per-row draws and their
stack) over its outermost ``sample.generate`` spans, from the
host-recorded pass.  Moves sample_tokens_per_s."""

from portbench.metrics._spans import kernels_per


def read(ctx):
    return kernels_per(ctx, "sample.noise", "sample.generate")
