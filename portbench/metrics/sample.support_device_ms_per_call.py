"""Layer: support pass and prefill.  Device busy ms per sampling call
inside the program's ``sample.support`` spans (support pass or prefill,
and the cache posterior) over its outermost ``sample.generate`` spans,
from the host-recorded pass.  Moves sample_tokens_per_s."""

from portbench.metrics._spans import busy_ms_per


def read(ctx):
    return busy_ms_per(ctx, "sample.support", "sample.generate")
