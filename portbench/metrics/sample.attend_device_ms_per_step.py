"""Layer: decode loop (sampling.py).  Device busy ms per decode step
inside the program's ``sample.attend`` spans (a transformer decode step's
attention over the KV cache, one span a layer) over its
``sample.decode_step`` spans, from the host-recorded pass; nothing where
no ``sample.attend`` span opened (a program without the span).  Moves
sample_tokens_per_s."""

from portbench.metrics._spans import busy_ms_per, span_count


def read(ctx):
    if not span_count(ctx, "sample.attend"):
        return None
    return busy_ms_per(ctx, "sample.attend", "sample.decode_step")
