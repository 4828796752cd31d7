"""Layer: model (models/lm.py, lstm.py, transformer.py).  The forward
FLOPs of the traced calls' support passes and returned tokens
(counts/flops.py) over the window, against 989 TFLOP/s (bf16).  Moves
sample_tokens_per_s."""

from portbench.counts.flops import sample_call
from portbench.metrics._common import mfu


def read(ctx):
    if ctx["kind"] != "sample" or ctx["busy_s"] <= 0:
        return None
    flops = sum(sample_call(ctx["spec"], ctx["vocab"], c["support_len"],
                            c["row_tokens"]) for c in ctx["calls"])
    return mfu(flops, ctx)
