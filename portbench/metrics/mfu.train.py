"""Layer: model (models/lm.py, lstm.py, transformer.py).  The model FLOPs
of the traced window's train steps (forward and backward from the shapes,
nothing recomputed; counts/flops.py) over the window, against 989
TFLOP/s (bf16).  Moves train_eps_per_s."""

from portbench.counts.flops import train_step
from portbench.metrics._common import mfu


def read(ctx):
    if ctx["kind"] != "train" or ctx["busy_s"] <= 0:
        return None
    flops = sum(train_step(ctx["spec"], ctx["vocab"], sl, ql)
                for sl, ql in ctx["episodes"])
    return mfu(flops, ctx)
