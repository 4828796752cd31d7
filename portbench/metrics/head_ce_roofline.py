"""Layer: head+CE kernels (ops/head_ce.py).  The least time of the traced
steps' fused head and cross-entropy, forward and backward
(counts/head_ce.py), over the device time of the kernels named below, in
%.  Moves train_eps_per_s."""

from portbench.counts.head_ce import train_step_bound_s
from portbench.metrics._common import kernel_seconds, share

KERNELS = r"\bhead_ce_(fwd|bwd)"


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return share(ctx["steps"] * train_step_bound_s(ctx["spec"], ctx["vocab"]),
                 kernel_seconds(ctx, KERNELS))
