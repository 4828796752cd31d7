"""Layer: recurrence kernels (ops/lstm_layer.py, ops/lstm_stack.py).  The
least time of the traced steps' recurrences (counts/recurrence.py) over
the device time of the kernels named below, in %.  Moves
train_eps_per_s."""

from portbench.counts.recurrence import train_step_bound_s
from portbench.metrics._common import kernel_seconds, share

KERNELS = r"\blstm_\w*kernel"


def read(ctx):
    if ctx["kind"] != "train" or ctx["spec"]["model"] != "lstm":
        return None
    return share(ctx["steps"] * train_step_bound_s(ctx["spec"]),
                 kernel_seconds(ctx, KERNELS))
