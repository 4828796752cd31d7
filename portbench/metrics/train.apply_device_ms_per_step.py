"""Layer: optimizer (training.py).  Device busy ms per train step inside
the program's ``optim.apply`` spans (normalize, global norm, clip, the
update) over its ``train.step`` spans, from the host-recorded pass.
Moves train_eps_per_s."""

from portbench.metrics._spans import busy_ms_per


def read(ctx):
    return busy_ms_per(ctx, "optim.apply", "train.step")
