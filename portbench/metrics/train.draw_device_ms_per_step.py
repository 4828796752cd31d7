"""Layer: episode draw (data/episodes.py).  Device busy ms per train step
inside the program's ``episodes.draw`` spans (the draw on the card) over
its ``train.step`` spans, from the host-recorded pass.  Moves
train_eps_per_s."""

from portbench.metrics._spans import busy_ms_per


def read(ctx):
    return busy_ms_per(ctx, "episodes.draw", "train.step")
