"""Layer: train step (training.py).  Device busy ms per train step: the
union of the device's operations in the traced window over its steps.
Moves train_eps_per_s."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["busy_s"] <= 0:
        return None
    return ctx["busy_s"] * 1e3 / ctx["steps"]
