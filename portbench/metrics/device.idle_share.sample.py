"""Layer: device.  The share of the traced window in which no operation
ran on the device, in %.  Moves sample_tokens_per_s."""


def read(ctx):
    if ctx["kind"] != "sample" or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
