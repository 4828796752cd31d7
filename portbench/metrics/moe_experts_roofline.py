"""Layer: expert layer (models/moonlight.py).  The least time of the
traced calls' expert products, prefill and decode (counts/moe.py), over
the device time of the program's ``moe.experts`` spans in the
host-recorded pass (as many calls of the same shapes), in %; nothing
where no ``moe.experts`` span opened.  Moves sample_tokens_per_s."""

from portbench.counts.moe import sample_call_bound_s
from portbench.metrics._common import share
from portbench.metrics._spans import span_busy_s, span_count


def read(ctx):
    if ctx["kind"] != "sample" or not span_count(ctx, "moe.experts"):
        return None
    bound = sum(sample_call_bound_s(ctx["spec"], len(c["row_tokens"]),
                                    c["decode_steps"]) for c in ctx["calls"])
    return share(bound, span_busy_s(ctx, "moe.experts"))
