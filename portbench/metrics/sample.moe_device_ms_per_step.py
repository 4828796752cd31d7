"""Layer: expert layer (models/moonlight.py).  Device busy ms per decode
step of the program's ``moe.route`` and ``moe.experts`` spans that lie
inside its ``sample.decode_step`` spans (the decode step's routing,
grouped expert products, shared experts and combine, every expert
layer), from the host-recorded pass; nothing where no ``moe.route`` span
opened or no device operation ran.  Moves sample_tokens_per_s."""

import bisect

from portbench.metrics._spans import launched, span_count, span_intervals
from portbench.trace import Trace

MOE = ("moe.route", "moe.experts")


def _within(spans: list):
    """t -> whether host time t lies in one of the sorted, disjoint
    spans."""
    starts = [a for a, _ in spans]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]
    return inside


def read(ctx):
    steps = span_count(ctx, "sample.decode_step")
    if not (span_count(ctx, "moe.route") and steps
            and ctx["host_trace"].device_ops):
        return None
    in_moe = _within(sorted(iv for name in MOE
                            for iv in span_intervals(ctx, name)))
    in_step = _within(span_intervals(ctx, "sample.decode_step"))
    ops = [op for t, op in launched(ctx["host_trace"])
           if in_moe(t) and in_step(t)]
    return Trace(0.0, ops).busy_s() * 1e3 / steps
