"""What the per-layer readers share: the peak, the kernels a pattern
names in a traced window, and the traced window's steps."""

from __future__ import annotations

import re

from portbench.peaks import PEAK_FLOPS


def kernel_seconds(ctx, pattern: str) -> float:
    """Device seconds of the traced window's kernels whose names match."""
    rx = re.compile(pattern)
    return sum(dur for name, _, _, dur in ctx["trace"].kernels()
               if rx.search(name)) / 1e6


def share(bound_s: float, seconds: float) -> float | None:
    """bound / time in %, or nothing when no such kernel ran."""
    return 100.0 * bound_s / seconds if seconds > 0 else None


def mfu(flops: float, ctx) -> float | None:
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / ctx["window_s"] / PEAK_FLOPS["bfloat16"]


def decode_steps(ctx) -> int:
    return sum(c["decode_steps"] for c in ctx["calls"])
