"""The program's spans (``user_annotation`` ranges) in the pass that
recorded host operations: their count, and the device operations that
were queued inside them.

A device operation belongs to the spans that were open when the call that
queued it ran.  The pass keeps the calls' host times and not their
correlation ids, so each operation is tied to its call by order: the
program queues all its work on one stream, where the operations of one
kind (kernels, copies, fills) start in the order of the calls that queued
them.  The profiler can miss the device records of the first few calls of
a pass (the benchmark's own draw before the first sampling call, on the
H100), never later ones, so the calls and operations of a kind are paired
from the end and a surplus at the start is left out.
"""

from __future__ import annotations

import bisect

from portbench.trace import Trace

# the words in the names of the CUDA calls (cuda* and cu*) that queue one
# device operation of each kind (cudaLaunchKernel, cudaLaunchKernelExC,
# cuLaunchKernel, cudaMemcpyAsync, cudaMemsetAsync on the H100)
QUEUED_BY = {"kernel": ("LaunchKernel",),
             "gpu_memcpy": ("Memcpy",),
             "gpu_memset": ("Memset",)}


def _kind(name: str) -> str | None:
    if not name.startswith("cu"):
        return None
    for cat, words in QUEUED_BY.items():
        if any(w in name for w in words):
            return cat
    return None


def launched(trace: Trace) -> list:
    """(host time of the queuing call, device operation) for the device
    operations of the pass, paired from the end within each kind."""
    calls: dict = {cat: [] for cat in QUEUED_BY}
    for name, ts, _ in trace.host_ops:
        cat = _kind(name)
        if cat is not None:
            calls[cat].append(ts)
    out = []
    for cat, starts in calls.items():
        ops = sorted((op for op in trace.device_ops if op[1] == cat),
                     key=lambda op: op[2])
        n = min(len(ops), len(starts))
        out += zip(sorted(starts)[len(starts) - n:], ops[len(ops) - n:])
    return out


def span_intervals(ctx, name: str) -> list:
    """(start, end) host us of the program's spans called `name` in the
    host-recorded pass, sorted; a span inside another of its name is part
    of that one and not counted again."""
    out = []
    for _, ts, dur in sorted((o for o in ctx["host_trace"].host_ops
                              if o[0] == name),
                             key=lambda o: (o[1], -o[2])):
        if not out or ts + dur > out[-1][1]:
            out.append((ts, ts + dur))
    return out


def span_count(ctx, name: str) -> int:
    return len(span_intervals(ctx, name))


def span_ops(ctx, name: str) -> list:
    """The device operations of the host-recorded pass that a call
    queued inside a span called `name`."""
    spans = span_intervals(ctx, name)
    starts = [a for a, _ in spans]
    out = []
    for t, op in launched(ctx["host_trace"]):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out.append(op)
    return out


def span_busy_s(ctx, name: str) -> float:
    """Device seconds in which an operation of a span called `name` ran:
    the union of their intervals."""
    return Trace(0.0, span_ops(ctx, name)).busy_s()


def span_kernels(ctx, name: str) -> int:
    return sum(1 for op in span_ops(ctx, name) if op[1] == "kernel")


def _denominator(ctx, per: str) -> int | None:
    """The number of spans called `per`, or nothing where the pass holds
    none (a program without spans) or no device operation."""
    n = span_count(ctx, per)
    return n if n and ctx["host_trace"].device_ops else None


def busy_ms_per(ctx, name: str, per: str) -> float | None:
    """Device busy ms inside the spans called `name` per span called
    `per`."""
    n = _denominator(ctx, per)
    return None if n is None else span_busy_s(ctx, name) * 1e3 / n


def kernels_per(ctx, name: str, per: str) -> float | None:
    """Kernels queued inside the spans called `name` per span called
    `per`."""
    n = _denominator(ctx, per)
    return None if n is None else span_kernels(ctx, name) / n
