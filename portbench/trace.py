"""A profiled window: torch.profiler over a few calls of the timed path.

``profiled(fn, device)`` runs fn under the profiler with device activity
alone, so that the profiler's host-side cost stays out of the window:
the device operations (kernels, copies, fills) with their times, the
device's busy time as the union of its operations, the window's length by
the host clock, the operations that took most device time.  The per-layer
metrics read this pass.  ``profiled(fn, device, host=True)`` records the
host operations too, which slows the host: the breakdown's idle gaps by
what the host was doing are read from such a second pass.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


@dataclass
class Trace:
    window_s: float
    device_ops: list = field(default_factory=list)   # (name, cat, ts, dur) us
    host_ops: list = field(default_factory=list)     # (name, ts, dur) us

    def kernels(self) -> list:
        return [op for op in self.device_ops if op[1] == "kernel"]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, sorted (us)."""
        merged = []
        for _, _, ts, dur in sorted(self.device_ops, key=lambda o: o[2]):
            end = ts + dur
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def top_device_ops(self) -> list:
        total: dict = {}
        for name, _, _, dur in self.device_ops:
            total[name] = total.get(name, 0.0) + dur / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]

    def idle_gaps(self) -> list:
        """Idle device time between its operations, by the innermost host
        operation running at each gap's middle ("no_host_operation" where
        none ran)."""
        busy = self.busy_intervals()
        hosts = sorted(self.host_ops, key=lambda o: o[1])
        total: dict = {}
        active: list = []           # heap of (end, dur, name)
        i = 0
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            while i < len(hosts) and hosts[i][1] <= mid:
                name, ts, dur = hosts[i]
                heapq.heappush(active, (ts + dur, dur, name))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            name = (min(active, key=lambda h: h[1])[2] if active
                    else "no_host_operation")
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return sorted(total.items(), key=lambda kv: -kv[1])[:TOP]


def profiled(fn, device, host: bool = False) -> Trace:
    """fn() under the profiler: device activity alone, or with host
    operations too; on a CPU device (the CPU tests) the trace holds host
    operations only."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    if not cuda:
        activities = [ProfilerActivity.CPU]
    elif host:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    else:
        activities = [ProfilerActivity.CUDA]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    trace = Trace(window_s)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            trace.device_ops.append((e.get("name", ""), cat,
                                     float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            trace.host_ops.append((e.get("name", ""), float(e["ts"]),
                                   float(e["dur"])))
    return trace
