"""The decode attention's span reader (``sample.attend_device_ms_per_step``)
on hand-built traces: device busy ms inside the ``sample.attend`` spans per
``sample.decode_step``, and nothing from a program without the span."""

import pytest

from portbench import cells
from portbench.trace import Trace

NAME = "sample.attend_device_ms_per_step"


def _trace(attend: bool, device: bool = True):
    """One sampling call of 2 decode steps, each holding two sample.attend
    spans (two layers) and a kernel outside them; each operation's call
    recorded beside a call that queues nothing.  Step 1: attention kernels
    of 100 and 120 us, step 2: two overlapping ones whose union is 150 us."""
    spans = [("sample.generate", 0, 100), ("sample.decode", 10, 90),
             ("sample.decode_step", 10, 50), ("sample.decode_step", 50, 90)]
    if attend:
        spans += [("sample.attend", 12, 20), ("sample.attend", 25, 33),
                  ("sample.attend", 52, 60), ("sample.attend", 62, 70)]
    ops = [(15, 1000, 1100), (28, 1100, 1220), (40, 1220, 1300),   # step 1
           (55, 1300, 1400), (65, 1350, 1450), (80, 1450, 1500),   # step 2
           (95, 1500, 1600)]                           # in no decode step
    host = ([(n, float(a), float(b - a)) for n, a, b in spans]
            + [("cudaLaunchKernel", float(t), 3.0) for t, _, _ in ops]
            + [("cudaStreamSynchronize", 5.0, 1.0), ("aten::mm", 0.0, 500.0)])
    dev = [(f"k{i}", "kernel", float(a), float(b - a))
           for i, (_, a, b) in enumerate(ops)] if device else []
    return Trace(window_s=1.0, device_ops=dev[::-1], host_ops=host)


def _read(trace):
    return cells.reader(NAME)({"kind": "sample", "host_trace": trace})


def test_reads_attention_busy_time_per_decode_step():
    assert _read(_trace(attend=True)) == pytest.approx((0.220 + 0.150) / 2)


@pytest.mark.parametrize("device", [True, False])
def test_no_attend_span_reads_nothing(device):
    """The parent's program (no sample.attend span) and the LSTM read
    None, not 0, with or without device operations."""
    assert _read(_trace(attend=False, device=device)) is None
    assert _read(Trace(window_s=1.0)) is None


def test_spans_without_device_operations_read_nothing():
    assert _read(_trace(attend=True, device=False)) is None
