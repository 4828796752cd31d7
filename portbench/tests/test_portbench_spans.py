"""The span readers on hand-built traces: the program's spans (host
ranges, us), device operations and the runtime calls that queued them, and
the busy time, kernel count and span count each reader should give."""

import pytest

from portbench import cells
from portbench.metrics import _spans
from portbench.trace import Trace

TRAIN = ["train.draw_device_ms_per_step", "train.forward_device_ms_per_step",
         "train.backward_device_ms_per_step",
         "train.apply_device_ms_per_step"]
SAMPLE = ["sample.support_device_ms_per_call",
          "sample.noise_launches_per_call",
          "sample.decode_device_ms_per_step",
          "sample.decode_launches_per_step"]
CALL = {"kernel": "cudaLaunchKernel", "gpu_memcpy": "cudaMemcpyAsync",
        "gpu_memset": "cudaMemsetAsync"}


def _trace(spans, ops):
    """spans: (name, start, end); ops: (cat, queued at, device start,
    device end).  Each operation's call is recorded beside calls that
    queue nothing; the device operations are listed last first, as a
    trace need not order them."""
    calls = [(CALL[cat], float(t), 3.0) for cat, t, _, _ in ops]
    calls += [("cudaStreamSynchronize", 0.5, 1.0),
              ("cudaStreamIsCapturing", 1.5, 0.1)]
    return Trace(window_s=1.0,
                 device_ops=[(f"k{i}", cat, float(a), float(b - a))
                             for i, (cat, _, a, b) in enumerate(ops)][::-1],
                 host_ops=[(n, float(a), float(b - a)) for n, a, b in spans]
                 + [("aten::mm", 0.0, 5000.0)] + calls)


def _ctx(trace):
    return {"kind": "any", "host_trace": trace}


def _read(name, trace):
    return cells.reader(name)(_ctx(trace))


def _train_trace():
    """Two steps.  Step 1 (0-100 us): draw 0-10, forward 10-40, backward
    40-80, apply 80-95; step 2 (100-200) likewise shifted by 100."""
    spans, ops = [], []
    for base in (0, 100):
        spans += [("train.step", base, base + 100),
                  ("episodes.draw", base, base + 10),
                  ("model.forward", base + 10, base + 40),
                  ("model.backward", base + 40, base + 80),
                  ("optim.apply", base + 80, base + 95)]
        dev = 1000 + 10 * base
        ops += [("kernel", base + 2, dev, dev + 100),            # draw
                ("gpu_memset", base + 5, dev + 100, dev + 120),  # draw
                ("kernel", base + 20, dev + 120, dev + 420),     # forward
                # backward: two overlapping kernels, union 500 us
                ("kernel", base + 50, dev + 420, dev + 820),
                ("kernel", base + 60, dev + 700, dev + 920),
                ("kernel", base + 85, dev + 920, dev + 970)]     # apply
    ops += [("kernel", 96, 1975, 1995),       # in the step, in no phase
            ("kernel", 500, 7000, 7100)]      # outside every span
    return _trace(spans, ops)


def test_train_readers():
    tr = _train_trace()
    got = {n: _read(n, tr) for n in TRAIN}
    assert got == pytest.approx({TRAIN[0]: 0.120, TRAIN[1]: 0.300,
                                 TRAIN[2]: 0.500, TRAIN[3]: 0.050})
    ctx = _ctx(tr)
    assert _spans.span_count(ctx, "train.step") == 2
    assert _spans.span_kernels(ctx, "episodes.draw") == 2
    assert _spans.span_busy_s(ctx, "train.step") == pytest.approx(
        2 * 970e-6 + 20e-6)


def _sample_trace():
    """Two calls (outermost sample.generate), the second holding a nested
    sample.generate, as the finetune branch's rows do; call 1: 3 decode
    steps and 1 early-exit test, call 2: 2 steps."""
    spans = [("sample.generate", 0, 100),
             ("sample.support", 1, 10), ("sample.noise", 10, 20),
             ("sample.decode", 20, 90),
             ("sample.decode_step", 20, 40), ("sample.decode_step", 40, 60),
             ("sample.sync", 60, 62), ("sample.decode_step", 62, 80),
             ("sample.generate", 200, 300), ("sample.generate", 201, 299),
             ("sample.support", 202, 210), ("sample.noise", 210, 220),
             ("sample.decode", 220, 290),
             ("sample.decode_step", 220, 250),
             ("sample.decode_step", 250, 280)]
    ops = [("kernel", 5, 0, 400),                   # support, call 1
           ("kernel", 11, 400, 410), ("kernel", 12, 410, 420),
           ("kernel", 13, 420, 430),                # noise: 3 launches
           ("kernel", 25, 430, 530), ("kernel", 45, 530, 630),
           ("gpu_memcpy", 61, 630, 640),           # the sync's copy
           ("kernel", 65, 640, 740),                # decode, call 1
           ("kernel", 205, 1000, 1200),             # support, call 2
           ("kernel", 215, 1200, 1210),             # noise
           ("kernel", 230, 1210, 1310), ("kernel", 260, 1310, 1410)]
    return _trace(spans, ops)


def test_sample_readers():
    tr = _sample_trace()
    got = {n: _read(n, tr) for n in SAMPLE}
    assert got == pytest.approx({
        SAMPLE[0]: (0.400 + 0.200) / 2,
        SAMPLE[1]: 4 / 2,
        SAMPLE[2]: (0.310 + 0.200) / 5,
        SAMPLE[3]: 5 / 5})
    ctx = _ctx(tr)
    assert _spans.span_count(ctx, "sample.generate") == 2
    assert _spans.span_count(ctx, "sample.sync") == 1


@pytest.mark.parametrize("name", TRAIN + SAMPLE)
def test_a_trace_without_spans_reads_nothing(name):
    """The program of a checkout without spans: every span reader gives
    None, and none raises."""
    tr = _train_trace() if name in TRAIN else _sample_trace()
    tr.host_ops = [op for op in tr.host_ops if op[0] == "aten::mm"]
    assert _read(name, tr) is None
    assert _read(name, Trace(window_s=1.0)) is None


@pytest.mark.parametrize("name", TRAIN + SAMPLE)
def test_spans_without_device_operations_read_nothing(name):
    """A CPU run records the spans and no device operation."""
    tr = _train_trace() if name in TRAIN else _sample_trace()
    tr.device_ops = []
    assert _read(name, tr) is None


@pytest.mark.parametrize("name", TRAIN + SAMPLE)
def test_other_kind_reads_nothing(name):
    """A train trace gives the sample readers nothing, and the reverse."""
    tr = _sample_trace() if name in TRAIN else _train_trace()
    assert _read(name, tr) is None


@pytest.mark.parametrize("cat", list(CALL))
@pytest.mark.parametrize("surplus", ["calls", "operations"])
def test_a_surplus_at_the_start_is_left_out(cat, surplus):
    """Calls whose device records the profiler missed at the start of the
    pass (or operations without their calls there) are left out: the rest
    pair from the end, and each reader reads as without them."""
    ops = [("kernel", 2, 0, 100), ("gpu_memcpy", 5, 100, 110),
           ("gpu_memset", 6, 110, 120), ("kernel", 20, 120, 420),
           ("gpu_memcpy", 21, 420, 425), ("gpu_memset", 22, 425, 430)]
    spans = [("train.step", 0, 100), ("episodes.draw", 0, 10),
             ("model.forward", 10, 50)]
    want = {TRAIN[0]: 0.120, TRAIN[1]: 0.310}
    tr = _trace(spans, ops)
    assert {n: _read(n, tr) for n in want} == pytest.approx(want)
    if surplus == "calls":
        tr.host_ops.append((CALL[cat], -3.0, 1.0))
    else:
        tr.device_ops.append(("early", cat, -50.0, 40.0))
    assert {n: _read(n, tr) for n in want} == pytest.approx(want)


def test_cu_launches_queue_kernels():
    """Kernels queued by a cu* launch (a Triton kernel's
    cuLaunchKernelEx) pair in launch order with those of cudaLaunchKernel."""
    tr = _trace([("train.step", 0, 100), ("model.forward", 10, 20)],
                [("kernel", 5, 0, 100), ("kernel", 15, 100, 300),
                 ("kernel", 30, 300, 310)])
    tr.host_ops = [("cuLaunchKernelEx", ts, d) if ts == 15.0 else (n, ts, d)
                   for n, ts, d in tr.host_ops]
    assert _read(TRAIN[1], tr) == pytest.approx(0.200)
    assert _spans.span_kernels(_ctx(tr), "model.forward") == 1
