"""The persistent bf16 LSTM kernels (``lstm_fwd_persist``,
``lstm_bwd_persist``) and their route.

On the CPU: the route predicate (``persistent_route``) at training A's
shape and at the widths around it.  On the card (skips without one): both
kernels against the unchanged plain twins at rows 8, 32, 33, 160 and 161
(ragged 32-row tiles), H 128, 256, 384 and 512 (clusters of 4, 8, 12 and
16 blocks), T 1, 2 and 96, with one row masked from step 0 and one of
length 1, in both gates modes (bf16, int8-coded); serving's null gates;
the same bits from a second launch; and the C predicate against its
Python mirror.

Tolerances, as for the step kernels (tests/test_torch_lstm_kernels.py and
test_torch_lstm_bwd.py): the forward 3e-2 absolute on the bf16 ys/cs
streams and 2e-2 on the fp32 final state (a bf16 rounding tie flipped by
the order of an fp32 sum moves later steps by about one bf16 step), its
bf16 gates 3e-2 absolute and its int8 gates one code step; the backward
3e-2 of each output's largest magnitude (a flipped bf16 dz travels back
through the remaining steps).
"""

import numpy as np
import pytest
import torch

from fewshot_torch.ops import _ext, lstm_layer


@pytest.mark.parametrize("rows,hidden,dtype,want", [
    (160, 512, torch.bfloat16, True),     # training A, serving A
    (160, 256, torch.bfloat16, True),
    (8, 128, torch.bfloat16, True),
    (161, 384, torch.bfloat16, True),
    (160, 1024, torch.bfloat16, False),   # past 16 blocks of 32 units
    (160, 640, torch.bfloat16, False),
    (160, 192, torch.bfloat16, False),    # not a multiple of 128
    (160, 512, torch.float32, False),     # fp32 keeps the step kernels
    (0, 512, torch.bfloat16, False),
])
def test_persistent_route_predicate(rows, hidden, dtype, want):
    assert lstm_layer.persistent_route(rows, hidden, dtype) is want


def test_named_persistent_route_refuses_other_shapes():
    """A call that names the persistent route on a shape it does not take
    raises on the CPU as on the card: nothing runs in its place."""
    t_, rows, hidden = 2, 3, 128
    args = (torch.zeros(t_, rows, 4 * hidden), torch.zeros(hidden, 4 * hidden),
            torch.zeros(4 * hidden), torch.ones(t_, rows, 1),
            torch.zeros(rows, hidden), torch.zeros(rows, hidden))
    with pytest.raises(ValueError, match="route"):
        lstm_layer.lstm_layer_fwd(*args, route="persistent")
    ys, _, _, _ = lstm_layer.lstm_layer_fwd(*args, route="step")
    assert ys.shape == (t_, rows, hidden)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _case(dev, steps, rows, hidden, seed=0):
    rng = np.random.RandomState(seed)
    lim = np.sqrt(6.0 / (5 * hidden))
    lens = rng.randint(1, steps + 1, rows)
    lens[0] = 0                                    # masked from step 0
    if rows > 1:
        lens[1] = 1
    mask = _t((np.arange(steps)[:, None] < lens[None])[..., None]).to(dev)
    bf = torch.bfloat16
    zx = _t(0.6 * rng.randn(steps, rows, 4 * hidden), bf).to(dev)
    wh = _t(rng.uniform(-lim, lim, (hidden, 4 * hidden)), bf).to(dev)
    b = _t(0.1 * rng.randn(4 * hidden)).to(dev)
    h0 = _t(0.5 * rng.randn(rows, hidden)).to(dev)
    c0 = _t(0.5 * rng.randn(rows, hidden)).to(dev)
    dys = _t(rng.randn(steps, rows, hidden), bf).to(dev)
    dhT = _t(rng.randn(rows, hidden)).to(dev)
    dcT = _t(rng.randn(rows, hidden)).to(dev)
    return (zx, wh, b, mask, h0, c0), (dys, dhT, dcT)


def _abs_err(got, want):
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def _rel_err(got, want):
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    return _abs_err(got, want) / max(scale, 1e-30)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("gates", ["bfloat16", "int8"])
@pytest.mark.parametrize("steps", [1, 2, 96])
@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
@pytest.mark.parametrize("rows", [8, 32, 33, 160, 161])
def test_persistent_kernels_match_twins_on_cuda(cuda_device, rows, hidden,
                                                steps, gates):
    fwd_args, (dys, dhT, dcT) = _case(cuda_device, steps, rows, hidden)
    gdt = torch.int8 if gates == "int8" else torch.bfloat16
    counts = lstm_layer.lstm_layer_fwd.route_launches
    before = counts["persistent"]
    with torch.no_grad():
        got = lstm_layer.lstm_layer_fwd(*fwd_args, save_gates=True,
                                        gates_dtype=gdt)
        want = lstm_layer.lstm_layer_fwd_plain(*fwd_args, save_gates=True,
                                               gates_dtype=gdt)
        served = lstm_layer.lstm_layer_fwd(*fwd_args)
        again = lstm_layer.lstm_layer_fwd(*fwd_args, save_gates=True,
                                          gates_dtype=gdt)
    torch.cuda.synchronize()
    assert counts["persistent"] == before + 3
    for k, g, w, tol in zip(("ys", "cs", "hT", "cT"), got, want,
                            (3e-2, 3e-2, 2e-2, 2e-2)):
        assert g.dtype == w.dtype
        assert _abs_err(g, w) <= tol, (k, _abs_err(g, w))
    assert got[4].dtype == gdt
    gate_tol = 1.0 if gdt == torch.int8 else 3e-2
    assert _abs_err(got[4], want[4]) <= gate_tol
    assert _same(got, again), "a second launch gave other bits"
    assert _same(got[:4], served), "serving's null gates changed the state"

    cs, gates_t = got[1], got[4]
    bwd_args = (gates_t, fwd_args[1], fwd_args[3], cs, fwd_args[5], dys, dhT,
                dcT)
    before = lstm_layer.lstm_layer_bwd.route_launches["persistent"]
    got_b = lstm_layer.lstm_layer_bwd(*bwd_args)
    want_b = lstm_layer.lstm_layer_bwd_plain(*bwd_args)
    again_b = lstm_layer.lstm_layer_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert lstm_layer.lstm_layer_bwd.route_launches["persistent"] == \
        before + 2
    for k, g, w in zip(("dzx", "dh0", "dc0", "db"), got_b, want_b):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_err(g, w) <= 3e-2, (k, _rel_err(g, w))
    assert _same(got_b, again_b), "a second launch gave other bits"


def test_int8_gates_leave_the_forward_unchanged_on_cuda(cuda_device):
    """ys, cs, hT and cT are the same bits in both gates modes: the gates
    are a residual of the backward only."""
    fwd_args, _ = _case(cuda_device, 96, 160, 512, seed=1)
    with torch.no_grad():
        coded = lstm_layer.lstm_layer_fwd(*fwd_args, save_gates=True,
                                          gates_dtype=torch.int8)
        plain = lstm_layer.lstm_layer_fwd(*fwd_args, save_gates=True,
                                          gates_dtype=torch.bfloat16)
    assert coded[4].dtype == torch.int8
    assert _same(coded[:4], plain[:4])


def test_route_predicate_matches_the_c_predicate_on_cuda(cuda_device):
    lib = _ext.load("lstm_fwd")
    for rows in (0, 1, 16, 160, 161):
        for hidden in (64, 128, 192, 256, 384, 512, 640, 1024):
            for dtype, code in _ext.DTYPE_CODE.items():
                assert bool(lib.lstm_persist_ok(rows, hidden, code)) == \
                    lstm_layer.persistent_route(rows, hidden, dtype)


def test_step_route_still_runs_bf16_on_cuda(cuda_device):
    """Naming the step route runs the one-launch-per-step kernels in bf16
    (kept for fp32 and for widths past the persistent route); both routes
    agree within the twin tolerance."""
    fwd_args, _ = _case(cuda_device, 24, 40, 256, seed=2)
    counts = lstm_layer.lstm_layer_fwd.route_launches
    before = counts["step"]
    with torch.no_grad():
        step = lstm_layer.lstm_layer_fwd(*fwd_args, route="step")
        persist = lstm_layer.lstm_layer_fwd(*fwd_args, route="persistent")
    assert counts["step"] == before + 1
    for g, w, tol in zip(step, persist, (3e-2, 3e-2, 2e-2, 2e-2)):
        assert _abs_err(g, w) <= tol
