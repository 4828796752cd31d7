"""The persistent bf16 stack kernels (``lstm_fwd_stack_persist``,
``lstm_bwd_stack_persist``): a layer wavefront of 2L - 1 clusters per
32-row tile, and their route.

On the CPU:
* the route predicate (``stack_persistent_route``) as a table, and a named
  persistent route that refuses other shapes;
* the wrapper's rule for splitting a call's rows into consecutive launches
  (``stack_row_splits``);
* a plain-torch model of the wavefront's dataflow, compared with the
  unchanged twins (``lstm_stack_fwd_plain``, ``lstm_stack_bwd_plain``) on
  ragged masks with PAD between songs, in fp32 and bf16: the forward runs
  layer 0 over all steps, then projects layer 1's input from the bf16 ys
  stream, then runs layer 1; the backward runs layer 1 from dys, then forms
  layer 0's dh from above from the bf16 dzx stream, then runs layer 0.  It
  is also held against ``fewshot.ops.lstm_fused`` (``_fwd_call`` and
  ``_bwd_call``, the kernels of ``lstm_stack_pallas``) in Pallas interpret
  mode, in a subprocess.

On the card (skips without one): both kernels against their twins at
training B's two shapes (16 rows x 480 steps, one launch; 80 rows x 95
steps, split launches), H 128, 256, 384 and 512, L 2 and 3; the same bits
from a second launch (its step flags fresh); ``route_launches``; and the
C predicate against its Python mirror.

Tolerances.  The model against the twins: 1e-6 absolute in fp32 and bf16
(the same fp32 products of the same bf16- or fp32-rounded operands, step by
step: only where a layer's steps run differs).  Against Pallas: as
tests/test_torch_lstm_kernels.py and test_torch_lstm_bwd.py (fp32 1e-5;
bf16 3e-2 / 2e-2 on the forward's streams / state, 3e-2 of each backward
output's largest).  The kernels against the twins: as
test_torch_lstm_persist.py (forward 3e-2 absolute on the bf16 streams and
gates, 2e-2 on the fp32 state; backward 3e-2 of each output's largest: a
bf16 rounding tie flipped by the order of an fp32 sum travels through the
remaining steps).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.ops import _ext, lstm_layer, lstm_stack

REPO = Path(__file__).resolve().parent.parent
T, B, H, NL = 12, 4, 128, 2
LENS = np.array([12, 1, 7, 10])
NAMES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("rows,hidden,layers,dtype,want", [
    (16, 512, 2, torch.bfloat16, True),      # training B, serving B
    (80, 512, 2, torch.bfloat16, True),      # training B's query pass
    (16, 128, 2, torch.bfloat16, True),
    (16, 256, 3, torch.bfloat16, True),
    (33, 384, 3, torch.bfloat16, True),
    (16, 512, 3, torch.bfloat16, True),      # 5 clusters of 16: 80 blocks
    (16, 512, 4, torch.bfloat16, False),     # 7 clusters of 16: past 96
    (16, 256, 7, torch.bfloat16, False),     # 13 clusters of 8: 104 blocks
    (16, 128, 12, torch.bfloat16, True),     # 23 clusters of 4: 92 blocks
    (16, 512, 2, torch.float32, False),      # fp32 keeps the step kernels
    (16, 640, 2, torch.bfloat16, False),     # past 16 blocks of 32 units
    (16, 192, 2, torch.bfloat16, False),     # not a multiple of 128
    (16, 512, 1, torch.bfloat16, False),     # the stack has 2 or more
    (0, 512, 2, torch.bfloat16, False),
])
def test_stack_persistent_route_predicate(rows, hidden, layers, dtype, want):
    assert lstm_stack.stack_persistent_route(rows, hidden, layers,
                                             dtype) is want


def _stack_args(t_, rows, hidden, layers, dtype=torch.float32):
    return (torch.zeros(t_, rows, 4 * hidden, dtype=dtype),
            torch.zeros(layers - 1, hidden, 4 * hidden, dtype=dtype),
            torch.zeros(layers, hidden, 4 * hidden, dtype=dtype),
            torch.zeros(layers, 4 * hidden), torch.ones(t_, rows, 1),
            torch.zeros(layers, rows, hidden),
            torch.zeros(layers, rows, hidden))


def test_named_persistent_stack_route_refuses_other_shapes():
    """Naming the persistent route on a shape it does not take raises, on
    the CPU as on the card, in both directions: nothing runs in its place;
    the step route and the route by shape still run the twin here."""
    args = _stack_args(2, 3, 128, 2)               # fp32: not the route
    with pytest.raises(ValueError, match="route"):
        lstm_stack.lstm_stack_fwd(*args, route="persistent")
    with pytest.raises(ValueError, match="route"):
        lstm_stack.lstm_stack_fwd(*args, route="wavefront")
    ys, cs, _, _, gates = lstm_stack.lstm_stack_fwd(*args, save_gates=True,
                                                    route="step")
    assert ys.shape == (2, 2, 3, 128)
    bargs = (gates, args[1], args[2], args[4], cs, args[6],
             torch.zeros(2, 3, 128), args[5], args[6])
    with pytest.raises(ValueError, match="route"):
        lstm_stack.lstm_stack_bwd(*bargs, route="persistent")
    assert lstm_stack.lstm_stack_bwd(*bargs)[0].shape == gates.shape
    bf_args = _stack_args(2, 3, 128, 2, torch.bfloat16)
    ys, *_ = lstm_stack.lstm_stack_fwd(*bf_args, route="persistent")
    assert ys.dtype == torch.bfloat16


@pytest.mark.parametrize("rows,tiles,want", [
    (16, 2, [(0, 16)]),                     # training B's support pass
    (80, 2, [(0, 64), (64, 80)]),           # its query pass: 64 + 16
    (64, 2, [(0, 64)]),
    (80, 1, [(0, 32), (32, 64), (64, 80)]),
    (33, 1, [(0, 32), (32, 33)]),
    (160, 5, [(0, 160)]),
])
def test_stack_row_splits(rows, tiles, want):
    assert lstm_stack.stack_row_splits(rows, tiles) == want


# ---------------------------------------------------------------------------
# The wavefront's dataflow, in plain torch
# ---------------------------------------------------------------------------

def wavefront_fwd(zx, wx_rest, wh, b, mask, h0, c0):
    """The forward as the wavefront computes it: each layer's recurrence
    over all steps before the next layer's, layer l >= 1 reading the fp32
    projection bf16(ys_{l-1}[t]) . Wx_l (a ring in the kernel) from the
    stored ys stream.  Returns the twin's (ys, cs, hT, cT, gates)."""
    wdt, sdt = wh.dtype, zx.dtype
    outs = []
    z = zx
    for l in range(wh.shape[0]):
        if l > 0:
            z = torch.stack([y.to(wdt).float() @ wx_rest[l - 1].float()
                             for y in outs[-1][0]])
        ys, cs, hT, cT, g = lstm_layer.lstm_layer_fwd_plain(
            z, wh[l], b[l], mask, h0[l], c0[l], save_gates=True,
            gates_dtype=sdt)
        outs.append((ys.to(sdt), cs.to(sdt), hT, cT, g))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(5))


def wavefront_bwd(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT):
    """The BPTT as the wavefront computes it: the top layer's recurrence
    over all steps from dys, then layer l-1's dh from above, bf16(dz_l[t]) .
    Wx_l^T in fp32 (a ring in the kernel) from the stored dzx stream, then
    layer l-1's recurrence.  Returns the twin's (dzx, dh0, dc0, db)."""
    wdt, sdt = wh.dtype, dys.dtype
    outs = {}
    ext = dys
    for l in reversed(range(wh.shape[0])):
        dzx, dh0, dc0, db = lstm_layer.lstm_layer_bwd_plain(
            gates[l], wh[l], mask, cs[l], c0[l], ext, dhT[l], dcT[l])
        outs[l] = (dzx.to(sdt), dh0, dc0, db)
        if l > 0:
            ext = torch.stack([d.to(wdt).float() @ wx_rest[l - 1].float().T
                               for d in outs[l][0]])
    return tuple(torch.stack([outs[l][k] for l in range(wh.shape[0])])
                 for k in range(4))


def _inputs(seed=0) -> dict:
    rng = np.random.RandomState(seed)
    lim = np.sqrt(6.0 / (5 * H))
    u = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)  # noqa
    n = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    # two songs per row with PAD between them, as support_mode=state packs
    half = T // 2
    hole = np.zeros((B, T), bool)
    hole[:, :half] = np.arange(half)[None] < (LENS[:, None] + 1) // 2
    hole[:, half:] = np.arange(T - half)[None] < LENS[:, None] // 2
    hole[1] = False
    hole[1, 0] = True                                              # length 1
    z = {"zx": n(0.6, T, B, 4 * H), "wx_rest": u(NL - 1, H, 4 * H),
         "wh": u(NL, H, 4 * H), "b": n(0.1, NL, 4 * H),
         "mask": hole.T[..., None].astype(np.float32),
         "h0": n(0.5, NL, B, H), "c0": n(0.5, NL, B, H),
         "dys": n(1.0, T, B, H), "dhT": n(1.0, NL, B, H),
         "dcT": n(1.0, NL, B, H)}
    return {k: np.ascontiguousarray(v) for k, v in z.items()}


def _torch_case(z, name):
    dt = TORCH_DT[name]
    t = {k: torch.tensor(v) for k, v in z.items()}
    fwd = (t["zx"].to(dt), t["wx_rest"].to(dt), t["wh"].to(dt), t["b"],
           t["mask"], t["h0"], t["c0"])
    return fwd, (t["dys"].to(dt), t["dhT"], t["dcT"])


def _abs_err(got, want):
    got = got.float().cpu() if isinstance(got, torch.Tensor) \
        else torch.tensor(got)
    want = want.float().cpu() if isinstance(want, torch.Tensor) \
        else torch.tensor(want)
    return float((got - want).abs().max()) if got.numel() else 0.0


def _rel_err(got, want):
    want_t = want.float().cpu() if isinstance(want, torch.Tensor) \
        else torch.tensor(want)
    scale = float(want_t.abs().max()) if want_t.numel() else 0.0
    return _abs_err(got, want) / max(scale, 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_model_matches_twins(name):
    fwd_args, (dys, dhT, dcT) = _torch_case(_inputs(), name)
    want = lstm_stack.lstm_stack_fwd_plain(*fwd_args, save_gates=True)
    got = wavefront_fwd(*fwd_args)
    for k, g, w in zip(("ys", "cs", "hT", "cT", "gates"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert _abs_err(g, w) <= 1e-6, (k, _abs_err(g, w))
    cs, gates = want[1], want[4]
    bargs = (gates, fwd_args[1], fwd_args[2], fwd_args[4], cs, fwd_args[6],
             dys, dhT, dcT)
    want_b = lstm_stack.lstm_stack_bwd_plain(*bargs)
    got_b = wavefront_bwd(*bargs)
    for k, g, w in zip(("dzx", "dh0", "dc0", "db"), got_b, want_b):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert _abs_err(g, w) <= 1e-6, (k, _abs_err(g, w))


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.ops import lstm_fused

d = sys.argv[1]
z = {k: jnp.asarray(v) for k, v in np.load(d + "/inputs.npz").items()}
out = {}
f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
for name in ("float32", "bfloat16"):
    dt = jnp.dtype(name)
    wx, wh = z["wx_rest"].astype(dt), z["wh"].astype(dt)
    ys, cs, hT, cT, gates = lstm_fused._fwd_call(
        z["zx"].astype(dt), wx, wh, z["b"], z["mask"], z["h0"], z["c0"],
        save_gates=True)
    dzx, dh0, dc0, db = lstm_fused._bwd_call(
        gates, wx, wh, z["mask"], cs, z["c0"], z["dys"].astype(dt), z["dhT"],
        z["dcT"])
    for k, v in (("ys", ys), ("cs", cs), ("hT", hT), ("cT", cT),
                 ("gates", gates), ("dzx", dzx), ("dh0", dh0), ("dc0", dc0),
                 ("db", db.sum(axis=(0, 2)))):
        out[f"{name}_{k}"] = f32(v)
np.savez(d + "/jax_out.npz", **out)
"""


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    d = tmp_path_factory.mktemp("lstm_stack_persist")
    z = _inputs()
    np.savez(d / "inputs.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, dict(np.load(d / "jax_out.npz"))


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_model_forward_matches_pallas(pallas, name):
    z, ref = pallas
    fwd_args, _ = _torch_case(z, name)
    got = wavefront_fwd(*fwd_args)
    tols = ((1e-5,) * 5 if name == "float32"
            else (3e-2, 3e-2, 2e-2, 2e-2, 3e-2))
    for k, g, tol in zip(("ys", "cs", "hT", "cT", "gates"), got, tols):
        assert _abs_err(g, ref[f"{name}_{k}"]) <= tol, \
            (k, _abs_err(g, ref[f"{name}_{k}"]))


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_model_backward_matches_pallas(pallas, name):
    """On the Pallas forward's own saved streams, so that the backward is
    compared alone."""
    z, ref = pallas
    fwd_args, (dys, dhT, dcT) = _torch_case(z, name)
    dt = TORCH_DT[name]
    gates = torch.tensor(ref[f"{name}_gates"]).to(dt)
    cs = torch.tensor(ref[f"{name}_cs"]).to(dt)
    got = wavefront_bwd(gates, fwd_args[1], fwd_args[2], fwd_args[4], cs,
                        fwd_args[6], dys, dhT, dcT)
    tol = 1e-5 if name == "float32" else 3e-2
    for k, g in zip(("dzx", "dh0", "dc0", "db"), got):
        assert _rel_err(g, ref[f"{name}_{k}"]) <= tol, \
            (k, _rel_err(g, ref[f"{name}_{k}"]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(dev, steps, rows, hidden, layers, songs, seed=0):
    """bf16 inputs at a training shape: `songs` songs of random length a
    row in equal slots (PAD between them), one row masked from step 0 and
    one of length 1."""
    rng = np.random.RandomState(seed)
    lim = np.sqrt(6.0 / (5 * hidden))
    slot = steps // songs
    live = np.zeros((rows, steps), bool)
    for r in range(rows):
        for s in range(songs):
            live[r, s * slot:s * slot + rng.randint(1, slot + 1)] = True
    live[0] = False
    live[1] = False
    live[1, 0] = True
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a, np.float32)).to(dev,
                                                                    dtype)
    fwd = (t(0.6 * rng.randn(steps, rows, 4 * hidden), bf),
           t(rng.uniform(-lim, lim, (layers - 1, hidden, 4 * hidden)), bf),
           t(rng.uniform(-lim, lim, (layers, hidden, 4 * hidden)), bf),
           t(0.1 * rng.randn(layers, 4 * hidden)),
           t(live.T[..., None]),
           t(0.5 * rng.randn(layers, rows, hidden)),
           t(0.5 * rng.randn(layers, rows, hidden)))
    cot = (t(rng.randn(steps, rows, hidden), bf),
           t(rng.randn(layers, rows, hidden)),
           t(rng.randn(layers, rows, hidden)))
    return fwd, cot


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hidden,layers", [(128, 2), (256, 2), (384, 2),
                                           (512, 2), (256, 3), (512, 3)])
@pytest.mark.parametrize("rows,steps,songs", [(16, 480, 5), (80, 95, 1)])
def test_persistent_stack_matches_twins_on_cuda(cuda_device, rows, steps,
                                                songs, hidden, layers):
    fwd_args, (dys, dhT, dcT) = _card_case(cuda_device, steps, rows, hidden,
                                           layers, songs)
    assert lstm_stack.stack_persistent_route(rows, hidden, layers,
                                             torch.bfloat16)
    fwd_counts = lstm_stack.lstm_stack_fwd.route_launches
    before = dict(fwd_counts)
    with torch.no_grad():
        got = lstm_stack.lstm_stack_fwd(*fwd_args, save_gates=True)
        want = lstm_stack.lstm_stack_fwd_plain(*fwd_args, save_gates=True)
        served = lstm_stack.lstm_stack_fwd(*fwd_args)
        again = lstm_stack.lstm_stack_fwd(*fwd_args, save_gates=True)
    torch.cuda.synchronize()
    assert fwd_counts["persistent"] == before["persistent"] + 3
    assert fwd_counts["step"] == before["step"]
    for k, g, w, tol in zip(("ys", "cs", "hT", "cT", "gates"), got, want,
                            (3e-2, 3e-2, 2e-2, 2e-2, 3e-2)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert _abs_err(g, w) <= tol, (k, _abs_err(g, w))
    assert _same(got, again), "a second launch gave other bits"
    assert _same(got[:4], served), "serving's null gates changed the state"

    cs, gates = got[1], got[4]
    bargs = (gates, fwd_args[1], fwd_args[2], fwd_args[4], cs, fwd_args[6],
             dys, dhT, dcT)
    bwd_counts = lstm_stack.lstm_stack_bwd.route_launches
    before = dict(bwd_counts)
    got_b = lstm_stack.lstm_stack_bwd(*bargs)
    want_b = lstm_stack.lstm_stack_bwd_plain(*bargs)
    again_b = lstm_stack.lstm_stack_bwd(*bargs)
    torch.cuda.synchronize()
    assert bwd_counts["persistent"] == before["persistent"] + 2
    assert bwd_counts["step"] == before["step"]
    for k, g, w in zip(("dzx", "dh0", "dc0", "db"), got_b, want_b):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert _rel_err(g, w) <= 3e-2, (k, _rel_err(g, w))
    assert _same(got_b, again_b), "a second launch gave other bits"


def test_split_launches_on_cuda(cuda_device):
    """80 rows at H=512, L=2 take consecutive launches of at most the
    tiles the card holds at once (2 on an H100: 6 of its 7 clusters of 16),
    the same rows as one tile at a time would give."""
    tiles = lstm_stack.launch_tiles("lstm_fwd", 512, 2, cuda_device)
    assert tiles >= 1
    assert lstm_stack.launch_tiles("lstm_bwd", 512, 2, cuda_device) >= 1
    assert len(lstm_stack.stack_row_splits(80, tiles)) == -(-3 // tiles)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_launch_the_card_cannot_hold_is_refused_on_cuda(cuda_device,
                                                        monkeypatch,
                                                        direction):
    """A launch of more row tiles than the card holds at once (3 tiles of
    3 clusters of 16 at H=512, L=2: 9 clusters, where 7 fit) is refused by
    the cooperative launch before it runs: the wrapper raises, nothing
    runs in its place, and the next call runs as before."""
    fwd_args, (dys, dhT, dcT) = _card_case(cuda_device, 8, 96, 512, 2, 1)
    with torch.no_grad():
        _, cs, _, _, gates = lstm_stack.lstm_stack_fwd(*fwd_args,
                                                       save_gates=True)
    bargs = (gates, fwd_args[1], fwd_args[2], fwd_args[4], cs, fwd_args[6],
             dys, dhT, dcT)

    def call():
        if direction == "fwd":
            return lstm_stack.lstm_stack_fwd(*fwd_args, save_gates=True)
        return lstm_stack.lstm_stack_bwd(*bargs)
    want = call()
    counts = getattr(lstm_stack, f"lstm_stack_{direction}").route_launches
    before = dict(counts)
    with monkeypatch.context() as m:
        m.setattr(lstm_stack, "launch_tiles", lambda *a: 3)
        with torch.no_grad(), pytest.raises(RuntimeError,
                                            match="CUDA error 720"):
            call()
    assert counts == before
    with torch.no_grad():
        assert _same(call(), want)
    torch.cuda.synchronize()


def test_stack_route_predicate_matches_the_c_predicate_on_cuda(cuda_device):
    lib = _ext.load("lstm_fwd")
    for rows in (0, 1, 16, 80, 161):
        for hidden in (64, 128, 192, 256, 384, 512, 640):
            for layers in (1, 2, 3, 4, 7, 12, 13):
                for dtype, code in _ext.DTYPE_CODE.items():
                    assert bool(lib.lstm_stack_persist_ok(
                        rows, hidden, layers, code)) == \
                        lstm_stack.stack_persistent_route(rows, hidden,
                                                          layers, dtype)


def test_step_route_still_runs_bf16_stacks_on_cuda(cuda_device):
    """Naming the step route runs the one-launch-per-step kernels in bf16
    (kept for fp32 and every other stack); both routes agree within the
    twin tolerance."""
    fwd_args, _ = _card_case(cuda_device, 40, 24, 256, 2, 2, seed=2)
    counts = lstm_stack.lstm_stack_fwd.route_launches
    before = counts["step"]
    with torch.no_grad():
        step = lstm_stack.lstm_stack_fwd(*fwd_args, route="step")
        persist = lstm_stack.lstm_stack_fwd(*fwd_args, route="persistent")
    assert counts["step"] == before + 1
    for g, w, tol in zip(step, persist, (3e-2, 3e-2, 2e-2, 2e-2)):
        assert _abs_err(g, w) <= tol
