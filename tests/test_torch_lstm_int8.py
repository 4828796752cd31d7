"""The int8-gates branch of kernels 1-2 (FEWSHOT_LSTM_GATES_INT8) against
the JAX package's Pallas kernels in interpret mode.

The JAX side runs once for the file, in a subprocess with
FEWSHOT_LSTM_GATES_INT8=1 and FEWSHOT_PALLAS_INTERPRET=1 (both read when
fewshot.ops.lstm_pallas is imported), at a routed batch (b=32: the TPU
kernel's batch tile is 32, so the gates are int8) and an unrouted one
(b=24: tile 24, the stream dtype), in fp32 and bf16: the forward with saved
gates, the forward again with the flag cleared, the backward kernel on its
own saved streams, and jax.grad through lstm_scan_pallas.  The port's side
sets ``lstm_layer.GATES_INT8`` as its import would.

Tolerances: the forward and the grads as in test_torch_lstm_kernels.py and
test_torch_lstm_bwd.py (fp32 1e-5, only the order of the fp32 sums
differs; bf16 3e-2 on the streams, 2e-2 on the state).  The codes: one
step, where an activation that differs in its last bits (the sums' order)
rounds to the neighbouring code.  The backward on JAX's own codes decodes
the same int8 values on both sides.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.ops import lstm_layer

REPO = Path(__file__).resolve().parent.parent
T, H = 12, 128
BATCHES = (32, 24)
NAMES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 2e-2)}    # streams, state
CODE_TOL = 1
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.ops import lstm_pallas as P

assert P._GATES_INT8
d = sys.argv[1]
out = {}
f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
for b in (32, 24):
    z = {k: jnp.asarray(v) for k, v in np.load(f"{d}/inputs_{b}.npz").items()}
    for name in ("float32", "bfloat16"):
        dt = jnp.dtype(name)
        key = f"{b}_{name}"
        args = (z["zx"].astype(dt), z["wh"].astype(dt), z["b"], z["mask_t"],
                z["h0"], z["c0"])
        P._GATES_INT8 = True
        ys, cs, hT, cT, gates = P._fwd_call(*args, save_gates=True)
        out[f"{key}_gates_int8"] = np.asarray(gates.dtype == jnp.int8)
        out[f"{key}_gates"] = np.asarray(gates.astype(jnp.float32))
        for k, v in (("ys", ys), ("cs", cs), ("hT", hT), ("cT", cT)):
            out[f"{key}_{k}"] = f32(v)
        dzx, dh0, dc0, db = P._bwd_call(
            gates, args[1], z["mask_t"], cs, z["c0"], z["dys"].astype(dt),
            z["dhT"], z["dcT"])
        for k, v in (("dzx", dzx), ("dh0", dh0), ("dc0", dc0),
                     ("db", db.sum(axis=(0, 1)))):
            out[f"{key}_{k}"] = f32(v)

        def loss(zx, wh, bb, h0, c0):
            ys, hT, cT = P.lstm_scan_pallas(zx, wh, bb, z["mask_t"], h0, c0)
            return (jnp.sum(ys.astype(jnp.float32) * z["dys"])
                    + jnp.sum(hT * z["dhT"]) + jnp.sum(cT * z["dcT"]))
        grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args[:3], *args[4:])
        for k, g in zip(("zx", "wh", "b", "h0", "c0"), grads):
            out[f"{key}_grad_{k}"] = f32(g)
        P._GATES_INT8 = False
        plain = P._fwd_call(*args, save_gates=True)
        out[f"{key}_fwd_unchanged"] = np.asarray(all(
            bool(jnp.array_equal(x, y))
            for x, y in zip((ys, cs, hT, cT), plain[:4])))
np.savez(d + "/jax_out.npz", **out)
"""


def _inputs(b: int) -> dict:
    rng = np.random.RandomState(b)
    lim = np.sqrt(6.0 / (5 * H))
    lens = rng.randint(1, T + 1, b)
    lens[0], lens[1] = 0, 1            # masked from step 0; length 1
    mask = np.arange(T)[None, :] < lens[:, None]                   # [B, T]
    n = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    z = {"zx": n(0.6, T, b, 4 * H),
         "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(np.float32),
         "b": n(0.1, 4 * H), "h0": n(0.5, b, H), "c0": n(0.5, b, H),
         "mask_t": mask.T[..., None].astype(np.float32),
         "dys": n(1.0, T, b, H), "dhT": n(1.0, b, H), "dcT": n(1.0, b, H)}
    return {k: np.ascontiguousarray(v) for k, v in z.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("lstm_int8")
    zs = {b: _inputs(b) for b in BATCHES}
    for b, z in zs.items():
        np.savez(d / f"inputs_{b}.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1",
               FEWSHOT_LSTM_GATES_INT8="1", JAX_PLATFORMS="cpu")
    env.pop("FEWSHOT_LSTM_TILES", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return zs, dict(np.load(d / "jax_out.npz"))


@pytest.fixture
def int8_flag(monkeypatch):
    """FEWSHOT_LSTM_GATES_INT8=1 as the port reads it at import."""
    monkeypatch.setattr(lstm_layer, "GATES_INT8", True)
    monkeypatch.delenv("FEWSHOT_LSTM_TILES", raising=False)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _fwd_args(z, dt):
    return (_t(z["zx"], dt), _t(z["wh"], dt), _t(z["b"]), _t(z["mask_t"]),
            _t(z["h0"]), _t(z["c0"]))


def _abs(got, want):
    return float(np.abs(got.float().numpy() - want).max())


def _rel(got, want):
    return _abs(got, want) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b", BATCHES)
def test_int8_rule_matches_pallas(case, int8_flag, b, name):
    """Both packages code the same calls: b=32 in int8, b=24 in the stream
    dtype."""
    _, ref = case
    dt = TORCH_DT[name]
    coded = bool(ref[f"{b}_{name}_gates_int8"])
    assert coded == (b == 32)
    assert lstm_layer.saved_gates_dtype(b, T, H, dt) == \
        (torch.int8 if coded else dt)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b", BATCHES)
def test_int8_twin_forward_matches_pallas(case, int8_flag, b, name):
    zs, ref = case
    dt, key = TORCH_DT[name], f"{b}_{name}"
    assert bool(ref[f"{key}_fwd_unchanged"]), "JAX's forward moved"
    with torch.no_grad():
        got = lstm_layer.lstm_layer_fwd(*_fwd_args(zs[b], dt),
                                        save_gates=True)
        stream = lstm_layer.lstm_layer_fwd(*_fwd_args(zs[b], dt),
                                           save_gates=True, gates_dtype=dt)
    tol_s, tol_h = TOL[name]
    for k, g, tol in zip(("ys", "cs", "hT", "cT"), got,
                         (tol_s, tol_s, tol_h, tol_h)):
        assert _abs(g, ref[f"{key}_{k}"]) <= tol, k
    # the gates are a residual only: the state is the same bits
    assert all(torch.equal(x, y) for x, y in zip(got[:4], stream[:4]))
    gates = got[4]
    if b == 32:
        assert gates.dtype == torch.int8
        assert _abs(gates, ref[f"{key}_gates"]) <= CODE_TOL
    else:
        assert gates.dtype == dt
        assert _abs(gates, ref[f"{key}_gates"]) <= 3e-2


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b", BATCHES)
def test_int8_twin_backward_matches_pallas(case, b, name):
    """The backward twin on JAX's own saved streams (int8 codes at b=32)."""
    zs, ref = case
    dt, key = TORCH_DT[name], f"{b}_{name}"
    z = zs[b]
    gdt = torch.int8 if b == 32 else dt
    dzx, dh0, dc0, db = lstm_layer.lstm_layer_bwd(
        _t(ref[f"{key}_gates"], gdt), _t(z["wh"], dt), _t(z["mask_t"]),
        _t(ref[f"{key}_cs"], dt), _t(z["c0"]), _t(z["dys"], dt),
        _t(z["dhT"]), _t(z["dcT"]))
    assert dzx.dtype == dt
    for k, v in (("dzx", dzx), ("dh0", dh0), ("dc0", dc0), ("db", db)):
        assert _rel(v, ref[f"{key}_{k}"]) <= GRAD_TOL[name], k


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("b", BATCHES)
def test_int8_function_grads_match_jax(case, int8_flag, b, name):
    """LSTMLayerFn (forward saving int8 codes at b=32, backward decoding
    them) against jax.grad of lstm_scan_pallas with the flag set."""
    zs, ref = case
    dt, key = TORCH_DT[name], f"{b}_{name}"
    z = zs[b]
    leaves = [_t(z[k], dt if k in ("zx", "wh") else torch.float32)
              .requires_grad_() for k in ("zx", "wh", "b", "h0", "c0")]
    zx, wh, bb, h0, c0 = leaves
    ys, hT, cT = lstm_layer.LSTMLayerFn.apply(zx, wh, bb, _t(z["mask_t"]),
                                              h0, c0)
    loss = ((ys.float() * _t(z["dys"])).sum() + (hT * _t(z["dhT"])).sum()
            + (cT * _t(z["dcT"])).sum())
    for k, g in zip(("zx", "wh", "b", "h0", "c0"),
                    torch.autograd.grad(loss, leaves)):
        assert _rel(g, ref[f"{key}_grad_{k}"]) <= GRAD_TOL[name], k


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hidden", [128, 256, 512, 1024])
def test_saved_gates_rule_matches_jax_tiles(monkeypatch, hidden, name):
    """The batch tile, and with it the int8 choice, over a grid of batch
    sizes: the port's copy of _tiles against the JAX package's."""
    from fewshot.ops import lstm_pallas as P
    monkeypatch.delenv("FEWSHOT_LSTM_TILES", raising=False)
    monkeypatch.setattr(lstm_layer, "GATES_INT8", True)
    dt = TORCH_DT[name]
    item = 4 if name == "float32" else 2
    for b in (1, 5, 8, 16, 24, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256,
              320, 480, 512):
        for t in (1, 12, 95, 96):
            bt = P._tiles(b, t, hidden, item)
            assert lstm_layer._tiles(b, t, hidden, item) == bt
            assert lstm_layer.saved_gates_dtype(b, t, hidden, dt) == \
                (torch.int8 if bt[0] % 32 == 0 else dt)


def test_saved_gates_rule_at_training_a():
    """bf16 at 160 rows and H=512 gives a batch tile of 160 (coded under
    the flag); fp32 at the same shape gives 80 (never coded)."""
    assert lstm_layer._tiles(160, 96, 512, 2)[0] == 160
    assert lstm_layer._tiles(160, 96, 512, 4)[0] == 80


def test_gates_flag_is_read_at_import():
    code = ("from fewshot_torch.ops import lstm_layer as L; "
            "import torch; assert L.GATES_INT8; "
            "assert L.saved_gates_dtype(160, 96, 512, torch.bfloat16) "
            "== torch.int8; "
            "assert L.saved_gates_dtype(160, 96, 512, torch.float32) "
            "== torch.float32; print('OK')")
    env = dict(os.environ, FEWSHOT_LSTM_GATES_INT8="1")
    env.pop("FEWSHOT_LSTM_TILES", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]
