"""The port's LSTM backward ops against the JAX Pallas backward kernels.

* the forward twins' saved gate activations against ``_fwd_call(...,
  save_gates=True)`` of both Pallas forward kernels;
* both backward twins against ``lstm_pallas._bwd_call`` and
  ``lstm_fused._bwd_call`` on the same saved streams;
* both autograd Functions' grads with respect to zx, wh, wx_rest, b, h0 and
  c0 against ``jax.grad`` of ``lstm_scan_pallas`` and ``lstm_stack_pallas``;
* the fused stack's refusal to differentiate an eval-only shape, and the
  backward's hidden-size limit;
* on the card: each backward kernel against its twin (skips without CUDA).

Inputs are made with numpy from a seed: T=12 steps, 4 rows, H=128, ragged
masks with a length-1 row (and PAD between two songs for the stack),
nonzero initial state.  The JAX side runs once for the file, in a
subprocess, in Pallas interpret mode (FEWSHOT_PALLAS_INTERPRET is read when
fewshot.ops.lstm_pallas is imported).

Tolerances, each relative to the largest magnitude of the compared array:
fp32 1e-5 (the same function; only the order of the fp32 sums in dz @ Wh^T,
db and dWh differs).  bf16 3e-2: both sides store gates, cs and dzx in
bf16, rebuild c_{t-1} and tanh(c_t) from the bf16 cs stream, and round dz to
bf16 before dz @ Wh^T; an fp32 sum that lands on the other side of a bf16
tie flips one dz by one bf16 step (2^-8 relative), and the flip travels
back through the remaining steps.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.models.lstm import LSTMLayer
from fewshot_torch.ops import lstm_layer, lstm_stack

REPO = Path(__file__).resolve().parent.parent
T, B, H, NL = 12, 4, 128, 2
LENS = np.array([12, 1, 7, 10])
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("float32", "bfloat16")

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.ops import lstm_fused, lstm_pallas

d = sys.argv[1]
z = {k: jnp.asarray(v) for k, v in np.load(d + "/inputs.npz").items()}
out = {}
f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
for name in ("float32", "bfloat16"):
    dt = jnp.dtype(name)
    # per-layer kernel pair, called directly
    ys, cs, hT, cT, gates = lstm_pallas._fwd_call(
        z["zx"].astype(dt), z["wh"].astype(dt), z["b"], z["mask_t"], z["h0"],
        z["c0"], save_gates=True)
    dzx, dh0, dc0, db = lstm_pallas._bwd_call(
        gates, z["wh"].astype(dt), z["mask_t"], cs, z["c0"],
        z["dys"].astype(dt), z["dhT"], z["dcT"])
    for k, v in (("gates", gates), ("cs", cs), ("dzx", dzx), ("dh0", dh0),
                 ("dc0", dc0), ("db", db.sum(axis=(0, 1)))):
        out[f"layer_{name}_{k}"] = f32(v)

    def layer_loss(zx, wh, b, h0, c0):
        ys, hT, cT = lstm_pallas.lstm_scan_pallas(zx, wh, b, z["mask_t"],
                                                  h0, c0)
        return (jnp.sum(ys.astype(jnp.float32) * z["dys"])
                + jnp.sum(hT * z["dhT"]) + jnp.sum(cT * z["dcT"]))
    grads = jax.grad(layer_loss, argnums=(0, 1, 2, 3, 4))(
        z["zx"].astype(dt), z["wh"].astype(dt), z["b"], z["h0"], z["c0"])
    for k, g in zip(("zx", "wh", "b", "h0", "c0"), grads):
        out[f"layer_grad_{name}_{k}"] = f32(g)

    # fused stack kernel pair, called directly
    ys, cs, hT, cT, gates = lstm_fused._fwd_call(
        z["zx"].astype(dt), z["wx_rest"].astype(dt), z["wh2"].astype(dt),
        z["b2"], z["hole_t"], z["h02"], z["c02"], save_gates=True)
    dzx, dh0, dc0, db = lstm_fused._bwd_call(
        gates, z["wx_rest"].astype(dt), z["wh2"].astype(dt), z["hole_t"], cs,
        z["c02"], z["dys"].astype(dt), z["dhT2"], z["dcT2"])
    for k, v in (("gates", gates), ("cs", cs), ("dzx", dzx), ("dh0", dh0),
                 ("dc0", dc0), ("db", db.sum(axis=(0, 2)))):
        out[f"stack_{name}_{k}"] = f32(v)

    def stack_loss(zx, wx, wh, b, h0, c0):
        ys, hT, cT = lstm_fused.lstm_stack_pallas(zx, wx, wh, b, z["hole_t"],
                                                  h0, c0)
        return (jnp.sum(ys.astype(jnp.float32) * z["dys"])
                + jnp.sum(hT * z["dhT2"]) + jnp.sum(cT * z["dcT2"]))
    grads = jax.grad(stack_loss, argnums=(0, 1, 2, 3, 4, 5))(
        z["zx"].astype(dt), z["wx_rest"].astype(dt), z["wh2"].astype(dt),
        z["b2"], z["h02"], z["c02"])
    for k, g in zip(("zx", "wx_rest", "wh", "b", "h0", "c0"), grads):
        out[f"stack_grad_{name}_{k}"] = f32(g)
np.savez(d + "/jax_out.npz", **out)
"""


def _inputs() -> dict:
    rng = np.random.RandomState(0)
    lim = np.sqrt(6.0 / (5 * H))
    u = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)  # noqa
    n = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    mask = np.arange(T)[None, :] < LENS[:, None]                   # [B, T]
    # two songs per row with PAD between them, as support_mode=state packs
    half = T // 2
    hole = np.zeros((B, T), bool)
    hole[:, :half] = np.arange(half)[None] < (LENS[:, None] + 1) // 2
    hole[:, half:] = np.arange(T - half)[None] < LENS[:, None] // 2
    hole[1] = False
    hole[1, 0] = True                                              # length 1
    z = {
        "zx": n(0.6, T, B, 4 * H), "wh": u(H, 4 * H), "b": n(0.1, 4 * H),
        "h0": n(0.5, B, H), "c0": n(0.5, B, H),
        "mask_t": mask.T[..., None].astype(np.float32),
        "hole_t": hole.T[..., None].astype(np.float32),
        "wx_rest": u(NL - 1, H, 4 * H), "wh2": u(NL, H, 4 * H),
        "b2": n(0.1, NL, 4 * H), "h02": n(0.5, NL, B, H),
        "c02": n(0.5, NL, B, H),
        "dys": n(1.0, T, B, H), "dhT": n(1.0, B, H), "dcT": n(1.0, B, H),
        "dhT2": n(1.0, NL, B, H), "dcT2": n(1.0, NL, B, H),
    }
    return {k: np.ascontiguousarray(v) for k, v in z.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("lstm_bwd")
    z = _inputs()
    np.savez(d / "inputs.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, dict(np.load(d / "jax_out.npz"))


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _close(got, want, rel, what=""):
    got = got.float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("name", NAMES)
def test_layer_gates_match_pallas(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    with torch.no_grad():
        ys, cs, hT, cT, gates = lstm_layer.lstm_layer_fwd(
            _t(z["zx"], dt), _t(z["wh"], dt), _t(z["b"]), _t(z["mask_t"]),
            _t(z["h0"]), _t(z["c0"]), save_gates=True)
    assert gates.dtype == dt and gates.shape == (T, B, 4 * H)
    _close(gates, ref[f"layer_{name}_gates"], TOL[name], "gates")


@pytest.mark.parametrize("name", NAMES)
def test_stack_gates_match_pallas(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    with torch.no_grad():
        out = lstm_stack.lstm_stack_fwd(
            _t(z["zx"], dt), _t(z["wx_rest"], dt), _t(z["wh2"], dt),
            _t(z["b2"]), _t(z["hole_t"]), _t(z["h02"]), _t(z["c02"]),
            save_gates=True)
    assert out[4].dtype == dt and out[4].shape == (NL, T, B, 4 * H)
    _close(out[4], ref[f"stack_{name}_gates"], TOL[name], "gates")


@pytest.mark.parametrize("name", NAMES)
def test_layer_bwd_twin_matches_pallas(case, name):
    """The twin on JAX's own saved streams (gates, cs) and cotangents."""
    z, ref = case
    dt = TORCH_DT[name]
    dzx, dh0, dc0, db = lstm_layer.lstm_layer_bwd(
        _t(ref[f"layer_{name}_gates"], dt), _t(z["wh"], dt),
        _t(z["mask_t"]), _t(ref[f"layer_{name}_cs"], dt), _t(z["c0"]),
        _t(z["dys"], dt), _t(z["dhT"]), _t(z["dcT"]))
    assert dzx.dtype == dt and db.shape == (4 * H,)
    for k, v in (("dzx", dzx), ("dh0", dh0), ("dc0", dc0), ("db", db)):
        _close(v, ref[f"layer_{name}_{k}"], TOL[name], k)


@pytest.mark.parametrize("name", NAMES)
def test_stack_bwd_twin_matches_pallas(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    dzx, dh0, dc0, db = lstm_stack.lstm_stack_bwd(
        _t(ref[f"stack_{name}_gates"], dt), _t(z["wx_rest"], dt),
        _t(z["wh2"], dt), _t(z["hole_t"]), _t(ref[f"stack_{name}_cs"], dt),
        _t(z["c02"]), _t(z["dys"], dt), _t(z["dhT2"]), _t(z["dcT2"]))
    assert dzx.dtype == dt and db.shape == (NL, 4 * H)
    for k, v in (("dzx", dzx), ("dh0", dh0), ("dc0", dc0), ("db", db)):
        _close(v, ref[f"stack_{name}_{k}"], TOL[name], k)


def _leaves(z, dt, keys):
    return [_t(z[k], dt if k.startswith(("zx", "wh", "wx")) else
               torch.float32).requires_grad_() for k in keys]


@pytest.mark.parametrize("name", NAMES)
def test_layer_function_grads_match_jax(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    zx, wh, b, h0, c0 = _leaves(z, dt, ("zx", "wh", "b", "h0", "c0"))
    ys, hT, cT = lstm_layer.LSTMLayerFn.apply(zx, wh, b, _t(z["mask_t"]), h0,
                                              c0)
    loss = ((ys.float() * _t(z["dys"])).sum() + (hT * _t(z["dhT"])).sum()
            + (cT * _t(z["dcT"])).sum())
    grads = torch.autograd.grad(loss, [zx, wh, b, h0, c0])
    for k, g, leaf in zip(("zx", "wh", "b", "h0", "c0"), grads,
                          (zx, wh, b, h0, c0)):
        assert g.dtype == leaf.dtype
        _close(g, ref[f"layer_grad_{name}_{k}"], TOL[name], k)


@pytest.mark.parametrize("name", NAMES)
def test_stack_function_grads_match_jax(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    keys = ("zx", "wx_rest", "wh2", "b2", "h02", "c02")
    leaves = _leaves(z, dt, keys)
    ys, hT, cT = lstm_stack.LSTMStackFn.apply(
        *leaves[:4], _t(z["hole_t"]), *leaves[4:])
    loss = ((ys.float() * _t(z["dys"])).sum() + (hT * _t(z["dhT2"])).sum()
            + (cT * _t(z["dcT2"])).sum())
    grads = torch.autograd.grad(loss, leaves)
    for k, g in zip(("zx", "wx_rest", "wh", "b", "h0", "c0"), grads):
        _close(g, ref[f"stack_grad_{name}_{k}"], TOL[name], k)


def test_adapters_differentiate_through_the_functions():
    """lstm_layer_pallas and lstm_stack_fused run the Functions when a grad
    is needed and the plain forward otherwise; their grads match autograd
    through the plain step loop (fp32)."""
    from fewshot_torch.models.lstm import _layer_scan
    rng = np.random.RandomState(5)
    e = 16
    layers = [LSTMLayer(_t(0.2 * rng.randn(e if l == 0 else H, 4 * H)),
                        _t(0.05 * rng.randn(H, 4 * H)),
                        _t(0.1 * rng.randn(4 * H))) for l in range(NL)]
    x = _t(rng.randn(3, 5, e))
    mask = torch.tensor(np.arange(5)[None] < np.array([5, 1, 3])[:, None])
    state = [(_t(0.5 * rng.randn(3, H)), _t(0.5 * rng.randn(3, H)))
             for _ in range(NL)]

    def run(fn):
        for l in layers:
            for p in l.parameters():
                p.grad = None
        ys, st = fn()
        (ys.sum() + sum((h * 0.5 + c * 0.25).sum() for h, c in st)).backward()
        return [p.grad.clone() for l in layers for p in l.parameters()]

    def scan():
        ys, out = x, []
        for layer, hc in zip(layers, state):
            ys, hc = _layer_scan(layer, ys, mask, hc, torch.float32)
            out.append(hc)
        return ys, out

    def per_layer():
        ys, out = x, []
        for layer, hc in zip(layers, state):
            ys, hc = lstm_layer.lstm_layer_pallas(layer, ys, mask, hc,
                                                  torch.float32)
            out.append(hc)
        return ys, out

    want = run(scan)
    for fn in (per_layer, lambda: lstm_stack.lstm_stack_fused(
            layers, x, mask, state, torch.float32)):
        for g, w in zip(run(fn), want):
            _close(g, w.numpy(), 1e-5)


def test_stack_function_refuses_eval_only_shape():
    """H=512, 2 layers, bf16 at 128 rows: admitted by the fused stack only
    in eval mode; differentiating it raises, as lstm_fused._vjp_fwd does."""
    hidden, rows = 512, 128
    tl = [LSTMLayer(torch.zeros(hidden, 4 * hidden),
                    torch.zeros(hidden, 4 * hidden), torch.zeros(4 * hidden))
          for _ in range(2)]
    assert lstm_stack.stack_fused_supported(tl, torch.bfloat16, rows,
                                            eval_mode=True)
    assert not lstm_stack.stack_fused_supported(tl, torch.bfloat16, rows)
    zx = torch.zeros((1, rows, 4 * hidden), dtype=torch.bfloat16,
                     requires_grad=True)
    with pytest.raises(ValueError, match="eval_mode"):
        lstm_stack.LSTMStackFn.apply(
            zx, torch.zeros((1, hidden, 4 * hidden), dtype=torch.bfloat16),
            torch.zeros((2, hidden, 4 * hidden), dtype=torch.bfloat16),
            torch.zeros(2, 4 * hidden), torch.ones(1, rows, 1),
            torch.zeros(2, rows, hidden), torch.zeros(2, rows, hidden))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_backward_hidden_limit(dt):
    """No hidden-size limit remains: the step kernels walk the 4H-deep
    contraction in chunks, so train mode runs at widths the whole-row stage
    refused (fp32 H = 768, bf16 H = 1536), forward and backward, with no
    switch to a plain step loop; the grads are finite and shaped."""
    hidden = 768 if dt == torch.float32 else 1536
    rng = np.random.RandomState(hidden)
    layer = LSTMLayer(
        torch.tensor(0.1 * rng.randn(8, 4 * hidden), dtype=torch.float32),
        torch.tensor(0.02 * rng.randn(hidden, 4 * hidden),
                     dtype=torch.float32).requires_grad_(True),
        torch.zeros(4 * hidden))
    state = (torch.zeros(2, hidden), torch.zeros(2, hidden))
    x = torch.tensor(rng.randn(2, 3, 8), dtype=torch.float32)
    ys, _ = lstm_layer.lstm_layer_pallas(layer, x, None, state, dt)
    assert ys.shape == (2, 3, hidden)
    ys.sum().backward()
    assert layer.wh.grad.shape == (hidden, 4 * hidden)
    assert bool(torch.isfinite(layer.wh.grad).all())
    assert float(layer.wh.grad.abs().max()) > 0
    assert not hasattr(lstm_layer, "max_hidden_bwd")


# ---------------------------------------------------------------------------
# On the card: each backward kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(rng, dt, dev, t_, rows, h, n_layers):
    lim = np.sqrt(6.0 / (5 * h))
    lead = (n_layers,) if n_layers > 1 else ()
    lens = rng.randint(1, t_ + 1, rows)
    lens[0] = 1
    mask = _t((np.arange(t_)[:, None] < lens[None])[..., None]).to(dev)
    zx = _t(0.6 * rng.randn(t_, rows, 4 * h), dt).to(dev)
    wh = _t(rng.uniform(-lim, lim, lead + (h, 4 * h)), dt).to(dev)
    b = _t(0.1 * rng.randn(*lead, 4 * h)).to(dev)
    h0 = _t(0.5 * rng.randn(*lead, rows, h)).to(dev)
    c0 = _t(0.5 * rng.randn(*lead, rows, h)).to(dev)
    dys = _t(rng.randn(t_, rows, h), dt).to(dev)
    dhT = _t(rng.randn(*lead, rows, h)).to(dev)
    dcT = _t(rng.randn(*lead, rows, h)).to(dev)
    wx = _t(rng.uniform(-lim, lim, (n_layers - 1, h, 4 * h)), dt).to(dev)
    return zx, wx, wh, b, mask, h0, c0, dys, dhT, dcT


# fp32: the kernel sums the 4H products in another order than the twin;
# bf16: as on the CPU (module docstring)
CUDA_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("rows", [8, 40])
def test_layer_bwd_kernel_matches_twin_on_cuda(cuda_device, name, rows):
    dt = TORCH_DT[name]
    zx, _, wh, b, mask, h0, c0, dys, dhT, dcT = _card_case(
        np.random.RandomState(6), dt, cuda_device, 24, rows, 256, 1)
    _, cs, _, _, gates = lstm_layer.lstm_layer_fwd(zx, wh, b, mask, h0, c0,
                                                   save_gates=True)
    _, _, _, _, gates_plain = lstm_layer.lstm_layer_fwd_plain(
        zx, wh, b, mask, h0, c0, save_gates=True)
    _close(gates, gates_plain.float().cpu().numpy(), CUDA_TOL[name], "gates")
    before = lstm_layer.lstm_layer_bwd.launches
    got = lstm_layer.lstm_layer_bwd(gates, wh, mask, cs, c0, dys, dhT, dcT)
    want = lstm_layer.lstm_layer_bwd_plain(gates, wh, mask, cs, c0, dys, dhT,
                                           dcT)
    torch.cuda.synchronize()
    assert lstm_layer.lstm_layer_bwd.launches == before + 1
    for k, g, w in zip(("dzx", "dh0", "dc0", "db"), got, want):
        assert g.dtype == w.dtype
        _close(g, w.float().cpu().numpy(), CUDA_TOL[name], k)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("rows", [8, 40])
def test_stack_bwd_kernel_matches_twin_on_cuda(cuda_device, name, rows):
    dt = TORCH_DT[name]
    zx, wx, wh, b, mask, h0, c0, dys, dhT, dcT = _card_case(
        np.random.RandomState(7), dt, cuda_device, 24, rows, 256, NL)
    _, cs, _, _, gates = lstm_stack.lstm_stack_fwd(zx, wx, wh, b, mask, h0,
                                                   c0, save_gates=True)
    before = lstm_stack.lstm_stack_bwd.launches
    got = lstm_stack.lstm_stack_bwd(gates, wx, wh, mask, cs, c0, dys, dhT,
                                    dcT)
    want = lstm_stack.lstm_stack_bwd_plain(gates, wx, wh, mask, cs, c0, dys,
                                           dhT, dcT)
    torch.cuda.synchronize()
    assert lstm_stack.lstm_stack_bwd.launches == before + 1
    for k, g, w in zip(("dzx", "dh0", "dc0", "db"), got, want):
        assert g.dtype == w.dtype
        _close(g, w.float().cpu().numpy(), CUDA_TOL[name], k)
