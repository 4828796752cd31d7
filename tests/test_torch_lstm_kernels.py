"""The port's LSTM recurrence ops against the JAX Pallas kernels.

The plain twins of the two CUDA kernels (per-layer and fused stack) are held
against the JAX package's Pallas forward kernels run in interpret mode, in
fp32 and bf16, on ragged masks with a length-1 row and nonzero initial
state.  The JAX side runs in a subprocess because FEWSHOT_PALLAS_INTERPRET
is read when fewshot.ops.lstm_pallas is imported.  The kernel-vs-twin tests
need a CUDA card and skip without one.

Tolerances: fp32 1e-5 (the same function; only the summation order of the
h @ Wh products differs).  bf16 3e-2 on the bf16 ys/cs streams and 2e-2 on
the fp32 final state: both sides round the same values to bf16, but a
rounding that lands on the other side of a tie in one step moves later
steps by about one bf16 step (2^-8 near 1).
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.models.lstm import LSTMLayer, _layer_scan
from fewshot_torch.ops import lstm_layer, lstm_stack

REPO = Path(__file__).resolve().parent.parent
T, B, E, H = 13, 8, 32, 128
LENS = np.array([13, 1, 7, 13, 4, 10, 2, 9])
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (3e-2, 2e-2)}   # (ys/cs, hT/cT)
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.ops import lstm_fused, lstm_pallas

d = sys.argv[1]
z = dict(np.load(d + "/inputs.npz"))
out = {}
f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
for name in ("float32", "bfloat16"):
    dt = jnp.dtype(name)
    # per-layer kernel, called directly
    ys, cs, hT, cT = lstm_pallas._fwd_call(
        jnp.asarray(z["zx"]).astype(dt), jnp.asarray(z["wh"]).astype(dt),
        jnp.asarray(z["b"]), jnp.asarray(z["mask_t"]),
        jnp.asarray(z["h0"]), jnp.asarray(z["c0"]))
    for k, v in (("ys", ys), ("cs", cs), ("hT", hT), ("cT", cT)):
        out[f"layer_{name}_{k}"] = f32(v)
    # per-layer adapter (projection + cast to the stream dtype)
    layer = {"wx": jnp.asarray(z["wx0"]), "wh": jnp.asarray(z["wh"]),
             "b": jnp.asarray(z["b"])}
    ys, (h, c) = lstm_pallas.lstm_layer_pallas(
        layer, jnp.asarray(z["x"]), jnp.asarray(z["mask"]),
        (jnp.asarray(z["h0"]), jnp.asarray(z["c0"])), dt)
    out[f"adapter_{name}_ys"], out[f"adapter_{name}_h"] = f32(ys), f32(h)
    out[f"adapter_{name}_c"] = f32(c)
    # fused stack kernel, called directly
    ys, cs, hT, cT = lstm_fused._fwd_call(
        jnp.asarray(z["zx"]).astype(dt), jnp.asarray(z["wx_rest"]).astype(dt),
        jnp.asarray(z["wh2"]).astype(dt), jnp.asarray(z["b2"]),
        jnp.asarray(z["hole_mask_t"]), jnp.asarray(z["h02"]),
        jnp.asarray(z["c02"]))
    for k, v in (("ys", ys), ("cs", cs), ("hT", hT), ("cT", cT)):
        out[f"stack_{name}_{k}"] = f32(v)
    # fused stack adapter
    params = [{"wx": jnp.asarray(z["wx0"]), "wh": jnp.asarray(z["wh2"][0]),
               "b": jnp.asarray(z["b2"][0])},
              {"wx": jnp.asarray(z["wx_rest"][0]),
               "wh": jnp.asarray(z["wh2"][1]), "b": jnp.asarray(z["b2"][1])}]
    state = [(jnp.asarray(z["h02"][l]), jnp.asarray(z["c02"][l]))
             for l in range(2)]
    ys, st = lstm_fused.lstm_stack_fused(
        params, jnp.asarray(z["x"]), jnp.asarray(z["hole_mask"]), state, dt)
    out[f"fused_{name}_ys"] = f32(ys)
    out[f"fused_{name}_h"] = np.stack([f32(h) for h, _ in st])
    out[f"fused_{name}_c"] = np.stack([f32(c) for _, c in st])
np.savez(d + "/jax_out.npz", **out)
"""


def _inputs() -> dict:
    rng = np.random.RandomState(0)
    lim = np.sqrt(6.0 / (E + 5 * H))
    u = lambda *s: rng.uniform(-lim, lim, s).astype(np.float32)  # noqa
    n = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    mask = np.arange(T)[None, :] < LENS[:, None]                   # [B, T]
    # two songs per row with PAD between them, as support_mode=state packs
    half = (T + 1) // 2
    hole = np.zeros((B, T), bool)
    hole[:, :half] = np.arange(half)[None] < (LENS[:, None] + 1) // 2
    hole[:, half:] = np.arange(T - half)[None] < LENS[:, None] // 2
    hole[1] = False
    hole[1, 0] = True                                              # length 1
    z = {
        "zx": n(0.6, T, B, 4 * H), "wh": u(H, 4 * H), "b": n(0.1, 4 * H),
        "h0": n(0.5, B, H), "c0": n(0.5, B, H),
        "x": n(1.0, B, T, E), "wx0": u(E, 4 * H),
        "mask": mask, "mask_t": mask.T[..., None].astype(np.float32),
        "hole_mask": hole, "hole_mask_t": hole.T[..., None].astype(np.float32),
        "wx_rest": u(1, H, 4 * H), "wh2": u(2, H, 4 * H),
        "b2": n(0.1, 2, 4 * H),
        "h02": n(0.5, 2, B, H), "c02": n(0.5, 2, B, H),
    }
    return {k: np.ascontiguousarray(v) for k, v in z.items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("lstm_kernels")
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


def _close(got, want, atol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_layer_twin_matches_pallas(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    with torch.no_grad():
        ys, cs, hT, cT = lstm_layer.lstm_layer_fwd(
            _t(z["zx"], dt), _t(z["wh"], dt), _t(z["b"]), _t(z["mask_t"]),
            _t(z["h0"]), _t(z["c0"]))
    assert ys.dtype == dt and cs.dtype == dt
    assert hT.dtype == cT.dtype == torch.float32
    tol_s, tol_h = TOL[name]
    _close(ys, ref[f"layer_{name}_ys"], tol_s)
    _close(cs, ref[f"layer_{name}_cs"], tol_s)
    _close(hT, ref[f"layer_{name}_hT"], tol_h)
    _close(cT, ref[f"layer_{name}_cT"], tol_h)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_layer_adapter_matches_pallas(case, name):
    z, ref = case
    layer = LSTMLayer(_t(z["wx0"]), _t(z["wh"]), _t(z["b"]))
    with torch.no_grad():
        ys, (h, c) = lstm_layer.lstm_layer_pallas(
            layer, _t(z["x"]), torch.tensor(z["mask"]),
            (_t(z["h0"]), _t(z["c0"])), TORCH_DT[name])
    tol_s, tol_h = TOL[name]
    _close(ys, ref[f"adapter_{name}_ys"], tol_s)
    _close(h, ref[f"adapter_{name}_h"], tol_h)
    _close(c, ref[f"adapter_{name}_c"], tol_h)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_stack_twin_matches_pallas(case, name):
    z, ref = case
    dt = TORCH_DT[name]
    with torch.no_grad():
        ys, cs, hT, cT = lstm_stack.lstm_stack_fwd(
            _t(z["zx"], dt), _t(z["wx_rest"], dt), _t(z["wh2"], dt),
            _t(z["b2"]), _t(z["hole_mask_t"]), _t(z["h02"]), _t(z["c02"]))
    tol_s, tol_h = TOL[name]
    _close(ys, ref[f"stack_{name}_ys"], tol_s)
    _close(cs, ref[f"stack_{name}_cs"], tol_s)
    _close(hT, ref[f"stack_{name}_hT"], tol_h)
    _close(cT, ref[f"stack_{name}_cT"], tol_h)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_stack_adapter_matches_pallas(case, name):
    z, ref = case
    layers = [LSTMLayer(_t(z["wx0"]), _t(z["wh2"][0]), _t(z["b2"][0])),
              LSTMLayer(_t(z["wx_rest"][0]), _t(z["wh2"][1]),
                        _t(z["b2"][1]))]
    state = [(_t(z["h02"][l]), _t(z["c02"][l])) for l in range(2)]
    with torch.no_grad():
        ys, st = lstm_stack.lstm_stack_fused(
            layers, _t(z["x"]), torch.tensor(z["hole_mask"]), state,
            TORCH_DT[name])
    tol_s, tol_h = TOL[name]
    _close(ys, ref[f"fused_{name}_ys"], tol_s)
    _close(torch.stack([h for h, _ in st]), ref[f"fused_{name}_h"], tol_h)
    _close(torch.stack([c for _, c in st]), ref[f"fused_{name}_c"], tol_h)


@pytest.mark.parametrize("dt,hidden", [(torch.float32, 1920),
                                       (torch.bfloat16, 2432)])
def test_oversized_hidden_raises(dt, hidden):
    """No hidden size is refused any more: the per-layer and stack step
    kernels stage their contraction in chunks (H % 32 == 0 is all they
    need), so both wrappers run at widths past the former shared-memory
    limit (fp32 1920, bf16 2432), on the CPU as on the card, without a
    warning; and the fused stack's routing admits no width above 512, far
    below those, so the stack keeps no limit of its own."""
    for h in range(128, hidden + 1, 128):
        tl = [LSTMLayer(torch.zeros(h, 4), torch.zeros(h, 4), torch.zeros(4))
              for _ in range(2)]
        if lstm_stack.stack_fused_supported(tl, dt):
            assert h <= 512
    rows, steps, embed = 2, 3, 8
    layer = LSTMLayer(torch.zeros(embed, 4 * hidden),
                      torch.zeros(hidden, 4 * hidden, dtype=dt),
                      torch.zeros(4 * hidden))
    state = (torch.zeros(rows, hidden), torch.zeros(rows, hidden))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            ys, _ = lstm_layer.lstm_layer_pallas(
                layer, torch.zeros(rows, steps, embed), None, state, dt)
            assert ys.shape == (rows, steps, hidden)
            ys, cs, hT, cT = lstm_stack.lstm_stack_fwd(
                torch.zeros(steps, rows, 4 * hidden, dtype=dt),
                torch.zeros(1, hidden, 4 * hidden, dtype=dt),
                torch.zeros(2, hidden, 4 * hidden, dtype=dt),
                torch.zeros(2, 4 * hidden), torch.ones(steps, rows, 1),
                torch.zeros(2, rows, hidden), torch.zeros(2, rows, hidden))
            assert ys.shape == (2, steps, rows, hidden)
            assert bool(torch.isfinite(hT).all())


def test_layer_adapter_past_tpu_budget_runs_the_kernel_route(monkeypatch):
    """fp32 H=1024 (16 MiB of Wh, past the TPU kernel's VMEM budget) runs
    the kernel's route, not the plain scan, and matches the scan."""
    calls = []
    plain = lstm_layer.lstm_layer_fwd_plain
    monkeypatch.setattr(lstm_layer, "lstm_layer_fwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    rng = np.random.RandomState(3)
    hidden, rows, steps, embed = 1024, 2, 3, 8
    layer = LSTMLayer(_t(0.1 * rng.randn(embed, 4 * hidden)),
                      _t(0.03 * rng.randn(hidden, 4 * hidden)),
                      _t(0.1 * rng.randn(4 * hidden)))
    x = _t(rng.randn(rows, steps, embed))
    mask = torch.tensor([[True, True, True], [True, False, False]])
    state = (_t(0.5 * rng.randn(rows, hidden)),
             _t(0.5 * rng.randn(rows, hidden)))
    with warnings.catch_warnings(), torch.no_grad():
        warnings.simplefilter("error")
        ys, (h, c) = lstm_layer.lstm_layer_pallas(layer, x, mask, state,
                                                  torch.float32)
        ys_r, (h_r, c_r) = _layer_scan(layer, x, mask, state, torch.float32)
    assert calls == [1]
    _close(ys, ys_r.numpy(), 1e-5)
    _close(h, h_r.numpy(), 1e-5)
    _close(c, c_r.numpy(), 1e-5)


def test_stack_kernel_refuses_one_layer():
    """The fused kernel runs 2 or more layers; one layer goes per-layer."""
    hidden, rows, steps = 128, 2, 3
    with torch.no_grad(), pytest.raises(ValueError, match="2 or more"):
        lstm_stack.lstm_stack_fwd(
            torch.zeros(steps, rows, 4 * hidden),
            torch.zeros(0, hidden, 4 * hidden),
            torch.zeros(1, hidden, 4 * hidden), torch.zeros(1, 4 * hidden),
            torch.ones(steps, rows, 1), torch.zeros(1, rows, hidden),
            torch.zeros(1, rows, hidden))


@pytest.mark.parametrize("rows,layers", [(16, 2), (160, 2), (16, 1)])
def test_routing_matches_jax_predicate(rows, layers):
    """One config takes the same kernel family in both packages."""
    import jax.numpy as jnp
    from fewshot.ops.lstm_fused import stack_fused_supported as jax_pred
    hidden, embed = 512, 256
    jparams = [{"wx": np.zeros((embed if l == 0 else hidden, 4 * hidden)),
                "wh": np.zeros((hidden, 4 * hidden))} for l in range(layers)]
    tlayers = [LSTMLayer(torch.zeros(p["wx"].shape),
                         torch.zeros(p["wh"].shape), torch.zeros(4 * hidden))
               for p in jparams]
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        for eval_mode in (True, False):
            assert lstm_stack.stack_fused_supported(
                tlayers, tdt, batch_rows=rows, eval_mode=eval_mode) == \
                jax_pred(jparams, jdt, batch_rows=rows, eval_mode=eval_mode)
    if layers == 2:
        # the serving shapes: 16 rows fused, 160 rows per layer (bf16)
        assert lstm_stack.stack_fused_supported(
            tlayers, torch.bfloat16, batch_rows=rows,
            eval_mode=True) == (rows == 16)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# fp32: the kernel sums the H products of a gate in another order than the
# twin's matmul, and the difference compounds over the steps.
CUDA_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 40])
def test_layer_kernel_matches_twin_on_cuda(cuda_device, name, rows):
    rng = np.random.RandomState(1)
    dt = TORCH_DT[name]
    t_, h = 24, 256
    lim = np.sqrt(6.0 / (5 * h))
    zx = _t(0.6 * rng.randn(t_, rows, 4 * h), dt).to(cuda_device)
    wh = _t(rng.uniform(-lim, lim, (h, 4 * h)), dt).to(cuda_device)
    b = _t(0.1 * rng.randn(4 * h)).to(cuda_device)
    lens = rng.randint(1, t_ + 1, rows)
    mask = _t((np.arange(t_)[:, None] < lens[None])[..., None]).to(cuda_device)
    h0 = _t(0.5 * rng.randn(rows, h)).to(cuda_device)
    c0 = _t(0.5 * rng.randn(rows, h)).to(cuda_device)
    before = lstm_layer.lstm_layer_fwd.launches
    got = lstm_layer.lstm_layer_fwd(zx, wh, b, mask, h0, c0)
    want = lstm_layer.lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0)
    torch.cuda.synchronize()
    assert lstm_layer.lstm_layer_fwd.launches == before + 1
    tol_s, tol_h = CUDA_TOL[name]
    for g, w, tol in zip(got, want, (tol_s, tol_s, tol_h, tol_h)):
        assert g.dtype == w.dtype
        _close(g.cpu(), w.float().cpu().numpy(), tol)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 40])
def test_stack_kernel_matches_twin_on_cuda(cuda_device, name, rows):
    rng = np.random.RandomState(2)
    dt = TORCH_DT[name]
    t_, h, n_layers = 24, 256, 2
    lim = np.sqrt(6.0 / (5 * h))
    zx = _t(0.6 * rng.randn(t_, rows, 4 * h), dt).to(cuda_device)
    wx = _t(rng.uniform(-lim, lim, (1, h, 4 * h)), dt).to(cuda_device)
    wh = _t(rng.uniform(-lim, lim, (n_layers, h, 4 * h)), dt).to(cuda_device)
    b = _t(0.1 * rng.randn(n_layers, 4 * h)).to(cuda_device)
    lens = rng.randint(1, t_ + 1, rows)
    mask = _t((np.arange(t_)[:, None] < lens[None])[..., None]).to(cuda_device)
    h0 = _t(0.5 * rng.randn(n_layers, rows, h)).to(cuda_device)
    c0 = _t(0.5 * rng.randn(n_layers, rows, h)).to(cuda_device)
    before = lstm_stack.lstm_stack_fwd.launches
    got = lstm_stack.lstm_stack_fwd(zx, wx, wh, b, mask, h0, c0)
    want = lstm_stack.lstm_stack_fwd_plain(zx, wx, wh, b, mask, h0, c0)
    torch.cuda.synchronize()
    assert lstm_stack.lstm_stack_fwd.launches == before + 1
    tol_s, tol_h = CUDA_TOL[name]
    for g, w, tol in zip(got, want, (tol_s, tol_s, tol_h, tol_h)):
        assert g.dtype == w.dtype
        _close(g.cpu(), w.float().cpu().numpy(), tol)


def test_layer_kernel_at_wide_hidden_on_cuda(cuda_device):
    """fp32 H=1024 at 40 rows: the wide tile does not fit in shared memory,
    so the kernel runs its narrow tile; it still matches the twin."""
    rng = np.random.RandomState(4)
    t_, rows, h = 8, 40, 1024
    lim = np.sqrt(6.0 / (5 * h))
    zx = _t(0.6 * rng.randn(t_, rows, 4 * h)).to(cuda_device)
    wh = _t(rng.uniform(-lim, lim, (h, 4 * h))).to(cuda_device)
    b = _t(0.1 * rng.randn(4 * h)).to(cuda_device)
    lens = rng.randint(1, t_ + 1, rows)
    mask = _t((np.arange(t_)[:, None] < lens[None])[..., None]).to(cuda_device)
    h0 = _t(0.5 * rng.randn(rows, h)).to(cuda_device)
    c0 = _t(0.5 * rng.randn(rows, h)).to(cuda_device)
    got = lstm_layer.lstm_layer_fwd(zx, wh, b, mask, h0, c0)
    want = lstm_layer.lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g.cpu(), w.cpu().numpy(), CUDA_TOL["float32"][0])
