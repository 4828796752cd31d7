"""The port at the widths its kernels once refused, against the JAX package.

* The LSTM loss and every grad of one episodic batch (``cell="pallas"``,
  fp32, one layer per pass, support_mode=state) at H = 768, where the JAX
  package runs its Pallas kernels (in interpret mode here: Wh is 9 MiB,
  inside the TPU kernel's 11 MiB budget), and at H = 1024, where it warns
  and runs ``lax.scan``.  The port runs the kernels' plain twins on the CPU
  at both (its step kernels take every H % 32 == 0).
* ``prefix_attention`` (values and all five input grads) at head widths
  hd = 24 (not a multiple of 16: the CUDA wrapper pads it) and hd = 256
  (past the tensor-core kernels' 128: the column-window kernels), fp32 and
  bf16, against the Pallas kernels in interpret mode.
* ``pad_heads`` / ``unpad_heads``, the CUDA wrapper's padding, on the CPU.
* On a CUDA card (skipped elsewhere): the LSTM step kernels at fp32 H = 768
  and 2048 and bf16 H = 1536 and 2560, forward (train mode) and backward,
  and the three attention kernels at hd = 24, 192 and 256 in both dtypes,
  against their twins with the tolerances of the narrower cases
  (tests/test_torch_lstm_bwd.py, tests/test_torch_prefix_attention.py),
  each bit-identical on a second launch.

Inputs come from numpy seeds; the JAX side runs once for the file, in a
subprocess with FEWSHOT_PALLAS_INTERPRET=1.  Tolerances: the LSTM loss and
grads 1e-5 of each array's largest magnitude (fp32; only the order of
sums differs), as tests/test_torch_training.py; the attention fp32 2e-5
absolute on the output and 1e-4 of each grad's largest, bf16 1e-2 and
2e-2, as tests/test_torch_prefix_attention.py (whose docstring gives the
reasons).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch import bridge
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.models import lm
from fewshot_torch.ops import lstm_layer, prefix_attention as pa

REPO = Path(__file__).resolve().parent.parent
E, V, L, K, Q, B = 16, 30, 6, 2, 1, 3
HIDDEN = (768, 1024)
LSTM_REL = 1e-5
# name: (B, Q, Lq, K, L, nh, hd); the prefix is K songs of L slots
ATTN = {"h24": (2, 2, 20, 2, 12, 2, 24), "h256": (1, 2, 20, 2, 12, 2, 256)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}    # absolute
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # relative to the largest

_JAX_SCRIPT = r"""
import sys
import warnings
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.config import Config
from fewshot.data.episodes import Episode
from fewshot.models import lm
from fewshot.ops import prefix_attention as pa
from fewshot_torch.bridge import flatten, unflatten

d = sys.argv[1]
z = dict(np.load(d + "/inputs.npz"))
out = {}
ep = Episode(*(jnp.asarray(z[f"ep_{f}"]) for f in
               ("support", "support_len", "query", "query_len", "artist")))
for h in (768, 1024):
    cfg = Config(vocab_size=30, max_len=6, embed_dim=16, hidden_dim=h,
                 num_layers=1, cell="pallas", compute_dtype="float32",
                 batch_size=3, support_size=2, query_size=1,
                 support_mode="state", data_parallel=False)
    params = jax.tree.map(jnp.asarray, unflatten(
        {k[len(f"p{h}:"):]: v for k, v in z.items()
         if k.startswith(f"p{h}:")}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (total, count), grads = jax.value_and_grad(
            lambda p: lm.episodic_nll_stats(p, ep, cfg), has_aux=True)(params)
        total = np.asarray(total)
    out[f"lstm{h}_scan_warning"] = np.asarray(
        any("scan" in str(w.message) for w in caught))
    out[f"lstm{h}_total"] = total
    out[f"lstm{h}_count"] = np.asarray(count)
    for k, v in flatten(grads).items():
        out[f"lstm{h}_grad:{k}"] = np.asarray(v)


@jax.jit
def run(x, qm, pm, g):
    o, vjp = jax.vjp(lambda *a: pa.prefix_attention(*a, qm, pm),
                     *(x[k] for k in ("qq", "qk", "qv", "pk", "pv")))
    return o, vjp(g)


for case in ("h24", "h256"):
    qm, pm, g = (jnp.asarray(z[f"{case}_{k}"]) for k in ("qmask", "pmask",
                                                          "g"))
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        x = {k: jnp.asarray(z[f"{case}_{k}"]).astype(dt)
             for k in ("qq", "qk", "qv", "pk", "pv")}
        o, grads = run(x, qm, pm, g)
        out[f"{case}_{name}_out"] = np.asarray(o, np.float32)
        for k, v in zip(("dqq", "dqk", "dqv", "dpk", "dpv"), grads):
            out[f"{case}_{name}_{k}"] = np.asarray(v.astype(jnp.float32))
np.savez(d + "/jax_out.npz", **out)
"""


def _lstm_params(seed, h):
    rng = np.random.RandomState(seed)
    lim = np.sqrt(6.0 / (E + 5 * h))
    return {"embed": (0.3 * rng.randn(V, E)).astype(np.float32),
            "out_b": (0.1 * rng.randn(V)).astype(np.float32),
            "out_proj": (0.05 * rng.randn(h, E)).astype(np.float32),
            "lstm": [{"wx": rng.uniform(-lim, lim, (E, 4 * h)).astype(
                          np.float32),
                      "wh": rng.uniform(-lim, lim, (h, 4 * h)).astype(
                          np.float32),
                      "b": (0.1 * rng.randn(4 * h)).astype(np.float32)}]}


def _attn_inputs(z):
    for i, (case, (b, q_, lq, k_, l_, nh, hd)) in enumerate(ATTN.items()):
        rng = np.random.RandomState(60 + i)
        p = k_ * l_

        def f(*shape):
            return rng.randn(*shape).astype(np.float32)
        qlen = rng.randint(2, lq + 2, (b, q_))
        qlen[0, 0] = lq + 1
        slen = rng.randint(1, l_ + 1, (b, k_))
        z.update({
            f"{case}_qq": f(b, q_, lq, nh, hd), f"{case}_qk": f(b, q_, lq,
                                                                nh, hd),
            f"{case}_qv": f(b, q_, lq, nh, hd), f"{case}_pk": f(b, p, nh, hd),
            f"{case}_pv": f(b, p, nh, hd),
            f"{case}_qmask": np.arange(lq)[None, None] < qlen[..., None] - 1,
            f"{case}_pmask": (np.arange(l_)[None, None]
                              < slen[..., None]).reshape(b, p),
            f"{case}_g": f(b, q_, lq, nh * hd)})


def _inputs() -> dict:
    rng = np.random.RandomState(5)
    z = {}
    for h in HIDDEN:
        for k, v in bridge.flatten(_lstm_params(h, h)).items():
            z[f"p{h}:{k}"] = v
    lens = rng.randint(2, L + 1, (B, K + Q))
    toks = rng.randint(3, V, (B, K + Q, L)) * (np.arange(L) < lens[..., None])
    z.update({"ep_support": toks[:, :K].astype(np.int32),
              "ep_support_len": lens[:, :K].astype(np.int32),
              "ep_query": toks[:, K:].astype(np.int32),
              "ep_query_len": lens[:, K:].astype(np.int32),
              "ep_artist": np.arange(B, dtype=np.int32)})
    _attn_inputs(z)
    return z


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    d = tmp_path_factory.mktemp("widths")
    z = _inputs()
    np.savez(d / "inputs.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, dict(np.load(d / "jax_out.npz"))


def _close(got, want, tol, relative, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if relative else 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("hidden", HIDDEN)
def test_lstm_train_loss_and_grads_match_jax(refs, hidden):
    """H = 768: JAX runs its Pallas kernels; H = 1024: JAX warns and runs
    the scan.  Both match the port, which has no width limit."""
    z, ref = refs
    assert bool(ref[f"lstm{hidden}_scan_warning"]) == (hidden == 1024)
    cfg = Config(vocab_size=V, max_len=L, embed_dim=E, hidden_dim=hidden,
                 num_layers=1, cell="pallas", compute_dtype="float32",
                 batch_size=B, support_size=K, query_size=Q,
                 support_mode="state", data_parallel=False)
    params = bridge.params_from_numpy(bridge.unflatten(
        {k[len(f"p{hidden}:"):]: v for k, v in z.items()
         if k.startswith(f"p{hidden}:")}), "cpu")
    ep = eps.Episode(*(torch.tensor(z[f"ep_{f}"], dtype=torch.int64)
                       for f in ("support", "support_len", "query",
                                 "query_len", "artist")))
    total, count = lm.episodic_nll_stats(params, ep, cfg)
    total.backward()
    _close(total, ref[f"lstm{hidden}_total"], LSTM_REL, True, "total")
    assert float(count) == float(ref[f"lstm{hidden}_count"])
    grads = bridge.flatten(bridge.unflatten(
        {k: p.grad.numpy() for k, p in params.named_parameters()}))
    want = {k[len(f"lstm{hidden}_grad:"):]: v for k, v in ref.items()
            if k.startswith(f"lstm{hidden}_grad:")}
    assert set(grads) == set(want)
    for k, g in grads.items():
        _close(torch.tensor(g), want[k], LSTM_REL, True, k)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(ATTN))
def test_prefix_attention_at_wide_and_odd_heads_matches_pallas(refs, case,
                                                                name):
    z, ref = refs
    dt = DTYPES[name]
    leaves = [torch.tensor(z[f"{case}_{k}"]).to(dt).requires_grad_(True)
              for k in ("qq", "qk", "qv", "pk", "pv")]
    out = pa.prefix_attention(*leaves, torch.tensor(z[f"{case}_qmask"]),
                              torch.tensor(z[f"{case}_pmask"]))
    _close(out, ref[f"{case}_{name}_out"], FWD_TOL[name], False, "out")
    out.backward(torch.tensor(z[f"{case}_g"]))
    for x, k in zip(leaves, ("dqq", "dqk", "dqv", "dpk", "dpv")):
        _close(x.grad, ref[f"{case}_{name}_{k}"], GRAD_TOL[name], True, k)


def test_pad_heads_round_trip():
    """Each head's columns, then zeros; unpad_heads inverts it; a width
    already a multiple of 16 is passed through."""
    x = torch.randn(2, 5, 3 * 24)
    xp = pa.pad_heads(x, 3, 32)
    heads = xp.view(2, 5, 3, 32)
    assert torch.equal(heads[..., :24], x.view(2, 5, 3, 24))
    assert not heads[..., 24:].any()
    assert torch.equal(pa.unpad_heads(xp, 3, 24), x)
    y = torch.randn(2, 5, 64)
    assert pa.pad_heads(y, 2, 32) is y and pa.unpad_heads(y, 2, 32) is y


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dt,hidden", [(torch.float32, 768),
                                       (torch.float32, 2048),
                                       (torch.bfloat16, 1536),
                                       (torch.bfloat16, 2560)])
@pytest.mark.parametrize("rows", [16, 40])
def test_lstm_step_kernels_at_wide_hidden_on_cuda(cuda_device, dt, hidden,
                                                  rows):
    """The step kernels' chunked contraction at widths past the former
    limits, both tile shapes (16 rows: narrow tiles), against the twins;
    the same bits on a second launch."""
    dev = cuda_device
    gen = torch.Generator().manual_seed(hidden + rows)
    steps = 5

    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen)).to(dev)
    zx = rnd(steps, rows, 4 * hidden).to(dt)
    wh = rnd(hidden, 4 * hidden, s=hidden ** -0.5).to(dt)
    b, h0, c0 = rnd(4 * hidden, s=0.1), rnd(rows, hidden), rnd(rows, hidden)
    mask = (torch.rand(steps, rows, 1, generator=gen) < 0.8).float().to(dev)
    args = (zx, wh, b, mask, h0, c0)
    got = lstm_layer.lstm_layer_fwd(*args, save_gates=True, route="step")
    again = lstm_layer.lstm_layer_fwd(*args, save_gates=True, route="step")
    want = lstm_layer.lstm_layer_fwd_plain(*args, save_gates=True)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y)
        assert float((x.float() - z.float()).abs().max()) <= LSTM_TOL[dt]
    ys, cs, _, _, gates = want
    dys, dhT, dcT = rnd(steps, rows, hidden).to(dt), rnd(rows, hidden), \
        rnd(rows, hidden)
    bargs = (gates, wh, mask, cs, c0, dys, dhT, dcT)
    got = lstm_layer.lstm_layer_bwd(*bargs, route="step")
    again = lstm_layer.lstm_layer_bwd(*bargs, route="step")
    want = lstm_layer.lstm_layer_bwd_plain(*bargs)
    torch.cuda.synchronize()
    for x, y, z in zip(got, again, want):
        assert torch.equal(x, y)
        scale = max(float(z.float().abs().max()), 1.0)
        assert float((x.float() - z.float()).abs().max()) <= \
            LSTM_TOL[dt] * scale


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("hd", [24, 192, 256])
@pytest.mark.parametrize("prefix", [True, False])
def test_attention_kernels_at_any_head_width_on_cuda(cuda_device, name, hd,
                                                     prefix):
    """Forward, dq and dk/dv at a padded head (24) and at column-window
    heads (192, 256) against the twins; dq and dk/dv bit-identical on a
    second launch."""
    dev, dt = cuda_device, DTYPES[name]
    b, q_, lq, k_, l_, nh = 2, 3, 95, 2, 40, 2
    s_, e, p = b * q_, nh * hd, k_ * l_
    gen = torch.Generator().manual_seed(hd)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)
    q, k, v = (rnd(s_, lq, e).to(dt) for _ in range(3))
    kmask = (torch.rand(s_, lq, generator=gen) < 0.9).float().to(dev)
    kmask[:, 0] = 1.0
    pre = ((rnd(b, p, e).to(dt), rnd(b, p, e).to(dt),
            (torch.rand(b, p, generator=gen) < 0.8).float().to(dev))
           if prefix else (None, None, None))
    args = (q, k, v, kmask, *pre, nh)
    out, lse = pa.prefix_attn_fwd(*args)
    want_out, want_lse = pa.prefix_attn_fwd_plain(*args)
    g = rnd(s_, lq, e)
    delta = pa._delta(g, want_out, nh)
    bargs = args[:7] + (g.to(dt), want_lse, delta, nh)
    got = (pa.prefix_attn_bwd_dq(*bargs), *pa.prefix_attn_bwd_dkv(*bargs))
    again = (pa.prefix_attn_bwd_dq(*bargs), *pa.prefix_attn_bwd_dkv(*bargs))
    want = (pa.prefix_attn_bwd_dq_plain(*bargs),
            *pa.prefix_attn_bwd_dkv_plain(*bargs))
    torch.cuda.synchronize()
    _close(out.cpu(), want_out.cpu().numpy(), FWD_TOL[name], False, "out")
    _close(lse.cpu(), want_lse.cpu().numpy(), 1e-4, False, "lse")
    assert len(got) == len(want) == (5 if prefix else 3)
    for x, y, w in zip(got, again, want):
        assert torch.equal(x, y)
        _close(x.cpu(), w.cpu().numpy(), GRAD_TOL[name], True, "grad")
