"""The port's prefix attention (fewshot_torch/ops/prefix_attention.py) and
causal attention dispatch (fewshot_torch/ops/attention.py) against
fewshot/ops/prefix_attention.py and fewshot/ops/attention.py.

* ``prefix_attention`` (the plain twins behind the autograd Function):
  values and all five input grads against the Pallas kernels in interpret
  mode under each of their three plans: streaming
  (FEWSHOT_PREFIX_PLAN=stream), resident heads-outer
  (FEWSHOT_PREFIX_RES_LAYOUT=heads) and resident token-major
  (FEWSHOT_PREFIX_RES_LAYOUT=tokens, with FEWSHOT_PREFIX_RES_BLR=128 at
  Lq > 128: several row blocks); ragged masks, hd 32 and 128;
* ``causal_self_attention_flash`` the same way, with one row whose every
  key is masked: its value differs between the Pallas plans and the einsum
  path (each counts another set of masked keys) and nothing reads it, so it
  is held finite and its cotangent is 0;
* ``prefix_attention_reference`` and ``causal_attention`` (einsum path)
  against the JAX einsum paths; the ``cfg.flash`` route (the no-prefix
  twin) against the einsum path at the real query positions;
* the wrappers' device and shape checks; on a CUDA card (skipped
  elsewhere) the three kernels against their twins, launches counted, also
  at the training path's song length (T = 95: a second 64-row tile with
  31 live rows) against a 480-key prefix and without one, hd 32, 64 and
  128, and at the tile edges (T = 1 to 130, hd 16, Q = 1); a song whose
  every key is masked (finite forward and backward) and an episode whose
  prefix is; the bf16 backward bit-identical on a second launch.

Inputs come from numpy seeds; the JAX side runs once per plan in a
subprocess with FEWSHOT_PALLAS_INTERPRET=1 (the plan flags are read per
call), the three started together.  Tolerances: fp32 2e-5 absolute on the
output and 1e-4 relative to each grad's largest magnitude, as
tests/test_pallas.py holds JAX's own kernels.  bf16 (operands rounded
alike on both sides): the streaming plan rounds the unnormalised p
against the running row maximum, the twins (like the resident plans)
against the final one, 2^-9 of each p apart, so the output is held to
1e-2 absolute (values of order 1); each grad is rounded to bf16 at the
end (2^-8 of an entry) after products whose p or ds may flip by a bf16
step, so bf16 grads are held to 2e-2 of their largest.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.ops import attention, prefix_attention as pa

REPO = Path(__file__).resolve().parent.parent
# name: (B, Q, Lq, K, L, nh, hd); the prefix is K songs of L slots
CASES = {"h32": (2, 2, 20, 2, 12, 2, 32),
         "h128": (2, 2, 20, 2, 12, 2, 128),
         "long": (1, 2, 130, 2, 20, 1, 128)}
# the on-card cases: CASES, the training path's T = 95 against a 5 x
# 96-slot prefix at E = 256, and the tile edges of the kernels' 64-row and
# 64-key tiles and of their 32-wide passes (T = 1, 16, 64, 65, 130; a
# 95-key prefix; hd = 16; Q = 1)
CUDA_CASES = {**CASES, "t95_h32": (2, 5, 95, 5, 96, 8, 32),
              "t95_h64": (2, 5, 95, 5, 96, 4, 64),
              "t95_h128": (2, 5, 95, 5, 96, 2, 128),
              "tile_t1": (2, 5, 1, 5, 96, 2, 128),
              "tile_t16": (2, 5, 16, 5, 96, 2, 128),
              "tile_t64": (2, 5, 64, 5, 96, 2, 128),
              "tile_t65": (2, 5, 65, 5, 96, 2, 128),
              "tile_t130": (2, 2, 130, 2, 40, 2, 128),
              "tile_h16": (2, 5, 95, 5, 96, 16, 16),
              "tile_q1": (3, 1, 95, 5, 19, 2, 64)}
PLANS = {"stream": ({"FEWSHOT_PREFIX_PLAN": "stream"}, ("h32", "h128")),
         "heads": ({"FEWSHOT_PREFIX_PLAN": "resident",
                    "FEWSHOT_PREFIX_RES_LAYOUT": "heads"}, ("h32", "h128")),
         "tokens": ({"FEWSHOT_PREFIX_RES_LAYOUT": "tokens",
                     "FEWSHOT_PREFIX_RES_BLR": "128"}, ("h128", "long"))}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}    # absolute
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # relative to the largest
PREFIX_GRADS = ("dqq", "dqk", "dqv", "dpk", "dpv")
CAUSAL_GRADS = ("dq", "dk", "dv")

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.ops import attention, prefix_attention as pa

d = sys.argv[1]
z = dict(np.load(d + "/inputs.npz"))
out = {}


@jax.jit
def run(x, qm, pm, cm, g, cg):
    o, vjp = jax.vjp(lambda *a: pa.prefix_attention(*a, qm, pm),
                     *(x[k] for k in ("qq", "qk", "qv", "pk", "pv")))
    co, cvjp = jax.vjp(lambda *a: pa.causal_self_attention_flash(*a, cm),
                       *(x[k] for k in ("q", "k", "v")))
    return o, vjp(g), co, cvjp(cg)


for case in sys.argv[2].split(","):
    qm, pm, cm, g, cg = (jnp.asarray(z[f"{case}_{k}"])
                         for k in ("qmask", "pmask", "cmask", "g", "cg"))
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        x = {k: jnp.asarray(z[f"{case}_{k}"]).astype(dt)
             for k in ("qq", "qk", "qv", "pk", "pv", "q", "k", "v")}
        o, grads, co, cgrads = run(x, qm, pm, cm, g, cg)
        out[f"{case}_{name}_out"] = np.asarray(o, np.float32)
        out[f"{case}_{name}_cout"] = np.asarray(co, np.float32)
        for k, v in zip(("dqq", "dqk", "dqv", "dpk", "dpv", "cdq", "cdk",
                         "cdv"), grads + cgrads):
            out[f"{case}_{name}_{k}"] = np.asarray(v.astype(jnp.float32))
    x = {k: jnp.asarray(z[f"{case}_{k}"])
         for k in ("qq", "qk", "qv", "pk", "pv", "q", "k", "v")}
    out[f"{case}_ref"] = np.asarray(pa.prefix_attention_reference(
        x["qq"], x["qk"], x["qv"], x["pk"], x["pv"], qm, pm))
    out[f"{case}_einsum"] = np.asarray(attention.causal_attention(
        x["q"], x["k"], x["v"], cm, False))
np.savez(d + "/jax_out.npz", **out)
"""


def _inputs(cases=CASES) -> dict:
    z = {}
    for i, (case, (b, q_, lq, k_, l_, nh, hd)) in enumerate(
            sorted(cases.items())):
        rng = np.random.RandomState(40 + i)
        p = k_ * l_

        def f(*shape):
            return rng.randn(*shape).astype(np.float32)
        qlen = rng.randint(2, lq + 2, (b, q_))
        qlen[0, 0] = lq + 1                          # one full song
        slen = rng.randint(1, l_ + 1, (b, k_))
        cmask = np.arange(lq)[None] < rng.randint(min(2, lq), lq + 1,
                                                  (b * q_, 1))
        cmask[0, 0] = False                 # row 0 of song 0: no real key
        cg = f(b * q_, lq, nh, hd)
        cg[0, 0] = 0.0                       # nothing reads that row
        z.update({
            f"{case}_qq": f(b, q_, lq, nh, hd), f"{case}_qk": f(b, q_, lq,
                                                                nh, hd),
            f"{case}_qv": f(b, q_, lq, nh, hd), f"{case}_pk": f(b, p, nh, hd),
            f"{case}_pv": f(b, p, nh, hd),
            # the query stream's key mask is shift_targets' t < len - 1
            f"{case}_qmask": np.arange(lq)[None, None] < qlen[..., None] - 1,
            f"{case}_pmask": (np.arange(l_)[None, None]
                              < slen[..., None]).reshape(b, p),
            f"{case}_g": f(b, q_, lq, nh * hd),
            f"{case}_q": f(b * q_, lq, nh, hd), f"{case}_k": f(b * q_, lq,
                                                               nh, hd),
            f"{case}_v": f(b * q_, lq, nh, hd), f"{case}_cmask": cmask,
            f"{case}_cg": cg.reshape(b * q_, lq, nh * hd)})
    return z


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The Pallas side under each plan: one subprocess a plan, all three
    started together."""
    z = _inputs()
    procs = {}
    for label, (env_kw, cases) in PLANS.items():
        d = tmp_path_factory.mktemp(f"prefix_{label}")
        np.savez(d / "inputs.npz", **z)
        env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1",
                   JAX_PLATFORMS="cpu", **env_kw)
        procs[label] = (d, subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, str(d), ",".join(cases)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    refs = {}
    for label, (d, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        refs[label] = dict(np.load(d / "jax_out.npz"))
    return z, refs


@pytest.fixture(params=sorted(PLANS))
def plan(request, jax_refs):
    z, refs = jax_refs
    return request.param, z, refs[request.param]


def _close(got, want, tol, relative, what=""):
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if relative else 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _leaves(z, case, keys, dt):
    return [torch.tensor(z[f"{case}_{k}"]).to(dt).requires_grad_(True)
            for k in keys]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_prefix_attention_matches_pallas(plan, name):
    """Values and the grads of qq, qk, qv, pk, pv (in their dtype)."""
    label, z, ref = plan
    for case in PLANS[label][1]:
        leaves = _leaves(z, case, ("qq", "qk", "qv", "pk", "pv"),
                         DTYPES[name])
        out = pa.prefix_attention(*leaves, torch.tensor(z[f"{case}_qmask"]),
                                  torch.tensor(z[f"{case}_pmask"]))
        assert out.dtype == torch.float32
        _close(out, ref[f"{case}_{name}_out"], FWD_TOL[name], False,
               f"{case} out")
        out.backward(torch.tensor(z[f"{case}_g"]))
        for k, x in zip(PREFIX_GRADS, leaves):
            assert x.grad.dtype == DTYPES[name]
            _close(x.grad, ref[f"{case}_{name}_{k}"], GRAD_TOL[name], True,
                   f"{case} {k}")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_causal_self_attention_matches_pallas(plan, name):
    """The no-prefix case; the row with no real key only finite."""
    label, z, ref = plan
    for case in PLANS[label][1]:
        leaves = _leaves(z, case, ("q", "k", "v"), DTYPES[name])
        mask = torch.tensor(z[f"{case}_cmask"])
        out = pa.causal_self_attention_flash(*leaves, mask)
        assert bool(torch.isfinite(out).all())
        live = np.ones(out.shape[:2], bool)
        live[0, 0] = False
        _close(out[torch.tensor(live)], ref[f"{case}_{name}_cout"][live],
               FWD_TOL[name], False, f"{case} out")
        out.backward(torch.tensor(z[f"{case}_cg"]))
        for k, x in zip(CAUSAL_GRADS, leaves):
            assert bool(torch.isfinite(x.grad.float()).all())
            _close(x.grad, ref[f"{case}_{name}_c{k}"], GRAD_TOL[name], True,
                   f"{case} {k}")


def test_reference_paths_match_jax(plan):
    """The einsum paths (prefix_flash=False; cfg.flash off), fp32; the
    cfg.flash route (the no-prefix twin) against the einsum path at the
    real query positions, where both see the same keys."""
    label, z, ref = plan
    for case in PLANS[label][1]:
        t = {k: torch.tensor(z[f"{case}_{k}"])
             for k in ("qq", "qk", "qv", "pk", "pv", "q", "k", "v", "qmask",
                       "pmask", "cmask")}
        got = pa.episodic_attention(t["qq"], t["qk"], t["qv"], t["pk"],
                                    t["pv"], t["qmask"], t["pmask"], False)
        _close(got, ref[f"{case}_ref"], 2e-5, False, f"{case} reference")
        args = (t["q"], t["k"], t["v"], t["cmask"])
        _close(attention.causal_attention(*args, use_flash=False),
               ref[f"{case}_einsum"], 2e-5, False, f"{case} einsum")
        live = z[f"{case}_cmask"]
        flash = attention.causal_attention(*args, use_flash=True)
        _close(flash[torch.tensor(live)], ref[f"{case}_einsum"][live], 2e-5,
               False, f"{case} flash route")


def test_wrappers_check_devices_and_shapes():
    s_, t, e = 2, 5, 64
    q = torch.zeros(s_, t, e)
    mask = torch.ones(s_, t)
    # any head width runs (hd = 8: the CUDA wrapper pads it to 16)
    out, lse = pa.prefix_attn_fwd(q, q, q, mask, None, None, None, 8)
    assert out.shape == q.shape and lse.shape == (s_, 8, t)
    with pytest.raises(ValueError, match="bad shapes"):
        pa.prefix_attn_fwd(q, q, q, torch.ones(s_, t + 1), None, None, None,
                           2)
    with pytest.raises(ValueError, match="bad shapes"):   # S not B * Q
        pa.prefix_attn_fwd(q, q, q, mask, torch.zeros(3, 4, e),
                           torch.zeros(3, 4, e), torch.ones(3, 4), 2)
    lse = torch.zeros(s_, 2, t)
    with pytest.raises(ValueError, match="bad shapes"):   # g not bf16
        pa.prefix_attn_bwd_dq(q.bfloat16(), q.bfloat16(), q.bfloat16(), mask,
                              None, None, None, q, lse, lse, 2)
    meta = torch.zeros(s_, t, e, device="meta")
    with pytest.raises(ValueError, match="no prefix-attention kernel"):
        pa.prefix_attn_fwd(meta, meta, meta, torch.ones(s_, t,
                                                        device="meta"),
                           None, None, None, 2)
    assert not hasattr(pa, "check_head_dim")     # no width limit remains


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_args(z, case, dt, prefix, dev):
    """(q, k, v, kmask, pk, pv, pmask, nh) of a case on the card."""
    b, q_, lq, k_, l_, nh, hd = CUDA_CASES[case]
    s_, e = b * q_, nh * hd

    def put(k, shape):
        return torch.tensor(z[f"{case}_{k}"]).reshape(shape).to(dev, dt)
    q, k, v = (put(x, (s_, lq, e)) for x in ("qq", "qk", "qv"))
    kmask = torch.tensor(z[f"{case}_qmask"]).reshape(s_, lq).float().to(dev)
    pre = (put("pk", (b, k_ * l_, e)), put("pv", (b, k_ * l_, e)),
           torch.tensor(z[f"{case}_pmask"]).float().to(dev)) if prefix \
        else (None, None, None)
    if not prefix:
        kmask[:, 0] = 1.0                 # every row has a real key
    return (q, k, v, kmask, *pre, nh)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
@pytest.mark.parametrize("prefix", [True, False])
def test_kernels_match_twins_on_cuda(cuda_device, case, name, prefix):
    """The three kernels against their twins on the card, launches
    counted; ragged sequences that are not multiples of the 64-row tiles."""
    b, q_, lq, k_, l_, nh, hd = CUDA_CASES[case]
    dt = DTYPES[name]
    z = _inputs(CUDA_CASES)
    dev = cuda_device
    args = _cuda_args(z, case, dt, prefix, dev)
    s_, e = b * q_, nh * hd
    counts = [f.launches for f in (pa.prefix_attn_fwd, pa.prefix_attn_bwd_dq,
                                   pa.prefix_attn_bwd_dkv)]
    out, lse = pa.prefix_attn_fwd(*args)
    want_out, want_lse = pa.prefix_attn_fwd_plain(*args)
    g = torch.tensor(z[f"{case}_g"]).reshape(s_, lq, e).to(dev)
    delta = pa._delta(g, want_out, nh)
    bargs = args[:7] + (g.to(dt), want_lse, delta, nh)
    dq = pa.prefix_attn_bwd_dq(*bargs)
    dkv = pa.prefix_attn_bwd_dkv(*bargs)
    want_dq = pa.prefix_attn_bwd_dq_plain(*bargs)
    want_dkv = pa.prefix_attn_bwd_dkv_plain(*bargs)
    torch.cuda.synchronize()
    assert [f.launches for f in (pa.prefix_attn_fwd, pa.prefix_attn_bwd_dq,
                                 pa.prefix_attn_bwd_dkv)] == \
        [c + 1 for c in counts]
    _close(out.cpu(), want_out.cpu().numpy(), FWD_TOL[name], False, "out")
    _close(lse.cpu(), want_lse.cpu().numpy(), 1e-4, False, "lse")
    assert len(dkv) == len(want_dkv) == (4 if prefix else 2)
    pairs = list(zip((dq, *dkv), (want_dq, *want_dkv)))
    if lq == 1 and not prefix:
        # one key a row: the softmax passes no grad to its score, so dq and
        # dk are 0 up to rounding; held to that at the scale of dv (= g)
        scale = float(want_dkv[1].abs().max())
        for gt, _ in pairs[:2]:
            _close(gt.cpu() / scale, np.zeros(gt.shape, np.float32),
                   GRAD_TOL[name], False, "zero grad")
        pairs = pairs[2:]
    for gt, wt in pairs:
        _close(gt.cpu(), wt.cpu().numpy(), GRAD_TOL[name], True, "grad")


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("prefix", [True, False])
def test_forward_with_a_fully_masked_song_on_cuda(cuda_device, name,
                                                  prefix):
    """Song 0 has no real key (and, with a prefix, neither has its
    episode's prefix): its rows come out finite; the other songs, whose
    rows keep their real keys, match the twin."""
    case = "t95_h128"
    z = _inputs(CUDA_CASES)
    q, k, v, kmask, pk, pv, pmask, nh = _cuda_args(z, case, DTYPES[name],
                                                   prefix, cuda_device)
    kmask[0] = 0.0
    if prefix:
        pmask[0] = 0.0
    args = (q, k, v, kmask, pk, pv, pmask, nh)
    out, lse = pa.prefix_attn_fwd(*args)
    want_out, want_lse = pa.prefix_attn_fwd_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    _close(out[1:].cpu(), want_out[1:].cpu().numpy(), FWD_TOL[name], False,
           "out")
    _close(lse[1:].cpu(), want_lse[1:].cpu().numpy(), 1e-4, False, "lse")


def _backward(args, z, case):
    """((dq, *dkv) of the kernels, the same of the twins) at the twins'
    lse and delta, cotangent from the case's inputs."""
    q, nh = args[0], args[-1]
    s_, lq, e = q.shape
    out, lse = pa.prefix_attn_fwd_plain(*args)
    g = torch.tensor(z[f"{case}_g"]).reshape(s_, lq, e).to(q.device)
    bargs = args[:7] + (g.to(q.dtype), lse, pa._delta(g, out, nh), nh)
    got = (pa.prefix_attn_bwd_dq(*bargs), *pa.prefix_attn_bwd_dkv(*bargs))
    want = (pa.prefix_attn_bwd_dq_plain(*bargs),
            *pa.prefix_attn_bwd_dkv_plain(*bargs))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("masked", ["episode_prefix", "song",
                                    "song_no_prefix"])
def test_backward_with_masked_keys_on_cuda(cuda_device, name, masked):
    """Episode 0's prefix masked (its songs see only their own keys), or
    song 0's own keys masked (with a prefix its rows still see real keys;
    without one they see none: each side gives such a row a finite value
    of its own, so song 0 is only held finite there)."""
    case = "t95_h128"
    z = _inputs(CUDA_CASES)
    args = _cuda_args(z, case, DTYPES[name], masked != "song_no_prefix",
                      cuda_device)
    if masked == "episode_prefix":
        args[6][0] = 0.0
    else:
        args[3][0] = 0.0
    got, want = _backward(args, z, case)
    keep = slice(1, None) if masked == "song_no_prefix" else slice(None)
    for gt, wt in zip(got, want):
        assert bool(torch.isfinite(gt).all())
        _close(gt[keep].cpu(), wt[keep].cpu().numpy(), GRAD_TOL[name], True,
               f"{masked} grad")


@pytest.mark.parametrize("prefix", [True, False])
def test_bf16_backward_is_deterministic_on_cuda(cuda_device, prefix):
    """Each block owns its outputs and sums in a fixed order: a second
    launch of dq and dk/dv gives the same bits."""
    case = "t95_h128"
    z = _inputs(CUDA_CASES)
    args = _cuda_args(z, case, torch.bfloat16, prefix, cuda_device)
    first, _ = _backward(args, z, case)
    second, _ = _backward(args, z, case)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
