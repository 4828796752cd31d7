"""The port's fused head+CE (fewshot_torch/ops/head_ce.py) against
fewshot/ops/head_ce.py.

* ``head_lse_tgt`` values (lse, target logit) and grads (dh2, dw, db of
  random cotangents) against the Pallas kernels in interpret mode, in both
  of their plans: the weight-resident plan and the forced vocab-tiled plan
  with 128-column tiles (several tiles merged online); ragged shapes that
  are not multiples of any tile, targets at column 0 and V-1;
* the routing predicate ``fused_head_nll_supported`` against JAX's;
* the wrappers' device handling and the kernels' head-width limit;
* on a CUDA card (skipped elsewhere): both kernels against their plain
  twins, with the launch counters, at shapes that cut the tensor-core
  backward's tiles raggedly (R and V off the 64-row tiles, D = 64, a D
  past one 256-wide slice, the largest D the bf16 backward takes); the
  backward gives the same bits on two launches.

Inputs come from numpy seeds; the JAX side runs once per plan, in a
subprocess with FEWSHOT_PALLAS_INTERPRET=1 (the plan flags are read when
fewshot/ops/head_ce.py is imported).  Tolerances: fp32 1e-4 (the same
arithmetic in another summation order); bf16 operands are rounded the same
on both sides and summed in fp32, so the forward holds 1e-4 too, while the
backward rounds dlogits to bf16 before both products: a p that differs in
the last fp32 bit can move one dlogits entry by a bf16 step (2^-8
relative), so bf16 grads are held to 1e-2 of each output's largest
magnitude.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.ops import head_ce

REPO = Path(__file__).resolve().parent.parent
CASES = {"100x256x1537": (100, 256, 1537), "37x128x300": (37, 128, 300)}
# the on-card cases: CASES, D = 64, D = 384 (two output slices), D = 896
# (the bf16 backward's limit: 32-row inner tiles, four slices)
CUDA_CASES = {**CASES, "70x64x333": (70, 64, 333),
              "130x384x1000": (130, 384, 1000), "33x896x257": (33, 896, 257)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PLANS = {"resident": {},
         "tiled": {"FEWSHOT_HEAD_CE_FORCE_TILED": "1",
                   "FEWSHOT_HEAD_CE_VT": "128"}}
FWD_TOL = 1e-4                                   # absolute, lse and tl
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}   # relative to the largest

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot.ops import head_ce

d = sys.argv[1]
z = dict(np.load(d + "/inputs.npz"))
out = {}
for case in sys.argv[2].split(","):
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        h2 = jnp.asarray(z[case + "_h2"]).astype(dt)
        w = jnp.asarray(z[case + "_w"])
        b = jnp.asarray(z[case + "_b"])
        t = jnp.asarray(z[case + "_t"])
        (lse, tl), vjp = jax.vjp(
            lambda h, w_, b_: head_ce.head_lse_tgt(h, w_, b_, t), h2, w, b)
        dh2, dw, db = vjp((jnp.asarray(z[case + "_dlse"]),
                           jnp.asarray(z[case + "_dtl"])))
        for k, v in (("lse", lse), ("tl", tl), ("dh2", dh2), ("dw", dw),
                     ("db", db)):
            out[f"{case}_{name}_{k}"] = np.asarray(v.astype(jnp.float32))
np.savez(d + "/jax_out.npz", **out)
"""


def _inputs(cases=CASES) -> dict:
    z = {}
    for i, (case, (r, d, v)) in enumerate(sorted(cases.items())):
        rng = np.random.RandomState(20 + i)
        t = rng.randint(0, v, r)
        t[0], t[1] = 0, v - 1
        z.update({f"{case}_h2": rng.randn(r, d).astype(np.float32),
                  f"{case}_w": (rng.randn(d, v) / np.sqrt(d)).astype(
                      np.float32),
                  f"{case}_b": (0.5 * rng.randn(v)).astype(np.float32),
                  f"{case}_t": t.astype(np.int32),
                  f"{case}_dlse": rng.randn(r).astype(np.float32),
                  f"{case}_dtl": rng.randn(r).astype(np.float32)})
    return z


@pytest.fixture(scope="module", params=sorted(PLANS))
def plan(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"head_ce_{request.param}")
    z = _inputs()
    np.savez(d / "inputs.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu",
               **PLANS[request.param])
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d), ",".join(sorted(CASES))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, dict(np.load(d / "jax_out.npz"))


def _close(got, want, tol, relative, what=""):
    got = got.detach().float().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1e-30) if relative else 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _torch_case(z, case, dt, grad=False):
    h2 = torch.tensor(z[case + "_h2"]).to(dt)
    w = torch.tensor(z[case + "_w"])
    b = torch.tensor(z[case + "_b"])
    if grad:
        for x in (h2, w, b):
            x.requires_grad_(True)
    return h2, w, b, torch.tensor(z[case + "_t"]).long()


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_head_lse_tgt_matches_pallas(plan, case, name):
    """The plain twin and the autograd Function (its backward twin) against
    the Pallas kernels: lse, tl, dh2 (h2's dtype), dw and db (fp32)."""
    z, ref = plan
    h2, w, b, t = _torch_case(z, case, DTYPES[name], grad=True)
    lse, tl = head_ce.head_lse_tgt(h2, w, b, t)
    assert lse.dtype == tl.dtype == torch.float32
    _close(lse, ref[f"{case}_{name}_lse"], FWD_TOL, False, "lse")
    _close(tl, ref[f"{case}_{name}_tl"], FWD_TOL, False, "tl")
    torch.autograd.backward((lse, tl), (torch.tensor(z[case + "_dlse"]),
                                        torch.tensor(z[case + "_dtl"])))
    assert h2.grad.dtype == DTYPES[name] and w.grad.dtype == torch.float32
    for k, g in (("dh2", h2.grad), ("dw", w.grad), ("db", b.grad)):
        _close(g, ref[f"{case}_{name}_{k}"], GRAD_TOL[name], True, k)


def test_head_lse_tgt_without_grad_is_the_forward(plan):
    z, ref = plan
    case = sorted(CASES)[0]
    with torch.no_grad():
        lse, tl = head_ce.head_lse_tgt(*_torch_case(z, case, torch.float32))
    _close(lse, ref[f"{case}_float32_lse"], FWD_TOL, False)
    _close(tl, ref[f"{case}_float32_tl"], FWD_TOL, False)


@pytest.mark.parametrize("d", [64, 128, 192, 256, 512, 1024, 4096])
@pytest.mark.parametrize("v", [300, 1025, 5000, 20000, 100000])
def test_routing_predicate_matches_jax(d, v):
    import jax.numpy as jnp               # the card's machine has no JAX
    from fewshot.ops import head_ce as jhead_ce
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert head_ce.fused_head_nll_supported(d, v, dt) == \
            jhead_ce.fused_head_nll_supported(d, v, jdt), (d, v, dt)


def test_head_width_limits():
    """The backward's block holds its [64, D] tiles in shared memory: D up
    to 640 (fp32, beside an fp32 accumulator) / 896 (bf16, tensor-core
    tiles), a multiple of 64; the forward takes any multiple of 64.  Widths
    the JAX predicate admits at H=512 fit."""
    assert head_ce.max_head_dim(torch.float32) == 640
    assert head_ce.max_head_dim(torch.bfloat16) == 896
    head_ce.check_head_dim(512, torch.float32, train=True)
    head_ce.check_head_dim(896, torch.bfloat16, train=True)
    head_ce.check_head_dim(4096, torch.bfloat16, train=False)
    with pytest.raises(ValueError, match="multiple of 64"):
        head_ce.check_head_dim(96, torch.float32, train=False)
    with pytest.raises(ValueError, match="limit"):
        head_ce.check_head_dim(960, torch.bfloat16, train=True)


def test_wrappers_take_cpu_or_cuda_only():
    h2, w, b, t = (torch.zeros(4, 64, device="meta"),
                   torch.zeros(64, 10, device="meta"),
                   torch.zeros(10, device="meta"),
                   torch.zeros(4, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match="no head\\+CE kernel"):
        head_ce.head_ce_fwd(h2, w, b, t)
    with pytest.raises(ValueError, match="bad shapes"):
        head_ce.head_ce_fwd(torch.zeros(4, 64), torch.zeros(32, 10),
                            torch.zeros(10), torch.zeros(4, dtype=torch.long))


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernels_match_twins_on_cuda(cuda_device, case, name):
    """Both kernels against their twins on the card, launches counted; the
    tied-head layout (w a transposed view of a [V, D] table) included; a D
    past the dtype's backward limit raises there."""
    dt = DTYPES[name]
    z = _inputs(CUDA_CASES)
    h2, w, b, t = (x.to(cuda_device) for x in _torch_case(z, case, dt))
    w = w.T.contiguous().T                       # [D, V] view of [V, D]
    dlse = torch.tensor(z[case + "_dlse"]).to(cuda_device)
    dtl = torch.tensor(z[case + "_dtl"]).to(cuda_device)
    f0, b0 = head_ce.head_ce_fwd.launches, head_ce.head_ce_bwd.launches
    lse, tl = head_ce.head_ce_fwd(h2, w, b, t)
    want = head_ce.head_lse_tgt_plain(h2, w, b, t)
    torch.cuda.synchronize()
    assert head_ce.head_ce_fwd.launches == f0 + 1
    for g, wv in zip((lse, tl), want):
        _close(g, wv.cpu().numpy(), FWD_TOL, False)
    if CUDA_CASES[case][1] > head_ce.max_head_dim(dt):
        with pytest.raises(ValueError, match="limit"):
            head_ce.head_ce_bwd(h2, w, b, t, want[0], dlse, dtl)
        return
    got_b = head_ce.head_ce_bwd(h2, w, b, t, want[0], dlse, dtl)
    want_b = head_ce.head_lse_tgt_bwd_plain(h2, w, b, t, want[0], dlse, dtl)
    torch.cuda.synchronize()
    assert head_ce.head_ce_bwd.launches == b0 + 1
    for k, g, wv in zip(("dh2", "dw", "db"), got_b, want_b):
        assert g.shape == wv.shape and g.dtype == wv.dtype, k
        _close(g, wv.float().cpu().numpy(), GRAD_TOL[name], True, k)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_backward_is_deterministic_on_cuda(cuda_device, name):
    """Two launches of the backward on the same inputs give the same bits:
    the dW/db partials are summed in a fixed order, without atomics."""
    case = "300x256x5000"
    z = _inputs({case: (300, 256, 5000)})
    h2, w, b, t = (x.to(cuda_device) for x in _torch_case(z, case,
                                                         DTYPES[name]))
    w = w.T.contiguous().T
    dlse = torch.tensor(z[case + "_dlse"]).to(cuda_device)
    dtl = torch.tensor(z[case + "_dtl"]).to(cuda_device)
    lse, _ = head_ce.head_lse_tgt_plain(h2, w, b, t)
    first = head_ce.head_ce_bwd(h2, w, b, t, lse, dlse, dtl)
    second = head_ce.head_ce_bwd(h2, w, b, t, lse, dlse, dtl)
    for x, y in zip(first, second):
        assert torch.equal(x, y)
