"""The port's fused head+CE (fewshot_torch/ops/head_ce.py) against
fewshot/ops/head_ce.py.

* ``head_lse_tgt`` values (lse, target logit) and grads (dh2, dw, db of
  random cotangents) against the Pallas kernels in interpret mode, in both
  of their plans: the weight-resident plan and the forced vocab-tiled plan
  with 128-column tiles (several tiles merged online); ragged shapes that
  are not multiples of any tile, targets at column 0 and V-1;
* a plain model of the bf16 forward kernel's walk (row tiles, vocab
  chunks of 64-column tiles, the per-tile online merge of each thread's
  columns, the shuffles of a row's four threads, the chunk-order merge)
  against the plain twin and the Pallas kernels, empty chunks included;
* the routing predicate ``fused_head_nll_supported`` against JAX's;
* the wrappers' device handling and the head widths the kernels take;
* on a CUDA card (skipped elsewhere): both kernels against their plain
  twins, with the launch counters, at shapes that cut the tensor-core
  kernels' tiles raggedly (R and V off the 64-row tiles, D = 64, a D
  past one 256-wide slice, D = 896, and the D-chunked kernels at D = 1024
  and 2048); the bf16 forward at every vocab split 1-8, empty chunks
  included; both kernels give the same bits on two launches.

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

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fewshot_torch.ops import head_ce

REPO = Path(__file__).resolve().parent.parent
# D = 1024: past the width where a block keeps its [64, D] tiles resident
# (the D-chunked bf16 kernels, the sliced fp32 backward)
CASES = {"100x256x1537": (100, 256, 1537), "37x128x300": (37, 128, 300),
         "24x1024x260": (24, 1024, 260)}
# the on-card cases: CASES, D = 64, D = 384 (two output slices), D = 896
# (the widest resident bf16 backward: 32-row inner tiles, four slices),
# D = 2048 (eight slices of the D-chunked kernels)
CUDA_CASES = {**CASES, "70x64x333": (70, 64, 333),
              "130x384x1000": (130, 384, 1000), "33x896x257": (33, 896, 257),
              "40x2048x300": (40, 2048, 300)}
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
    """Each case's inputs from seed 20 + its place in `cases`."""
    z = {}
    for i, (case, (r, d, v)) in enumerate(cases.items()):
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


# ---------------------------------------------------------------------------
# a plain model of the bf16 forward kernel's walk (csrc/head_ce.cu
# head_ce_fwd_tc), which the CPU cannot run
# ---------------------------------------------------------------------------

_TILE = 64                      # rows of a row tile, columns of a vocab tile
_LANE = torch.arange(_TILE) % 8 // 2   # the thread of a quad owning a column


def _merge(m1, s1, m2, s2):
    """Two online softmax states (max, sum of exp; log2 units) merged as
    the kernel's merge_state: -inf maxima merge as nothing."""
    mn = torch.maximum(m1, m2)
    mu = torch.where(mn == -math.inf, 0.0, mn)
    return mn, s1 * torch.exp2(m1 - mu) + s2 * torch.exp2(m2 - mu)


def _fwd_walk(h2, w, b, targets, splits):
    """(lse, tl, the vocab chunks that held no tile) as the kernel computes
    them, in fp32: per 64-row tile and each of `splits` chunks of the
    64-column vocab tiles (chunk c: tiles [c nt / S, (c + 1) nt / S)), each
    thread of a row's quad folds the tile's columns it owns into a running
    (max, sum of exp2(x log2 e)) and keeps the target's logit; the quad
    merges by xor-shuffles (lanes 1 apart, then 2); the cluster's first
    block merges the chunks in chunk order."""
    r, d = h2.shape
    v = w.shape[1]
    hf, wf, bf = h2.float(), w.to(h2.dtype).float(), b.float()
    nt = -(-v // _TILE)
    cuts = [c * nt // splits for c in range(splits + 1)]
    lse, tl = torch.empty(r), torch.empty(r)
    inf = torch.full((_TILE,), -math.inf)
    for row0 in range(0, r, _TILE):
        n = min(_TILE, r - row0)
        x = torch.zeros(_TILE, d)
        x[:n] = hf[row0:row0 + n]
        tg = torch.full((_TILE,), -1, dtype=torch.long)
        tg[:n] = targets[row0:row0 + n].long()
        m_all, s_all, t_all = inf.clone(), torch.zeros(_TILE), torch.zeros(_TILE)
        for c in range(splits):
            m = inf[:, None].repeat(1, 4)
            s = torch.zeros(_TILE, 4)
            t = torch.zeros(_TILE, 4)
            for k in range(cuts[c], cuts[c + 1]):
                cols = torch.arange(k * _TILE, (k + 1) * _TILE)
                live = cols < v
                wk, bk = torch.zeros(d, _TILE), torch.zeros(_TILE)
                wk[:, live], bk[live] = wf[:, cols[live]], bf[cols[live]]
                logits = x @ wk + bk
                xs = torch.where(live, logits * math.log2(math.e), -math.inf)
                hit = cols[None] == tg[:, None]
                for q in range(4):
                    own = _LANE == q
                    mx = xs[:, own].max(dim=1).values
                    mn = torch.maximum(m[:, q], mx)
                    mu = torch.where(mn == -math.inf, 0.0, mn)
                    s[:, q] = s[:, q] * torch.exp2(m[:, q] - mu) + torch.exp2(
                        xs[:, own] - mu[:, None]).sum(dim=1)
                    m[:, q] = mn
                    t[:, q] += torch.where(hit, logits, 0.0)[:, own].sum(dim=1)
            m01, s01 = _merge(m[:, 0], s[:, 0], m[:, 1], s[:, 1])
            m23, s23 = _merge(m[:, 2], s[:, 2], m[:, 3], s[:, 3])
            mc, sc = _merge(m01, s01, m23, s23)
            m_all, s_all = _merge(m_all, s_all, mc, sc)
            t_all = t_all + ((t[:, 0] + t[:, 1]) + (t[:, 2] + t[:, 3]))
        lse[row0:row0 + n] = ((m_all + torch.log2(s_all)) * math.log(2))[:n]
        tl[row0:row0 + n] = t_all[:n]
    empty = [c for c in range(splits) if cuts[c] == cuts[c + 1]]
    return lse, tl, empty


# (R, D, V, splits): V off the 64-column tiles, one vocab tile (V < 64),
# chunks with no tile (splits > tiles: 100 columns are 2 tiles), R across
# two row tiles
WALK_CASES = {"70x64x100/s3": (70, 64, 100, 3), "70x64x100/s8": (70, 64, 100, 8),
              "37x128x50/s2": (37, 128, 50, 2),
              "100x256x1537/s1": (100, 256, 1537, 1),
              "100x256x1537/s5": (100, 256, 1537, 5)}


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_forward_walk_matches_twin(case, name):
    """The walk's merge algebra gives the twin's lse and target logit (fp32
    sums of the same rounded operands, 1e-5), targets at 0 and V - 1
    included, and empty chunks merge as nothing (no NaN)."""
    r, d, v, splits = WALK_CASES[case]
    z = _inputs({case: (r, d, v)})
    h2, w, b, t = _torch_case(z, case, DTYPES[name])
    lse, tl, empty = _fwd_walk(h2, w, b, t, splits)
    want = head_ce.head_lse_tgt_plain(h2, w, b, t)
    if splits > -(-v // _TILE):
        assert empty
    for got, wv in zip((lse, tl), want):
        assert torch.isfinite(got).all()
        _close(got, wv.numpy(), 1e-5, False)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_walk_matches_pallas(plan, case, name):
    """The walk (three chunks) against the Pallas kernels' lse and target
    logit, at the file's forward tolerance."""
    z, ref = plan
    h2, w, b, t = _torch_case(z, case, DTYPES[name])
    lse, tl, _ = _fwd_walk(h2, w, b, t, 3)
    _close(lse, ref[f"{case}_{name}_lse"], FWD_TOL, False, "lse")
    _close(tl, ref[f"{case}_{name}_tl"], FWD_TOL, False, "tl")


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
    """The kernels take every head width that is a multiple of 64 (the
    widths the JAX package's predicate admits included, up to D = 9216 in
    fp32 and 13952 in bf16): past the width where a block's [64, D] tiles
    fit in shared memory they stage D in chunks or cut their output into
    slices.  Other widths raise."""
    for d in (64, 640, 896, 1024, 2048, 9216, 13952):
        head_ce.check_head_dim(d)
    for d in (96, 1000):
        with pytest.raises(ValueError, match="multiple of 64"):
            head_ce.check_head_dim(d)


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
    tied-head layout (w a transposed view of a [V, D] table) included, and
    the D-chunked / sliced kernels at D = 1024 and 2048."""
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


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_forward_is_deterministic_on_cuda(cuda_device, name):
    """Two launches of the forward on the same inputs give the same bits:
    the bf16 kernel merges its vocab chunks in chunk order."""
    case = "300x256x5000"
    z = _inputs({case: (300, 256, 5000)})
    h2, w, b, t = (x.to(cuda_device) for x in _torch_case(z, case,
                                                         DTYPES[name]))
    w = w.T.contiguous().T
    first = head_ce.head_ce_fwd(h2, w, b, t)
    second = head_ce.head_ce_fwd(h2, w, b, t)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("case", ["70x64x100", "130x384x5000",
                                  "40x2048x300"])
def test_forward_splits_on_cuda(cuda_device, case, splits):
    """The bf16 forward at every vocab split against its twin: at 100
    columns (2 tiles) most splits hold empty chunks; the kernel's own
    split is one of 1-8."""
    r, d, v = map(int, case.split("x"))
    z = _inputs({case: (r, d, v)})
    h2, w, b, t = (x.to(cuda_device) for x in _torch_case(
        z, case, torch.bfloat16))
    got = head_ce.head_ce_fwd(h2, w, b, t, splits=splits)
    want = head_ce.head_lse_tgt_plain(h2, w, b, t)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        _close(g, wv.cpu().numpy(), FWD_TOL, False)
    assert 1 <= head_ce.fwd_splits(r, v, d) <= 8
