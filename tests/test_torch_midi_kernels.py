"""The kernels at the MIDI path's shapes.

On the CPU: the routes the MIDI recipe takes (kernels 1-2 on the
persistent route at 160 and 80 rows, H = 512, bf16; the MIDI heads, V = 204
and 504 at D = 256, score through dense logits, as fewshot's
``fused_head_eligible`` rules: V <= 1024), and the kernel route's twins
over a 400-step pass against fewshot's scan cell.

On the card (skips without one): kernels 1-2 (bf16, H = 512, the
persistent route) against their twins at 160 rows x 400 and 399 steps (the
MIDI leg's support and query passes) and 80 x 400 (serving at batch 16),
with ragged lengths and the same bits from a second launch; kernels 5-6 at
V = 204 and 504 (neither a multiple of the 64-column tile), both dtypes,
and the bf16 forward at every vocab split 1-8 (V = 204 has 4 tiles, so
splits past 4 hold empty chunks).

Tolerances are those of tests/test_torch_lstm_persist.py and
test_torch_head_ce.py: the forward 3e-2 absolute on the bf16 streams and
2e-2 on the final state, the backward 3e-2 of each output's largest; the
head forward 1e-4 absolute, its backward 1e-4 (fp32) / 1e-2 (bf16) of each
output's largest.
"""

import numpy as np
import pytest
import torch

from fewshot_torch.config import Config
from fewshot_torch.models import lm, lstm
from fewshot_torch.ops import head_ce, lstm_layer

H = 512
MIDI_V = (204, 504)


@pytest.mark.parametrize("rows", [160, 80])
def test_midi_routes(rows):
    assert lstm_layer.persistent_route(rows, H, torch.bfloat16)
    for v in MIDI_V:
        cfg = Config(vocab_size=v, embed_dim=256, hidden_dim=H,
                     cell="pallas", compute_dtype="bfloat16")
        params = lm.init_lm(cfg, v, torch.Generator().manual_seed(0), "cpu")
        assert not lm.fused_head_eligible(params, cfg, v)
        assert head_ce.fused_head_nll_supported(256, v)   # alone, it runs


def _layer_case(dev, steps, rows, seed=0, hidden=H):
    rng = np.random.RandomState(seed)
    lim = np.sqrt(6.0 / (5 * hidden))
    lens = rng.randint(1, steps + 1, rows)
    lens[0], lens[1] = 0, steps                   # empty and full rows
    mask = torch.tensor((np.arange(steps)[:, None] < lens[None])[..., None],
                        dtype=torch.float32, device=dev)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a, np.float32)).to(dev, dtype)
    fwd = (t(0.6 * rng.randn(steps, rows, 4 * hidden), bf),
           t(rng.uniform(-lim, lim, (hidden, 4 * hidden)), bf),
           t(0.1 * rng.randn(4 * hidden)), mask,
           t(0.5 * rng.randn(rows, hidden)), t(0.5 * rng.randn(rows, hidden)))
    bwd = (t(rng.randn(steps, rows, hidden), bf), t(rng.randn(rows, hidden)),
           t(rng.randn(rows, hidden)))
    return fwd, bwd


def test_layer_twin_at_t400_matches_jax():
    """The CPU's kernel route (the twins, cell='pallas') over a 400-step
    mean_state support pass against fewshot's scan cell, fp32, 2 layers at
    H = 128 with ragged lengths: the long chain adds no drift (1e-4)."""
    import jax                        # the card's machine has no JAX
    import jax.numpy as jnp
    from fewshot.models import lstm as jlstm
    from fewshot_torch.bridge import params_from_numpy
    rng = np.random.RandomState(1)
    hid, e, b, steps = 128, 32, 6, 400
    tree = {"embed": rng.randn(20, e).astype(np.float32),
            "out_b": np.zeros(20, np.float32), "lstm": []}
    for in_dim in (e, hid):
        lim = np.sqrt(6.0 / (in_dim + 5 * hid))
        tree["lstm"].append({k: rng.uniform(-lim, lim, s).astype(np.float32)
                             for k, s in (("wx", (in_dim, 4 * hid)),
                                          ("wh", (hid, 4 * hid)),
                                          ("b", (4 * hid,)))})
    x = (0.5 * rng.randn(b, steps, e)).astype(np.float32)
    lens = rng.randint(1, steps + 1, b)
    lens[0] = steps
    mask = np.arange(steps)[None] < lens[:, None]
    jys, jstate = jlstm.lstm_forward(
        jax.tree.map(jnp.asarray, tree["lstm"]), jnp.asarray(x),
        mask=jnp.asarray(mask), compute_dtype=jnp.float32, cell="scan")
    params = params_from_numpy(tree, "cpu")
    with torch.no_grad():
        ys, state = lstm.lstm_forward(params.lstm, torch.tensor(x),
                                      mask=torch.tensor(mask),
                                      compute_dtype=torch.float32,
                                      cell="pallas", eval_mode=True)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=0,
                               atol=1e-4)
    for (h, c), (jh, jc) in zip(state, jstate):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _err(got, want, relative=False):
    err = float((got.float() - want.float()).abs().max())
    return err / max(float(want.float().abs().max()), 1e-30) if relative \
        else err


@pytest.mark.parametrize("rows,steps", [(160, 400), (160, 399), (80, 400)])
def test_layer_kernels_at_midi_lengths_on_cuda(cuda_device, rows, steps):
    fwd_args, (dys, dh_t, dc_t) = _layer_case(cuda_device, steps, rows)
    counts = lstm_layer.lstm_layer_fwd.route_launches
    before = counts["persistent"]
    with torch.no_grad():
        got = lstm_layer.lstm_layer_fwd(*fwd_args, save_gates=True)
        want = lstm_layer.lstm_layer_fwd_plain(*fwd_args, save_gates=True)
        again = lstm_layer.lstm_layer_fwd(*fwd_args, save_gates=True)
    torch.cuda.synchronize()
    assert counts["persistent"] == before + 2
    for k, g, w, tol in zip(("ys", "cs", "hT", "cT", "gates"), got, want,
                            (3e-2, 3e-2, 2e-2, 2e-2, 3e-2)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert _err(g, w) <= tol, (k, _err(g, w))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bwd_args = (got[4], fwd_args[1], fwd_args[3], got[1], fwd_args[5], dys,
                dh_t, dc_t)
    before = lstm_layer.lstm_layer_bwd.route_launches["persistent"]
    got_b = lstm_layer.lstm_layer_bwd(*bwd_args)
    want_b = lstm_layer.lstm_layer_bwd_plain(*bwd_args)
    again_b = lstm_layer.lstm_layer_bwd(*bwd_args)
    torch.cuda.synchronize()
    assert lstm_layer.lstm_layer_bwd.route_launches["persistent"] == \
        before + 2
    for k, g, w in zip(("dzx", "dh0", "dc0", "db"), got_b, want_b):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert _err(g, w, True) <= 3e-2, (k, _err(g, w, True))
    assert all(torch.equal(x, y) for x, y in zip(got_b, again_b))


def _head_case(dev, rows, vocab, dtype, seed=0, d=256):
    g = torch.Generator().manual_seed(seed)
    h2 = torch.randn((rows, d), generator=g).to(dev, dtype)
    w = (torch.randn((vocab, d), generator=g) * d ** -0.5).to(dev).T
    b = (torch.randn(vocab, generator=g) * 0.5).to(dev)
    t = torch.randint(0, vocab, (rows,), generator=g)
    t[0], t[-1] = 0, vocab - 1
    dlse = torch.rand((rows,), generator=g).to(dev)
    dtl = -torch.rand((rows,), generator=g).to(dev)
    return h2, w, b, t.to(dev), dlse, dtl


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [70, 2501])
@pytest.mark.parametrize("vocab", MIDI_V)
def test_head_kernels_at_midi_vocabs_on_cuda(cuda_device, vocab, rows,
                                             dtype):
    h2, w, b, t, dlse, dtl = _head_case(cuda_device, rows, vocab, dtype)
    got = head_ce.head_ce_fwd(h2, w, b, t)
    want = head_ce.head_lse_tgt_plain(h2, w, b, t)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        assert _err(g, wv) <= 1e-4
    assert all(torch.equal(x, y) for x, y in zip(
        got, head_ce.head_ce_fwd(h2, w, b, t)))
    got_b = head_ce.head_ce_bwd(h2, w, b, t, want[0], dlse, dtl)
    want_b = head_ce.head_lse_tgt_bwd_plain(h2, w, b, t, want[0], dlse, dtl)
    torch.cuda.synchronize()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for k, g, wv in zip(("dh2", "dw", "db"), got_b, want_b):
        assert g.shape == wv.shape and g.dtype == wv.dtype, k
        assert _err(g, wv, True) <= tol, (k, _err(g, wv, True))
    assert all(torch.equal(x, y) for x, y in zip(
        got_b, head_ce.head_ce_bwd(h2, w, b, t, want[0], dlse, dtl)))


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("vocab", MIDI_V)
def test_head_forward_splits_at_midi_vocabs_on_cuda(cuda_device, vocab,
                                                    splits):
    h2, w, b, t, _, _ = _head_case(cuda_device, 300, vocab, torch.bfloat16,
                                   seed=splits)
    got = head_ce.head_ce_fwd(h2, w, b, t, splits=splits)
    want = head_ce.head_lse_tgt_plain(h2, w, b, t)
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        assert _err(g, wv) <= 1e-4
