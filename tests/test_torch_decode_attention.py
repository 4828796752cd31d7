"""The decode-attention kernel (fewshot_torch/ops/decode_attention.py,
csrc/decode_attn.cu) that ``transformer_step`` runs once a layer a decode
step, and its plain twin.

On the CPU:
* the twin is the einsum path that ``transformer_step`` ran before the
  kernel (``_attend`` fed a bias of 0 / -1e30 built from ``valid`` and the
  decode position), bit for bit: ragged prefix masks, stale valid slots past
  idx, idx at the first and at the last decode position, fp32 and bf16;
* the wrapper runs the twin on CPU tensors and counts no launch; it raises
  on bad shapes and on a device with no kernel (no fallback);
* greedy decoding through ``transformer_step`` after a prefill gives the
  JAX package's tokens (``fewshot.models.transformer``, the einsum paths),
  its hidden states within 2e-5 of their largest entry (fp32; the same
  arithmetic in another summation order).

On a CUDA card (skipped elsewhere; ``-k on_cuda``): the kernel against the
twin at the sampling benchmark's shape (B 2048, T 609 = a 480-slot prefix
of 5 songs + 128 decode positions + 1, nh 2, hd 128, bf16), at hd 24 and
128 in fp32 and hd 24 in bf16, and through the narrower chunk plans (hd 20
and 36 bf16, hd 6 and 192 fp32), with one row whose prefix is all pad but
one slot a song; the same bits on a second launch; a row with no admitted
key; ``launches`` growing by ``num_layers`` a decode step; refused shapes
raising.  Tolerances, absolute on outputs of order 1 (values up to about 5):
fp32 1e-4, the same arithmetic in another summation order (and expf's last
bits); bf16 2e-2: p is rounded to bf16 on both sides, and where the order
of the fp32 sums moves a score by its last bit, p's rounding can move by
one bf16 unit (at most 2^-8 of p), times |v| up to about 5.
"""

import math

import numpy as np
import pytest
import torch

from fewshot_torch.config import Config
from fewshot_torch.models import transformer as tfm
from fewshot_torch.ops import decode_attention as da
from fewshot_torch.ops.prefix_attention import NEG

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _einsum_before(q, k, v, valid, idx):
    """The decode step's attention as transformer_step computed it before
    the kernel: the bias from valid and idx, then _attend's einsums."""
    key_ok = valid & (torch.arange(valid.shape[1]) <= idx)
    bias = torch.where(key_ok, 0.0, NEG)[:, None, None, :]
    b, tq, nh, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(b, tq, nh * hd)


def _inputs(seed, b, songs, slots, extra, nh, hd, dtype, idx_at,
            device="cpu", stale=True):
    """(q, k, v, valid, idx): a prefix of `songs` songs of `slots` slots,
    each song's real length drawn (row 0: one real slot a song), then
    `extra` decode positions; positions up to idx valid (as the decode loop
    leaves them) and, with `stale`, some past idx valid too (the kernel must
    mask them by position).  idx_at: "first" (the prefix's end) or "last"
    (T - 1)."""
    gen = torch.Generator().manual_seed(seed)
    p = songs * slots
    t = p + extra
    lens = torch.randint(1, slots + 1, (b, songs), generator=gen)
    lens[0] = 1
    pmask = (torch.arange(slots) < lens[..., None]).reshape(b, p)
    idx = p if idx_at == "first" else t - 1
    valid = torch.zeros((b, t), dtype=torch.bool)
    valid[:, :p] = pmask
    valid[:, p:idx + 1] = True
    if stale and idx < t - 1:
        valid[:, idx + 1:] = torch.rand((b, t - idx - 1), generator=gen) < 0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    q, k, v = rnd(b, 1, nh, hd), rnd(b, t, nh, hd), rnd(b, t, nh, hd)
    return (q.to(device), k.to(device), v.to(device), valid.to(device), idx)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("idx_at", ["first", "last"])
@pytest.mark.parametrize("hd", [8, 24])
def test_twin_is_the_einsum_path_bit_for_bit(name, idx_at, hd):
    q, k, v, valid, idx = _inputs(0, 5, 3, 6, 7, 2, hd, DTYPES[name],
                                  idx_at)
    got = da.decode_attn_plain(q, k, v, valid, idx)
    assert got.dtype == torch.float32 and got.shape == (5, 1, 2 * hd)
    assert torch.equal(got, _einsum_before(q, k, v, valid, idx))


def test_wrapper_runs_the_twin_on_the_cpu_and_counts_no_launch():
    q, k, v, valid, idx = _inputs(1, 3, 2, 5, 4, 2, 16, torch.bfloat16,
                                  "first")
    before = da.decode_attn.launches
    got = da.decode_attn(q, k, v, valid, idx)
    assert torch.equal(got, da.decode_attn_plain(q, k, v, valid, idx))
    assert da.decode_attn.launches == before


@pytest.mark.parametrize("bad", ["q_rows", "q_len", "dtype", "half",
                                 "valid_dtype", "valid_shape", "idx_high",
                                 "idx_low"])
def test_bad_inputs_raise(bad):
    q, k, v, valid, idx = _inputs(2, 3, 2, 5, 4, 2, 16, torch.float32,
                                  "first")
    if bad == "q_rows":
        q = q[:2]
    elif bad == "q_len":
        q = torch.cat([q, q], dim=1)
    elif bad == "dtype":
        q = q.to(torch.bfloat16)
    elif bad == "half":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "valid_dtype":
        valid = valid.float()
    elif bad == "valid_shape":
        valid = valid[:, :-1]
    elif bad == "idx_high":
        idx = k.shape[1]
    else:
        idx = -1
    with pytest.raises(ValueError):
        da.decode_attn(q, k, v, valid, idx)


def test_no_kernel_for_other_devices():
    """A device that is neither the CPU nor CUDA raises: there is no
    fallback to the twin."""
    q, k, v, valid, idx = (x.to("meta") if torch.is_tensor(x) else x
                           for x in _inputs(3, 2, 2, 4, 3, 2, 8,
                                            torch.float32, "first"))
    with pytest.raises(ValueError, match="no decode attention kernel"):
        da.decode_attn(q, k, v, valid, idx)


def test_transformer_step_greedy_matches_jax():
    """Prefill a ragged prefix, then greedy decode 6 tokens through
    transformer_step on both packages from the same weights, the tokens
    chosen by argmax of a random head over the hidden state."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fewshot.config import Config as JConfig
    from fewshot.models import transformer as jtfm

    e, nh, layers, b, p, steps, vocab = 32, 2, 2, 3, 10, 6, 23
    kw = dict(model="transformer", embed_dim=e, num_heads=nh,
              num_layers=layers, compute_dtype="float32",
              prefix_flash=False, flash=False)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    params = tfm.init_transformer_params(cfg, torch.Generator()
                                         .manual_seed(4))
    tree = {"layers": [{n: jnp.asarray(getattr(lay, n).detach().numpy())
                        for n in ("ln1", "wqkv", "wo", "ln2", "w1", "w2")}
                       for lay in params.layers],
            "ln_f": jnp.asarray(params.ln_f.detach().numpy())}
    rng = np.random.RandomState(7)
    table = rng.randn(vocab, e).astype(np.float32)
    head = rng.randn(e, vocab).astype(np.float32)
    x = table[rng.randint(0, vocab, (b, p))]
    mask = np.arange(p)[None] < np.array([[10], [4], [7]])

    with torch.no_grad():
        cache = tfm.init_kv_cache(cfg, b, p + steps)
        tfm.prefill(params, torch.tensor(x), torch.tensor(mask), cache, cfg)
        jcache = jtfm.prefill(tree, jnp.asarray(x), jnp.asarray(mask),
                              jtfm.init_kv_cache(jcfg, b, p + steps), jcfg)
        tok = jtok = np.zeros(b, np.int64)
        for i in range(steps):
            h, cache = tfm.transformer_step(
                params, torch.tensor(table[tok]), cache, p + i, cfg)
            jh, jcache = jtfm.transformer_step(
                tree, jnp.asarray(table[jtok]), jcache, p + i, jcfg)
            jh = np.asarray(jh)
            scale = np.abs(jh).max()
            assert np.abs(h.numpy() - jh).max() <= 2e-5 * scale, i
            tok = (h.numpy() @ head).argmax(-1)
            jtok = (jh @ head).argmax(-1)
            np.testing.assert_array_equal(tok, jtok)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

# the tolerances of the module docstring
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# name: (B, songs, slots, decode positions + 1, nh, hd, dtype); "cell" is
# tfm_cache.sample's shape
CUDA_CASES = {
    "cell": (2048, 5, 96, 129, 2, 128, torch.bfloat16),
    "hd128_fp32": (64, 5, 96, 129, 2, 128, torch.float32),
    "hd24_bf16": (64, 5, 96, 129, 2, 24, torch.bfloat16),
    "hd24_fp32": (64, 5, 96, 129, 2, 24, torch.float32),
    "hd20_bf16": (32, 3, 40, 17, 3, 20, torch.bfloat16),     # 1 element a lane
    "hd36_bf16": (32, 3, 40, 17, 2, 36, torch.bfloat16),     # 2 chunks a lane
    "hd6_fp32": (32, 3, 40, 17, 4, 6, torch.float32),
    "hd192_fp32": (32, 3, 40, 17, 2, 192, torch.float32),    # 2 chunks a lane
    "hd512_bf16": (16, 3, 40, 17, 1, 512, torch.bfloat16),   # 2 chunks a lane
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("idx_at", ["first", "last"])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernel_matches_twin_on_cuda(cuda_device, case, idx_at):
    b, songs, slots, extra, nh, hd, dt = CUDA_CASES[case]
    q, k, v, valid, idx = _inputs(5, b, songs, slots, extra, nh, hd, dt,
                                  idx_at, cuda_device)
    before = da.decode_attn.launches
    got = da.decode_attn(q, k, v, valid, idx)
    again = da.decode_attn(q, k, v, valid, idx)
    want = da.decode_attn_plain(q, k, v, valid, idx)
    torch.cuda.synchronize()
    assert da.decode_attn.launches == before + 2
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= TOL[dt], (case, err)
    # row 0's prefix is one real slot a song: it reads few keys
    assert float((got[0] - want[0]).abs().max()) <= TOL[dt]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_row_without_admitted_keys_on_cuda(cuda_device, name):
    """A row whose every key is masked (never on the decode path, which
    admits idx) gets the twin's answer: p = 1/T on every position."""
    q, k, v, valid, idx = _inputs(6, 8, 3, 10, 5, 2, 32, DTYPES[name],
                                  "first", cuda_device)
    valid[2] = False
    got = da.decode_attn(q, k, v, valid, idx)
    want = da.decode_attn_plain(q, k, v, valid, idx)
    assert float((got - want).abs().max()) <= TOL[DTYPES[name]]


def test_launches_per_decode_step_on_cuda(cuda_device):
    """transformer_step launches the kernel once a layer, and the decoded
    hidden states follow the CPU twin's."""
    cfg = Config(model="transformer", embed_dim=256, num_heads=2,
                 num_layers=3, compute_dtype="bfloat16")
    dev = cuda_device
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, 7, 256), generator=gen)
    mask = torch.arange(7)[None] < torch.tensor([[7], [3], [5], [1]])
    caches = {}
    for d in ("cpu", dev):
        p_d = tfm.init_transformer_params(cfg, torch.Generator()
                                          .manual_seed(0)).to(d)
        with torch.no_grad():
            c = tfm.init_kv_cache(cfg, 4, 12, d)
            tfm.prefill(p_d, x.to(d), mask.to(d), c, cfg)
            caches[str(d)] = (p_d, c)
    before = da.decode_attn.launches
    p_d, c = caches[str(dev)]
    p_c, c_c = caches["cpu"]
    with torch.no_grad():
        for i in range(4):
            xt = torch.randn((4, 256), generator=gen)
            h, c = tfm.transformer_step(p_d, xt.to(dev), c, 7 + i, cfg)
            h_c, c_c = tfm.transformer_step(p_c, xt, c_c, 7 + i, cfg)
            assert da.decode_attn.launches == before + cfg.num_layers * (i + 1)
            # bf16 hidden states: the kernel and the twin round alike, but
            # the prefill's attention kernels and the GEMMs sum in another
            # order than the CPU's, one bf16 unit (2^-8) of the residual
            # stream, carried through 3 layers
            scale = float(h_c.float().abs().max())
            assert float((h.float().cpu() - h_c.float()).abs().max()) \
                <= 5e-2 * scale


@pytest.mark.parametrize("bad", ["wide_head", "long_cache", "strided"])
def test_refused_shapes_raise_on_cuda(cuda_device, bad):
    if bad == "wide_head":      # 256 16-byte chunks a position
        shape, dt = (2, 3, 1, 2048), torch.bfloat16
    elif bad == "long_cache":   # 5 bytes of shared memory a position
        shape, dt = (1, 50000, 1, 8), torch.bfloat16
    else:
        shape, dt = (2, 6, 2, 32), torch.float32
    b, t, nh, hd = shape
    k = torch.zeros(shape, dtype=dt, device=cuda_device)
    v = torch.zeros_like(k)
    if bad == "strided":
        k = torch.zeros((b, t, nh, 2 * hd), dtype=dt,
                        device=cuda_device)[..., :hd]
    q = torch.zeros((b, 1, nh, hd), dtype=dt, device=cuda_device)
    valid = torch.ones((b, t), dtype=torch.bool, device=cuda_device)
    before = da.decode_attn.launches
    with pytest.raises(ValueError):
        da.decode_attn(q, k, v, valid, t - 1)
    assert da.decode_attn.launches == before
