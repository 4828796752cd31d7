"""The port's sampler against fewshot.sampling.

* filtered_sample: given the same Gumbel noise that jax.random.categorical
  draws for a key, the port picks the same token as the JAX sampler, for
  every mix of temperature (scalar or per row), top-k and top-p; this pins
  temperature-before-top-k and the nucleus rule exactly.
* Greedy end to end (top_k=1, fp32): the port's generate() emits the JAX
  package's tokens, token for token, on fixed episodes and bridged weights,
  with the JAX side on its Pallas kernels in interpret mode (a subprocess:
  FEWSHOT_PALLAS_INTERPRET is read at import).  2 layers route to the fused
  kernel, 1 layer to the per-layer kernel.  The support state and the
  per-step logits along JAX's tokens agree to 1e-4 (fp32; the logits reach
  about 10 in magnitude, and only summation order differs).
* A row emits PAD after its EOS, early exit changes nothing, and a row's
  output does not depend on its batch neighbours.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot import sampling as jsampling
from fewshot_torch import sampling
from fewshot_torch.bridge import params_from_numpy
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.vocab import EOS, PAD
from fewshot_torch.models import lm, lstm
from fewshot_torch.ops import lstm_stack

REPO = Path(__file__).resolve().parent.parent
E, H, N_TOK = 32, 128, 12
# (layers, support_mode): the fused kernel on the shipped mode, the
# per-layer kernel on the bench mode
ROUTES = [(2, "state"), (1, "mean_state")]
SONG_IDS = np.array([[0, 1, 2], [8, 9, 10], [13, 14, 12], [40, 41, 42]])


def _cfg_kw(layers, mode, v):
    return dict(vocab_size=64, max_len=24, embed_dim=E, hidden_dim=H,
                num_layers=layers, batch_size=4, support_size=2,
                query_size=1, cell="pallas", support_mode=mode,
                compute_dtype="float32", top_k=1, sample_tokens=N_TOK)


def _tree(layers, v, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda s, *shape: (s * rng.randn(*shape)).astype(np.float32)  # noqa
    tree = {"embed": f(0.5, v, E), "out_b": f(0.1, v), "lstm": [],
            "out_proj": f(0.3, H, E)}
    in_dim = E
    for _ in range(layers):
        lim = np.sqrt(6.0 / (in_dim + 5 * H))
        tree["lstm"].append({
            "wx": rng.uniform(-lim, lim, (in_dim, 4 * H)).astype(np.float32),
            "wh": rng.uniform(-lim, lim, (H, 4 * H)).astype(np.float32),
            "b": f(0.1, 4 * H)})
        in_dim = H
    return tree


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from fewshot import sampling
from fewshot.config import Config
from fewshot.data.episodes import CorpusOnDevice, gather_episode
from fewshot.data.vocab import BOS
from fewshot.models import lm, lstm

d = sys.argv[1]
z = dict(np.load(d + "/inputs.npz"))
data = CorpusOnDevice(*(jnp.asarray(z[k]) for k in
                        ("songs", "song_len", "artist_song_ids",
                         "artist_num_songs")))
out = {}
for layers, mode in ((2, "state"), (1, "mean_state")):
    tag = f"{layers}_{mode}"
    params = {"embed": jnp.asarray(z[f"{tag}_embed"]),
              "out_b": jnp.asarray(z[f"{tag}_out_b"]),
              "out_proj": jnp.asarray(z[f"{tag}_out_proj"]),
              "lstm": [{k: jnp.asarray(z[f"{tag}_lstm{l}_{k}"])
                        for k in ("wx", "wh", "b")} for l in range(layers)]}
    cfg = Config(vocab_size=64, max_len=z["songs"].shape[1], embed_dim=32,
                 hidden_dim=128, num_layers=layers, batch_size=4,
                 support_size=2, query_size=1, cell="pallas",
                 support_mode=mode, compute_dtype="float32", top_k=1,
                 sample_tokens=int(z["n_tok"]))
    ep = gather_episode(data, jnp.asarray(z["song_ids"]),
                        jnp.asarray(z["artist"]), 2, 1)
    toks = sampling.generate(params, ep.support, ep.support_len,
                             jax.random.PRNGKey(0), cfg)
    state = lm.support_state(params, ep.support, ep.support_len, cfg,
                             eval_mode=True)
    out[f"{tag}_toks"] = np.asarray(toks)
    out[f"{tag}_h"] = np.stack([np.asarray(h) for h, _ in state])
    out[f"{tag}_c"] = np.stack([np.asarray(c) for _, c in state])
    tok = jnp.full((toks.shape[0],), BOS, jnp.int32)
    logits = []
    for i in range(toks.shape[1]):
        h, state = lstm.lstm_step(params["lstm"], lm.embed(params, tok),
                                  state, jnp.float32)
        logits.append(np.asarray(lm.head_logits(params, h, cfg)))
        tok = toks[:, i]
    out[f"{tag}_logits"] = np.stack(logits)
np.savez(d + "/jax_out.npz", **out)
"""


@pytest.fixture(scope="module")
def greedy(tiny_corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("greedy")
    v = len(tiny_corpus.vocab)
    z = {k: np.asarray(a) for k, a in tiny_corpus.device_arrays().items()}
    z.update(song_ids=SONG_IDS.astype(np.int32),
             artist=tiny_corpus.song_artist[SONG_IDS[:, 0]].astype(np.int32),
             n_tok=np.int32(N_TOK))
    trees = {}
    for layers, mode in ROUTES:
        tag = f"{layers}_{mode}"
        tree = trees[tag] = _tree(layers, v)
        for k in ("embed", "out_b", "out_proj"):
            z[f"{tag}_{k}"] = tree[k]
        for l, layer in enumerate(tree["lstm"]):
            for k, a in layer.items():
                z[f"{tag}_lstm{l}_{k}"] = a
    np.savez(d / "inputs.npz", **z)
    env = dict(os.environ, FEWSHOT_PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return z, trees, dict(np.load(d / "jax_out.npz"))


def _episode(z):
    data = eps.put_corpus({k: z[k] for k in ("songs", "song_len",
                                             "artist_song_ids",
                                             "artist_num_songs")}, "cpu")
    return eps.gather_episode(data, torch.tensor(z["song_ids"]),
                              torch.tensor(z["artist"]), 2, 1)


@pytest.mark.parametrize("layers,mode", ROUTES)
def test_greedy_generate_matches_jax(greedy, layers, mode):
    z, trees, ref = greedy
    tag = f"{layers}_{mode}"
    v = trees[tag]["embed"].shape[0]
    cfg = Config(**{**_cfg_kw(layers, mode, v),
                    "max_len": z["songs"].shape[1]})
    params = params_from_numpy(trees[tag], "cpu")
    ep = _episode(z)
    rows = len(SONG_IDS) * (2 if mode == "mean_state" else 1)
    assert lstm_stack.stack_fused_supported(
        params.lstm, torch.float32, batch_rows=rows,
        eval_mode=True) == (layers == 2)
    gens = [sampling.row_generator(i, 1) for i in range(len(SONG_IDS))]
    toks = sampling.generate(params, ep.support, ep.support_len, gens, cfg)
    np.testing.assert_array_equal(toks.numpy(), ref[f"{tag}_toks"])

    with torch.no_grad():
        state = lm.support_state(params, ep.support, ep.support_len, cfg,
                                 eval_mode=True)
        np.testing.assert_allclose(torch.stack([h for h, _ in state]).numpy(),
                                   ref[f"{tag}_h"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(torch.stack([c for _, c in state]).numpy(),
                                   ref[f"{tag}_c"], rtol=0, atol=1e-4)
        tok = torch.full((len(SONG_IDS),), 1, dtype=torch.int64)
        jtoks = torch.tensor(ref[f"{tag}_toks"]).long()
        for i in range(N_TOK):
            h, state = lstm.lstm_step(params.lstm, lm.embed(params, tok),
                                      state, torch.float32)
            logits = lm.head_logits(params, h, cfg)
            np.testing.assert_allclose(logits.numpy(), ref[f"{tag}_logits"][i],
                                       rtol=0, atol=1e-4)
            tok = jtoks[:, i]


@pytest.mark.parametrize("temperature", [1.0, 0.3, "rows"])
@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8),
                                         (7, 0.6), (1, 0.0)])
def test_filtered_sample_matches_jax(temperature, top_k, top_p):
    rng = np.random.RandomState(5)
    b, v = 6, 50
    logits = (2.0 * rng.randn(b, v)).astype(np.float32)
    temp = (rng.uniform(0.2, 2.0, b).astype(np.float32)
            if temperature == "rows" else temperature)
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        noise = np.asarray(jax.random.gumbel(key, (b, v), jnp.float32))
        want = jsampling.filtered_sample(key, jnp.asarray(logits),
                                         jnp.asarray(temp), top_k, top_p)
        got = sampling.filtered_sample(torch.tensor(noise),
                                       torch.tensor(logits),
                                       torch.as_tensor(temp), top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filter_logits_keeps_the_right_set():
    logits = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0]])
    kept = sampling.filter_logits(logits, 0.5, top_k=2)
    # temperature first: the survivors carry logits / T
    assert torch.equal(kept[0, :2], torch.tensor([8.0, 6.0]))
    assert torch.isinf(kept[0, 2:]).all()
    # nucleus: p = softmax([4, 3, 2, 1, 0]) = .64, .24, .09, ...; 0.7 keeps 2
    kept = sampling.filter_logits(logits, 1.0, top_k=0, top_p=0.7)
    assert torch.isfinite(kept[0]).tolist() == [True, True, False, False,
                                                False]


def _small_model(layers=1, eos_bias=0.0, mode="mean_state"):
    v = 30
    tree = _tree(layers, v, seed=3)
    tree["out_b"][EOS] += eos_bias
    cfg = Config(**{**_cfg_kw(layers, mode, v), "top_k": 0,
                    "sample_tokens": 40})
    return params_from_numpy(tree, "cpu"), cfg, v


def _support(v, b, seed=6):
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, 10, (b, 2))
    sup = rng.randint(4, v, (b, 2, 10))
    sup[np.arange(10)[None, None] >= lens[..., None]] = PAD
    return torch.tensor(sup).long(), torch.tensor(lens).long()


def test_pad_after_eos_and_early_exit_is_exact():
    params, cfg, v = _small_model(eos_bias=4.0)
    sup, lens = _support(v, 6)
    gens = lambda: [sampling.row_generator(s, 1) for s in range(6)]  # noqa
    full = sampling.generate(params, sup, lens, gens(), cfg,
                             early_exit=False)
    early = sampling.generate(params, sup, lens, gens(), cfg)
    assert torch.equal(full, early)
    rows_with_eos = 0
    for row in full.tolist():
        if EOS in row:
            rows_with_eos += 1
            assert all(t == PAD for t in row[row.index(EOS) + 1:])
    assert rows_with_eos == 6


def test_row_depends_only_on_its_own_generator():
    params, cfg, v = _small_model(layers=2, mode="state")
    sup, lens = _support(v, 3)
    seeds = [11, 12, 13]
    batched = sampling.generate(
        params, sup, lens, [sampling.row_generator(s, 1) for s in seeds],
        cfg, temperature=torch.tensor([0.7, 1.3, 0.9]))
    alone = sampling.generate(
        params, sup[1:2], lens[1:2], [sampling.row_generator(12, 1)], cfg,
        temperature=torch.tensor([1.3]))
    assert torch.equal(batched[1], alone[0])
    swapped = sampling.generate(
        params, sup[[2, 1, 0]], lens[[2, 1, 0]],
        [sampling.row_generator(s, 1) for s in seeds[::-1]], cfg,
        temperature=torch.tensor([0.9, 1.3, 0.7]))
    assert torch.equal(swapped[[2, 1, 0]], batched)
