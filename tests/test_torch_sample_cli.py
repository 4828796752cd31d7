"""Grammar-masked decoding and the port's sample command, on the CPU.

* Greedy decoding (top_k=1, fp32, bridged weights) under the MIDI grammar
  masks emits JAX's tokens, for the LSTM (state and mean_state) and the
  transformer, without the cache head and with the static and the dynamic
  one, up to a row's first near tie (a top-two gap of at most GAP in the
  port's masked log-probs); an EOS bias makes rows finish at different
  steps, so a finished row's frozen phase is exercised.
* Ancestral, top-k and nucleus sampling under the masks: every row is
  whole SHIFT->PITCH->DUR->VEL groups (EOS only at a group boundary), each
  group decodes into a note, and no masked logit turns into a NaN.
* ``cli sample`` writes ``.txt`` files for lyrics and ``.mid`` files for
  MIDI that both packages' readers parse; a BPE MIDI corpus samples
  without masks (merged tokens span phases) and its tokens are expanded
  to base events before the ``.mid`` is written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fewshot import sampling as jsampling
from fewshot.config import Config as JConfig
from fewshot.data import corpus as jcorpus
from fewshot.data import midi as jmidi
from fewshot.data import synthetic as jsynthetic
from fewshot.models import lm as jlm
from fewshot_torch import cli, sampling, training
from fewshot_torch.bridge import flatten, params_from_numpy, unflatten
from fewshot_torch.config import Config
from fewshot_torch.data import midi as tmidi
from fewshot_torch.data.corpus import PackedCorpus
from fewshot_torch.data.vocab import EOS, PAD, SPECIALS, Vocab
from fewshot_torch.utils import ckpt

VOCAB = Vocab(SPECIALS + tmidi.full_event_vocab())
V, L, B, N = len(VOCAB), 16, 4, 26
GAP = 1e-3          # a top-two gap above this decides a greedy token
KINDS = ["SHIFT", "PITCH", "DUR", "VEL"]
CASES = [(m, mode, cache) for m, mode in (("lstm", "state"),
                                          ("lstm", "mean_state"),
                                          ("transformer", "state"))
         for cache in ("none", "static", "dynamic")]


def _kw(model, mode, cache):
    return dict(dataset="midi", model=model, vocab_size=V, max_len=L,
                embed_dim=32, hidden_dim=64, num_layers=2, num_heads=2,
                batch_size=B, support_size=2, query_size=1, cell="scan",
                prefix_flash=False, support_mode=mode,
                compute_dtype="float32", top_k=1, sample_tokens=N,
                support_cache=cache != "none", cache_backoff="global",
                cache_calib=cache != "none", cache_calib_freq=cache != "none",
                cache_dynamic=cache == "dynamic", data_parallel=False)


def _tree(kw, seed):
    tree = jlm.init_lm(jax.random.PRNGKey(seed), JConfig(**kw), V)
    rng = np.random.RandomState(seed)
    flat = flatten(jax.tree.map(np.asarray, tree))
    return unflatten({k: (np.asarray(a, np.float32) + 0.3 * rng.randn(
        *np.shape(a))).astype(np.float32) for k, a in flat.items()})


def _support(seed):
    """Well-formed event songs (whole groups), PAD after each length."""
    rng = np.random.RandomState(seed)
    masks = tmidi.grammar_masks(VOCAB)
    legal = [np.nonzero(masks[p] & (np.arange(V) >= 4))[0] for p in range(4)]
    sup = np.zeros((B, 2, L), np.int32)
    lens = rng.randint(2, L // 4 + 1, (B, 2)) * 4
    for b in range(B):
        for k in range(2):
            sup[b, k, :lens[b, k]] = [rng.choice(legal[i % 4])
                                      for i in range(lens[b, k])]
    return sup, lens.astype(np.int32)


def _stream_ok(row, vocab=VOCAB):
    """Every non-PAD token fits the cycle; EOS only at a group boundary,
    then PAD.  Returns the number of whole groups."""
    phase, groups = 0, 0
    row = [int(t) for t in row]
    for i, t in enumerate(row):
        if t == EOS:
            assert phase == 0, (i, row)
            assert all(x == PAD for x in row[i + 1:])
            return groups
        assert t != PAD, row
        assert vocab.tokens[t].split("_")[0] == KINDS[phase], (i, row)
        phase = (phase + 1) % 4
        groups += phase == 0
    return groups


@pytest.fixture(scope="module", params=CASES,
                ids=["-".join(c) for c in CASES])
def masked_greedy(request):
    kw = _kw(*request.param)
    tree = _tree(kw, seed=4)
    # a lean to EOS: some rows stop at a group boundary while others run on
    tree["out_b"][EOS] += 3.0 if kw["model"] == "lstm" else 4.0
    sup, lens = _support(7)
    sup[1] = sup[3] = np.roll(sup[1], 1, axis=0)        # other supports
    masks = jmidi.grammar_masks(VOCAB)
    jtoks = jsampling.generate(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(sup), jnp.asarray(lens),
                               jax.random.PRNGKey(0), JConfig(**kw),
                               token_masks=jnp.asarray(masks),
                               early_exit=False)
    return kw, tree, sup, lens, np.asarray(jtoks)


def test_masked_greedy_matches_jax(masked_greedy, monkeypatch):
    kw, tree, sup, lens, jtoks = masked_greedy
    cfg = Config(**kw)
    seen = []
    orig = sampling.filtered_sample

    def watch(noise, logits, *a, **k):
        seen.append(logits.clone())
        return orig(noise, logits, *a, **k)
    monkeypatch.setattr(sampling, "filtered_sample", watch)
    gens = [torch.Generator().manual_seed(i) for i in range(B)]
    masks = torch.as_tensor(tmidi.grammar_masks(VOCAB))
    toks = sampling.generate(params_from_numpy(tree, "cpu"),
                             torch.as_tensor(sup).long(),
                             torch.as_tensor(lens).long(), gens, cfg,
                             token_masks=masks, early_exit=False).numpy()
    logits = torch.stack(seen).numpy()                  # [N, B, V]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    decided = 0
    for r in range(B):
        small = np.nonzero(gap[:, r] <= GAP)[0]
        upto = small[0] + 1 if len(small) else N
        np.testing.assert_array_equal(toks[r, :upto], jtoks[r, :upto])
        decided += upto
        _stream_ok(toks[r])
    assert decided >= B * N // 2
    # the masked logits are -inf off the phase's tokens, never NaN
    assert not np.isnan(logits).any()
    assert np.isinf(logits).any()


def test_finished_row_keeps_its_phase(monkeypatch):
    """Scripted draws: row 0 ends after one group, row 1 runs on.  Row 0's
    later steps are masked for phase 0 (its phase froze at EOS), row 1's
    cycle through the four phases."""
    kw = _kw("lstm", "state", "none")
    tree = _tree(kw, seed=1)
    masks = torch.as_tensor(tmidi.grammar_masks(VOCAB))
    legal = [int(torch.nonzero(masks[p] & (torch.arange(V) >= 4))[0])
             for p in range(4)]
    script = [[legal[i % 4], legal[i % 4]] for i in range(4)] + \
        [[EOS, legal[i % 4]] for i in range(4, 12)]
    seen = []

    def scripted(noise, logits, *a, **k):
        seen.append(logits.clone())
        return torch.tensor(script[len(seen) - 1])
    monkeypatch.setattr(sampling, "filtered_sample", scripted)
    sup, lens = _support(2)
    toks = sampling.generate(params_from_numpy(tree, "cpu"),
                             torch.as_tensor(sup[:2]).long(),
                             torch.as_tensor(lens[:2]).long(),
                             [torch.Generator() for _ in range(2)],
                             Config(**{**kw, "sample_tokens": 12}),
                             token_masks=masks, early_exit=False)
    assert toks[0].tolist() == [legal[i] for i in range(4)] + [EOS] + \
        [PAD] * 7
    for i, logits in enumerate(seen):
        live = torch.isfinite(logits)
        assert torch.equal(live[0], masks[0] if i >= 4 else masks[i % 4])
        assert torch.equal(live[1], masks[i % 4])


@pytest.mark.parametrize("model", ["lstm", "transformer"])
@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.9),
                                         (40, 0.7)])
def test_sampled_groups_decode_into_notes(model, top_k, top_p):
    kw = {**_kw(model, "state", "dynamic"), "top_k": top_k, "top_p": top_p,
          "sample_tokens": 40}
    tree = _tree(kw, seed=2)
    sup, lens = _support(3)
    gens = [sampling.row_generator(s, 1) for s in range(B)]
    toks = sampling.generate(params_from_numpy(tree, "cpu"),
                             torch.as_tensor(sup).long(),
                             torch.as_tensor(lens).long(), gens,
                             Config(**kw),
                             token_masks=tmidi.grammar_masks(VOCAB))
    total = 0
    for row in toks.numpy():
        groups = _stream_ok(row)
        notes = tmidi.events_to_notes(VOCAB.decode(row))
        assert len(notes) == groups
        total += groups
    assert total > 0


def test_filter_logits_keeps_masked_rows_finite():
    """-inf logits through temperature, top-k (fewer legal tokens than k)
    and nucleus filtering: no NaN, and only legal tokens survive."""
    rng = np.random.RandomState(0)
    logits = torch.tensor(rng.randn(3, 20).astype(np.float32))
    legal = torch.zeros(3, 20, dtype=torch.bool)
    legal[0, :3] = legal[1, 5:15] = legal[2, 19] = True
    masked = logits.masked_fill(~legal, float("-inf"))
    for top_k, top_p in ((0, 0.0), (5, 0.0), (0, 0.5), (8, 0.9)):
        out = sampling.filter_logits(masked, 0.7, top_k, top_p)
        assert not torch.isnan(out).any()
        assert torch.isinf(out[~legal]).all()
        assert torch.isfinite(out).any(dim=-1).all()
        noise = torch.tensor(rng.gumbel(size=(3, 20)).astype(np.float32))
        pick = sampling.filtered_sample(noise, masked, 0.7, top_k, top_p)
        assert legal[torch.arange(3), pick].all()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A lyrics, a MIDI and a BPE MIDI corpus (packed by the JAX package),
    each with a port checkpoint of its config's init weights."""
    d = tmp_path_factory.mktemp("sample")
    jsynthetic.generate_lyrics_csv(d / "l.csv", num_artists=8,
                                   songs_per_artist=6, seed=0)
    jcorpus.build_lyrics_corpus(d / "l.csv", d / "lyrics", vocab_size=120,
                                max_len=24)
    jsynthetic.generate_midi_corpus(d / "raw", num_artists=8,
                                    songs_per_artist=6, seed=0,
                                    notes_range=(4, 8))
    jcorpus.build_midi_corpus(d / "raw", d / "midi", max_len=0)
    jcorpus.build_midi_corpus(d / "raw", d / "midi_bpe", max_len=0,
                              bpe_merges=40)
    return d


def _sample(d, name, data, tmp_path, capsys, num=3):
    corpus = PackedCorpus.load(d / name)
    sets = [f"corpus_dir={d / name}", f"max_len={corpus.max_len}",
            f"vocab_size={max(len(corpus.vocab), 120)}", "embed_dim=16",
            "hidden_dim=32", "num_layers=1", "batch_size=4",
            "support_size=2", "query_size=2", "sample_tokens=32",
            "data_parallel=false"]
    args = ["--data", f"configs/data/{data}.yaml", "--model",
            "configs/model/lstm.yaml", "--task", "configs/task/episodic.yaml",
            "--checkpt_dir", str(tmp_path / "ck"), "--set", *sets]
    from fewshot_torch.config import load_config, parse_overrides
    cfg = load_config(f"configs/data/{data}.yaml", "configs/model/lstm.yaml",
                      "configs/task/episodic.yaml", parse_overrides(sets))
    state = training.init_train_state(cfg, len(corpus.vocab), device="cpu")
    ckpt.save_checkpoint(tmp_path / "ck", state, corpus.vocab.content_hash(),
                         hparams=ckpt.hparams_of(cfg))
    capsys.readouterr()
    cli.main(["sample", "--device", "cpu", "--out", str(tmp_path / "out"),
              "--num", str(num), "--split", "val", *args])
    out = capsys.readouterr().out
    paths = sorted((tmp_path / "out").iterdir())
    assert len(paths) == num
    assert [f"wrote {p}" for p in paths] == sorted(out.split("\n")[:-1])
    return cfg, corpus, paths


def test_sample_writes_text_for_lyrics(workspace, tmp_path, capsys):
    _, corpus, paths = _sample(workspace, "lyrics", "lyrics", tmp_path,
                               capsys)
    for p in paths:
        assert p.suffix == ".txt" and p.name.startswith("sample_0")
        assert p.read_text().endswith("\n")
        assert any(a in p.name for a in corpus.artist_names)


def test_sample_writes_midi_that_parses(workspace, tmp_path, capsys):
    cfg, corpus, paths = _sample(workspace, "midi", "midi", tmp_path,
                                 capsys, num=4)
    assert sampling.grammar_masks(cfg, corpus, "cpu") is not None
    notes = 0
    for p in paths:
        assert p.suffix == ".mid"
        got, want = tmidi.parse_midi(p), jmidi.parse_midi(p)
        assert [(n.pitch, n.velocity) for n in got] == \
            [(n.pitch, n.velocity) for n in want]
        notes += len(got)
    assert notes > 0          # masked: every group is a note


def test_bpe_midi_samples_unmasked_and_expands(workspace, tmp_path, capsys,
                                               monkeypatch):
    seen = []
    orig = sampling.generate

    def watch(*a, token_masks=None, **k):
        seen.append(token_masks)
        toks = orig(*a, token_masks=token_masks, **k)
        seen.append(toks.clone())
        return toks
    monkeypatch.setattr(sampling, "generate", watch)
    cfg, corpus, paths = _sample(workspace, "midi_bpe", "midi", tmp_path,
                                 capsys)
    assert corpus.merges and seen[0] is None
    assert sampling.grammar_masks(cfg, corpus, "cpu") is None
    toks = seen[1].numpy()
    merged = toks[toks >= 204]
    assert merged.size > 0                  # merge tokens were sampled
    for row, p in zip(toks, sorted(paths)):
        events = corpus.decode(row)
        assert all("+" not in e for e in events)
        assert len(events) >= int((row > EOS).sum())
        # the file holds the notes of the expanded events
        assert len(tmidi.parse_midi(p)) == len(tmidi.events_to_notes(events))
