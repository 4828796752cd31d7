"""The inputs a run makes from its seed: sub-seeds, the corpus and the
weights.  Both sides, the program and the reference, get the same."""

from __future__ import annotations

import math
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from portbench import cells
from portbench.reference.model import CALIB_MAX, EOS

CORPUS_ROOT = cells.HERE / "data"


def sub_seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds from a run's seed (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 128)
    return [int(s.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)
            for s in ss.spawn(n)]


def corpus(recipe: dict, root: Path = CORPUS_ROOT):
    """The packed corpus of the recipe (the synthetic lyrics generator and
    the corpus builder of the program's ``prepare``), built once into
    root/<name> and loaded from there afterwards."""
    from fewshot_torch.data.corpus import PackedCorpus, build_lyrics_corpus
    from fewshot_torch.data.synthetic import generate_lyrics_csv
    out = Path(root) / recipe["name"]
    if not (out / "corpus.npz").exists():
        work = Path(root) / (recipe["name"] + ".building")
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        csv = work / "lyrics.csv"
        generate_lyrics_csv(csv, num_artists=recipe["artists"],
                            songs_per_artist=recipe["songs"],
                            seed=recipe["seed"],
                            extra_vocab=recipe["extra_vocab"])
        build_lyrics_corpus(csv, work / "corpus", vocab_size=recipe[
            "vocab_size"], max_len=recipe["max_len"], seed=recipe["seed"])
        csv.unlink()
        shutil.rmtree(out, ignore_errors=True)
        os.replace(work / "corpus", out)
        shutil.rmtree(work, ignore_errors=True)
    return PackedCorpus.load(out)


def glorot(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def leaves(spec: dict, vocab: int) -> list:
    """(name, shape, kind, scale, offset) of every parameter: "u" leaves are
    uniform on (-scale, scale) (glorot), "n" leaves offset + scale N(0, 1).
    The backbones and the head follow the recipe's initialisation; the
    tied embedding is N(0, embed_std^2) (the configuration's "init": wider
    than the recipe's 0.02, so that the LM branch's logits spread by a few
    nats and the backbone, not the support counts alone, picks a greedy
    token); the cache head's and the norms' leaves, which start constant
    in the recipe, get a spread around their starting values so that every
    path of the mixture carries weight from the first step.  "gain" in
    "init" scales the leaves of a name (``w2``: every block's) after the
    draw.  The backbone's leaves (backbones/<model>.py) lie between the
    embedding and ``out_b``."""
    e = spec["embed_dim"]
    backbone = cells.backbone(spec["model"])
    out = [("embed", (vocab, e), "n", spec["init"]["embed_std"], 0.0)]
    out += backbone.leaves(spec)
    d = backbone.width(spec)
    out.append(("out_b", (vocab,), "n", 0.1, 0.0))
    if d != e:
        out.append(("out_proj", (d, e), "u", glorot(d, e), 0.0))
    out += [("cache_gate.w", (d,), "n", 1.0 / math.sqrt(d), 0.0),
            ("cache_gate.b", (), "n", 0.2, spec["init"]["gate_b"]),
            ("cache_prior.u", (vocab,), "n", 0.5, 0.0),
            ("cache_prior.log_s", (), "n", 0.1, math.log(0.01 * vocab)),
            ("cache_calib.t", (CALIB_MAX,), "n", 0.1, 0.0)]
    return out


def weights(spec: dict, vocab: int, seed: int, device) -> dict:
    """fp32 parameters by name, drawn on `device` from `seed` in two calls
    (one uniform, one normal) and cut into the leaves."""
    ls = leaves(spec, vocab)
    gains = spec["init"].get("gain", {})
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {k: sum(math.prod(s) for _, s, kk, _, _ in ls if kk == k)
             for k in ("u", "n")}
    draws = {"u": torch.rand(sizes["u"], generator=gen, device=device),
             "n": torch.randn(sizes["n"], generator=gen, device=device)}
    at = {"u": 0, "n": 0}
    out = {}
    for name, shape, kind, scale, offset in ls:
        n = math.prod(shape)
        x = draws[kind][at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        x = (x * 2 - 1) * scale if kind == "u" else x * scale + offset
        x = x * gains.get(name.rsplit(".", 1)[-1], 1.0)
        if name == "cache_calib.t":      # around the identity, log c
            x = x + torch.log(torch.arange(1, CALIB_MAX + 1,
                                           device=device).float())
        if name == "out_b":              # the LM branch's end of song
            x[EOS] = spec["init"].get("eos_b", 0.0)
        out[name] = x.contiguous()
    return out
