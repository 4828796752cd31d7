"""Converged-quality legs: train to early stop, score the test split at the
best-val parameters, and hold the result against the unigram floor and the
JAX package's recorded test NLL.

Port of ``scripts/scale_quality.py`` (``run_leg`` and the leg table of
``main``) with the MIDI legs of ``scripts/midi_scale.py``.  The protocol is
the JAX scripts': the flagship LSTM (E=256, H=512, L=2, mean_state,
cell=pallas, bf16, B=32, K=Q=5, lr 1e-3) unless a leg overrides it; chunks
of 10 steps; a val eval every 500 steps on the same episodes each time;
early stop after `patience` evals without an improvement of more than
1e-4 (8 at 512 eval episodes for the lyrics legs, 6 at 256 for the MIDI
legs, at most 30000 and 20000 steps); the test NLL at the best-val
parameters, per base token for a BPE corpus.  A leg's record has the
fields of the JAX script's, under the same names.

The corpora are built offline from the JAX scripts' seeds and sizes
(``scripts/scale_test.py``: 2000 artists x 50 songs, V=5000, plain and
BPE-500; ``scripts/midi_scale.py``: 300 artists x 24 songs of 60-100
notes, plain and BPE-300) under ``--root``, once, and reused.

Run on the card, one leg an invocation:

    python -m fewshot_torch.quality --legs plain_cache_full_floor \\
        [--out PATH] [--device cpu] [--set cell=scan ...]

The JSON (default ``data/quality_torch/quality.json``; an existing file is
merged into, leg by leg) is rewritten after every leg: one record per leg
with its curve, the card's name and power limit per leg (``cards``), the
test NLL at the best-val parameters on the JAX package's own test
episodes (``jax_episodes``: the episodes that ``training.evaluate`` drew
for the JAX number, saved under ``quality_episodes/``), and each leg's
verdict against the JAX test NLL (``verdicts``): inside the band when
|port - JAX| <= max(0.02, 2 x the JAX seed pair's half-range), on the
same episodes where the set is there, and beating its unigram floor
wherever JAX did.  The JAX numbers are read from
``benchmarks/scale_quality.json`` and ``benchmarks/midi_scale.json``.
``--set`` overrides the leg's config (recorded under ``overrides``), e.g.
to run a leg on the plain route when bisecting a leg outside the band.
``--max_steps``, ``--eval_every`` and ``--eval_episodes`` cut the protocol
for a quick run: the cut is recorded under ``cuts`` and such a leg gets
no verdict.  The best-val parameters are saved under ``--root`` as
``best/<tag>.pt``.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time
from pathlib import Path

import torch

from fewshot_torch import training
from fewshot_torch.config import Config, parse_overrides
from fewshot_torch.data import episodes as eps
from fewshot_torch.data.corpus import (PackedCorpus, build_lyrics_corpus,
                                       build_midi_corpus)
from fewshot_torch.data.synthetic import (generate_lyrics_csv,
                                          generate_midi_corpus)
from fewshot_torch.device import resolve_device
from fewshot_torch.models.unigram import evaluate_unigram

PACKAGE = Path(__file__).resolve().parent
DEFAULT_ROOT = PACKAGE.parent / "data" / "quality_torch"
DEFAULT_OUT = DEFAULT_ROOT / "quality.json"
BENCHMARKS = PACKAGE.parent / "benchmarks"
EPISODE_SETS = PACKAGE / "quality_episodes"

# The eval seeds of scripts/scale_quality.py: floors, every val eval, test.
FLOOR_SEED, VAL_SEED, TEST_SEED = 1234, 7, 99
IMPROVEMENT = 1e-4
BAND_MIN = 0.02
CUTS = ("max_steps", "eval_every", "eval_episodes")    # the quick-run flags

# scripts/scale_test.py:33-67 and scripts/midi_scale.py:36-40
LYRICS_SIZES = dict(artists=2000, songs=50, extra_vocab=6000,
                    vocab_size=5000, bpe_merges=500, seed=0)
MIDI_SIZES = dict(artists=300, songs=24, notes=(60, 100), bpe_merges=300,
                  seed=0)
# scripts/scale_quality.py:168-176 and scripts/midi_scale.py:41-46
PROTOCOLS = {
    "lyrics": dict(max_steps=30000, eval_every=500, steps_per_call=10,
                   patience=8, eval_episodes=512),
    "midi": dict(max_steps=20000, eval_every=500, steps_per_call=10,
                 patience=6, eval_episodes=256),
}

_CACHE_G = dict(support_cache=True, cache_backoff="global")
_FULL = dict(_CACHE_G, cache_calib=True, cache_dynamic=True)
_FT = dict(support_mode="finetune", cell="scan", batch_size=16,
           inner_steps=2, inner_lr=0.05, max_steps=12000)
_TFM = dict(model="transformer")

# tag -> (corpus: family/sub, overrides); scripts/scale_quality.py:207-285
# and scripts/midi_scale.py:104-181 (its tags prefixed midi_)
LEGS = {
    "plain": ("lyrics/plain", {}),
    "plain_cache": ("lyrics/plain", dict(support_cache=True)),
    "bpe": ("lyrics/bpe", {}),
    "bpe_cache": ("lyrics/bpe", dict(support_cache=True)),
    "plain_cache_global": ("lyrics/plain", _CACHE_G),
    "bpe_cache_global": ("lyrics/bpe", _CACHE_G),
    "plain_cache_calib": ("lyrics/plain", dict(_CACHE_G, cache_calib=True)),
    "plain_cache_dyn": ("lyrics/plain", dict(_CACHE_G, cache_dynamic=True)),
    "plain_cache_full": ("lyrics/plain", _FULL),
    "bpe_cache_full": ("lyrics/bpe", _FULL),
    "plain_cache_freq": ("lyrics/plain", dict(_FULL, cache_calib_freq=True)),
    "bpe_cache_freq": ("lyrics/bpe", dict(_FULL, cache_calib_freq=True)),
    "tfm": ("lyrics/plain", _TFM),
    "tfm_cache_full": ("lyrics/plain", dict(_TFM, **_FULL)),
    "plain_ft": ("lyrics/plain", _FT),
    "plain_ft_cache_full": ("lyrics/plain", dict(_FT, **_FULL)),
    "plain_cache_full_s1": ("lyrics/plain", dict(_FULL, seed=1)),
    "plain_cache_freq_s1": ("lyrics/plain",
                            dict(_FULL, cache_calib_freq=True, seed=1)),
    "bpe_cache_freq_s1": ("lyrics/bpe",
                          dict(_FULL, cache_calib_freq=True, seed=1)),
    "tfm_cache_full_s1": ("lyrics/plain", dict(_TFM, **_FULL, seed=1)),
    "plain_cache_full_aux": ("lyrics/plain", dict(_FULL, cache_lm_aux=1.0)),
    "tfm_cache_full_aux": ("lyrics/plain",
                           dict(_TFM, **_FULL, cache_lm_aux=1.0)),
    "plain_cache_full_floor": ("lyrics/plain",
                               dict(_FULL, cache_resp_floor=0.25)),
    "plain_cache_full_floor_s1": ("lyrics/plain",
                                  dict(_FULL, cache_resp_floor=0.25, seed=1)),
    "tfm_cache_full_floor": ("lyrics/plain",
                             dict(_TFM, **_FULL, cache_resp_floor=0.25)),
    "tfm_cache_full_floor_s1": ("lyrics/plain", dict(
        _TFM, **_FULL, cache_resp_floor=0.25, seed=1)),
    "midi_plain": ("midi/plain", {}),
    "midi_bpe": ("midi/bpe", {}),
    "midi_plain_cache": ("midi/plain", _FULL),
    "midi_plain_cache_aux": ("midi/plain", dict(_FULL, cache_lm_aux=1.0)),
    "midi_plain_cache_aux_s1": ("midi/plain",
                                dict(_FULL, cache_lm_aux=1.0, seed=1)),
    "midi_tfm": ("midi/plain", _TFM),
    "midi_tfm_cache": ("midi/plain", dict(_TFM, **_FULL)),
    "midi_tfm_cache_aux": ("midi/plain",
                           dict(_TFM, **_FULL, cache_lm_aux=1.0)),
    "midi_bpe_cache": ("midi/bpe", _FULL),
    "midi_bpe_cache_aux": ("midi/bpe", dict(_FULL, cache_lm_aux=1.0)),
    "midi_plain_cache_floor": ("midi/plain",
                               dict(_FULL, cache_resp_floor=0.25)),
    "midi_plain_cache_floor_s1": ("midi/plain",
                                  dict(_FULL, cache_resp_floor=0.25, seed=1)),
}

# The legs whose JAX seed pair sets the noise.
SEED_PAIRS = [
    ("plain_cache_full", "plain_cache_full_s1"),
    ("plain_cache_freq", "plain_cache_freq_s1"),
    ("bpe_cache_freq", "bpe_cache_freq_s1"),
    ("tfm_cache_full", "tfm_cache_full_s1"),
    ("plain_cache_full_floor", "plain_cache_full_floor_s1"),
    ("tfm_cache_full_floor", "tfm_cache_full_floor_s1"),
    ("midi_plain_cache_aux", "midi_plain_cache_aux_s1"),
    ("midi_plain_cache_floor", "midi_plain_cache_floor_s1"),
]


def jax_leg(tag: str) -> dict | None:
    """The JAX package's record of the leg: ``benchmarks/scale_quality.json``
    or, for a midi_ tag, ``benchmarks/midi_scale.json`` under the tag
    without its prefix; None where JAX ran no such leg."""
    path, key = BENCHMARKS / "scale_quality.json", tag
    if tag.startswith("midi_"):
        path, key = BENCHMARKS / "midi_scale.json", tag[len("midi_"):]
    rec = json.loads(path.read_text()).get(key)
    return rec if isinstance(rec, dict) and "test_nll_base" in rec else None


def band(tag: str) -> float:
    """The leg's band in nats: max(0.02, 2 x its JAX seed pair's
    half-range); 0.02 for a leg without a pair."""
    for pair in SEED_PAIRS:
        if tag in pair:
            a, b = (jax_leg(t)["test_nll_base"] for t in pair)
            return max(BAND_MIN, abs(a - b))     # 2 x half of |a - b|
    return BAND_MIN


def verdict(tag: str, leg: dict, on_jax_episodes: dict | None = None
            ) -> dict:
    """The port's test NLL (per base token) against JAX's, and its floor
    beaten where JAX beat its own.  on_jax_episodes: the port's score on
    JAX's test episodes, which the verdict then uses; else the port's own
    draw of test episodes."""
    jax = jax_leg(tag)
    if jax is None:
        return {"jax_test_nll_base": None}
    port = (on_jax_episodes or leg)["test_nll_base"]
    diff = port - jax["test_nll_base"]
    must_beat = jax["test_nll_base"] < jax["unigram_floor_test_base"]
    inside = abs(diff) <= band(tag) and (leg["beats_floor"]
                                         or not must_beat)
    return {"jax_test_nll_base": jax["test_nll_base"],
            "episodes": "jax" if on_jax_episodes else "port",
            "port_minus_jax": round(diff, 4), "band": round(band(tag), 4),
            "jax_beats_floor": must_beat, "inside_band": bool(inside)}


def episode_set_path(sub: str, batch: int) -> Path:
    """JAX's test episodes for a corpus and batch size (the draw depends on
    both): ``quality_episodes/<family>_<kind>_test_b<batch>.npz``."""
    return EPISODE_SETS / f"{sub.replace('/', '_')}_test_b{batch}.npz"


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def corpus_dir(root: Path, sub: str) -> Path:
    """The packed corpus `sub` ("lyrics/plain" ...) under root, built
    offline at the JAX scripts' sizes when it is not there yet."""
    family, kind = sub.split("/")
    out = root / family / kind
    if (out / "corpus.npz").exists():
        return out
    bpe_merges = 0
    if family == "lyrics":
        s = LYRICS_SIZES
        csv = root / family / "lyrics.csv"
        if not csv.exists():
            generate_lyrics_csv(csv, num_artists=s["artists"],
                                songs_per_artist=s["songs"], seed=s["seed"],
                                extra_vocab=s["extra_vocab"])
        if kind == "bpe":
            bpe_merges = s["bpe_merges"]
        build_lyrics_corpus(csv, out, vocab_size=s["vocab_size"], max_len=0,
                            seed=s["seed"], bpe_merges=bpe_merges)
    else:
        s = MIDI_SIZES
        raw = root / family / "raw"
        if not raw.exists():
            generate_midi_corpus(raw, num_artists=s["artists"],
                                 songs_per_artist=s["songs"], seed=s["seed"],
                                 notes_range=s["notes"])
        if kind == "bpe":
            bpe_merges = s["bpe_merges"]
        build_midi_corpus(raw, out, max_len=0, seed=s["seed"],
                          bpe_merges=bpe_merges)
    return out


def snapshot(params):
    """A copy of the parameters: the optimizer updates the live tensors in
    place, so the best-val parameters must not alias them."""
    return copy.deepcopy(params)


def run_leg(tag: str, corpus_path: Path, proto: dict, device=None,
            seed: int = 0, max_steps: int | None = None,
            artifacts: dict | None = None, **cfg_over) -> dict:
    """Train one leg to its early stop (``scale_quality.py`` run_leg).

    proto: max_steps, eval_every, steps_per_call, patience, eval_episodes.
    cfg_over: Config overrides on the flagship defaults; seed: seeds the
    weights and the episode stream; max_steps: the leg's own budget.
    artifacts: if a dict, receives the best-val and the final parameters,
    the config and the corpus on the device."""
    dev = resolve_device(device)
    over = dict(model="lstm", support_mode="mean_state", cell="pallas",
                batch_size=32, support_cache=False,
                cache_backoff="uniform", cache_calib=False,
                cache_dynamic=False, cache_calib_freq=False,
                cache_lm_aux=0.0, compute_dtype="bfloat16")
    over.update(cfg_over)
    budget = max_steps if max_steps is not None else proto["max_steps"]
    corpus = PackedCorpus.load(corpus_path)
    base = dict(embed_dim=256, hidden_dim=512, num_layers=2, support_size=5,
                query_size=5, lr=1e-3)
    base.update(over)
    cfg = Config(vocab_size=len(corpus.vocab), max_len=corpus.max_len,
                 eval_episodes=proto["eval_episodes"], max_steps=budget,
                 data_parallel=False, seed=seed, **base)
    data = eps.put_corpus(corpus, dev)
    split = {s: torch.as_tensor(corpus.splits[s], dtype=torch.int64,
                                device=dev) for s in ("train", "val", "test")}
    ratios = {s: eps.base_token_ratio(corpus, s) for s in ("val", "test")}

    support_cache = over["support_cache"]
    leg = {"vocab": len(corpus.vocab), "max_len": corpus.max_len,
           "model": over["model"],
           "support_mode": over["support_mode"],
           "support_cache": support_cache,
           **({"cache_backoff": over["cache_backoff"],
               "cache_calib": over["cache_calib"],
               "cache_dynamic": over["cache_dynamic"],
               "cache_calib_freq": over["cache_calib_freq"],
               **({"cache_lm_aux": over["cache_lm_aux"]}
                  if over["cache_lm_aux"] else {})}
              if support_cache else {}),
           **({"seed": seed} if seed else {}),
           **({"batch_size": over["batch_size"]}
              if over["batch_size"] != 32 else {}),
           **({"cell": over["cell"]} if over["cell"] != "pallas" else {}),
           **({"inner_steps": cfg.inner_steps, "inner_lr": cfg.inner_lr,
               "max_steps_budget": budget}
              if over["support_mode"] == "finetune" else {}),
           "val_artists": int(split["val"].numel()),
           "test_artists": int(split["test"].numel()),
           "base_token_ratio_val": round(ratios["val"], 4),
           "base_token_ratio_test": round(ratios["test"], 4)}

    def gen(seed_):     # a fresh generator: every eval the same episodes
        return torch.Generator(device=dev).manual_seed(seed_)

    # --- floors: episodic-unigram NLL on held-out artists ---------------
    for name in ("val", "test"):
        floor = evaluate_unigram(cfg, corpus, data, split[name],
                                 gen(FLOOR_SEED),
                                 num_episodes=proto["eval_episodes"])
        leg[f"unigram_floor_{name}"] = round(floor, 4)
        leg[f"unigram_floor_{name}_base"] = round(floor * ratios[name], 4)
    print(json.dumps({tag: leg}), flush=True)

    # --- converged training with early stopping on val NLL --------------
    step_fn = training.make_train_step(cfg, data, split["train"])
    chunk = training.make_multi_step(step_fn, proto["steps_per_call"])
    state = training.init_train_state(cfg, len(corpus.vocab), device=dev)
    state, m = chunk(state)                   # kernel builds outside the clock
    float(m["loss"])
    best = {"val": float("inf"), "step": 0, "params": snapshot(state.params)}
    stale = 0
    done_steps = proto["steps_per_call"]
    t0 = time.perf_counter()
    curve = []
    while done_steps < budget and stale < proto["patience"]:
        target = min(done_steps + proto["eval_every"], budget)
        while done_steps < target:
            state, m = chunk(state)
            done_steps += proto["steps_per_call"]
        val = training.evaluate(cfg, state.params, data, split["val"],
                                gen(VAL_SEED),
                                num_episodes=proto["eval_episodes"])
        curve.append({"step": done_steps, "val_nll": round(val, 4),
                      "train_loss": round(float(m["loss"]), 4)})
        print(json.dumps({tag: curve[-1]}), flush=True)
        if val < best["val"] - IMPROVEMENT:
            best = {"val": val, "step": done_steps,
                    "params": snapshot(state.params)}
            stale = 0
        else:
            stale += 1
    wall = time.perf_counter() - t0
    test = training.evaluate(cfg, best["params"], data, split["test"],
                             gen(TEST_SEED),
                             num_episodes=proto["eval_episodes"])
    leg.update({
        "steps_trained": done_steps,
        "best_val_nll": round(best["val"], 4),
        "best_step": best["step"],
        "test_nll": round(test, 4),
        "test_nll_base": round(test * ratios["test"], 4),
        "beats_floor": bool(test < leg["unigram_floor_test"]),
        "margin_vs_floor_base": round(
            leg["unigram_floor_test_base"] - test * ratios["test"], 4),
        "episodes_per_sec_train_only": round(
            done_steps * cfg.batch_size / wall, 1),
        "wall_sec_incl_eval": round(wall, 1),
        "curve": curve,
    })
    if artifacts is not None:
        artifacts.update(best_params=best["params"], params=state.params,
                         best_step=best["step"], cfg=cfg, data=data)
    return leg


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m fewshot_torch.quality")
    p.add_argument("--legs", required=True,
                   help=f"comma list of leg tags: {', '.join(LEGS)}")
    p.add_argument("--root", default=str(DEFAULT_ROOT),
                   help="where the corpora are built (once) and read, and "
                        "the best-val parameters saved")
    p.add_argument("--out", default=str(DEFAULT_OUT),
                   help="the JSON, merged into leg by leg where it exists")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="Config overrides on top of the leg's, e.g. "
                        "cell=scan prefix_flash=false: the leg on the "
                        "plain route, to tell the kernels from the rest")
    for name in CUTS:
        p.add_argument(f"--{name}", type=int, default=None,
                       help="cut the protocol for a quick run (the leg "
                            "then gets no verdict)")
    args = p.parse_args(argv)
    tags = [t for t in args.legs.split(",") if t]
    unknown = [t for t in tags if t not in LEGS]
    if unknown:
        raise SystemExit(f"unknown legs {unknown}; known: {', '.join(LEGS)}")
    resolve_device(args.device)
    out = Path(args.out)
    result = json.loads(out.read_text()) if out.exists() else {}
    result["protocol"] = {
        "model": "per leg (default lstm E=256 H=512 L=2 bf16 cell=pallas "
                 "mean_state; tfm legs: transformer E=256 L=2 nh=2 "
                 "prefix attention mean_state)",
        "batch": "B=32 K=5 Q=5 (finetune legs B=16)",
        "protocols": PROTOCOLS,
        "nll_units": "per token; *_base fields are per base token (BPE "
                     "rescaled by the split's compression ratio)",
        "floor": "episodic Dirichlet-posterior unigram on the same held-out "
                 "artists (models/unigram.py)",
        "jax_episodes": "the test NLL at the best-val parameters on the "
                        "JAX package's own test episodes "
                        "(quality_episodes/*.npz)",
        "band": "inside when |port - JAX| <= max(0.02, 2 x the JAX seed "
                "pair's half-range), on JAX's test episodes where the set "
                "is there, and the floor is beaten wherever JAX beat it"}
    for key in ("cards", "verdicts", "overrides", "cuts", "jax_episodes"):
        result.setdefault(key, {})
    extra = parse_overrides(args.set)
    cut = {k: getattr(args, k) for k in CUTS if getattr(args, k) is not None}
    root = Path(args.root)
    for tag in tags:
        sub, over = LEGS[tag]
        over = {**over, **extra}
        if "max_steps" in cut:              # the flag beats a leg's budget
            over.pop("max_steps", None)
        proto = {**PROTOCOLS[sub.split("/")[0]], **cut}
        art = {}
        leg = run_leg(tag, corpus_dir(root, sub), proto, device=args.device,
                      artifacts=art, **over)
        best = root / "best" / f"{tag}.pt"
        best.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.detach().cpu() for k, v in
                    art["best_params"].named_parameters()}, best)
        on_jax = None
        path = episode_set_path(sub, art["cfg"].batch_size)
        if path.exists():
            ids, arts, k, q = eps.load_episode_set(path)
            nll = training.evaluate_episode_set(
                art["cfg"], art["best_params"], art["data"], ids, arts, k, q)
            on_jax = {"episodes": len(ids), "test_nll": round(nll, 4),
                      "test_nll_base": round(
                          nll * leg["base_token_ratio_test"], 4)}
        result[tag] = leg
        result["cards"][tag] = card_line()
        result["overrides"][tag] = args.set
        result["cuts"][tag] = cut
        result["jax_episodes"][tag] = on_jax
        result["verdicts"][tag] = (
            {"jax_test_nll_base": None, "withheld": "protocol cut"} if cut
            else verdict(tag, leg, on_jax))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1))
        print(json.dumps({tag: {k: leg[k] for k in (
            "test_nll", "test_nll_base", "unigram_floor_test_base",
            "best_step", "steps_trained", "episodes_per_sec_train_only",
            "wall_sec_incl_eval")}, "jax_episodes": on_jax,
            "verdict": result["verdicts"][tag],
            "card": result["cards"][tag]}), flush=True)


if __name__ == "__main__":
    main()
