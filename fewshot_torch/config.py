"""Experiment configuration: 3-file YAML merge + validated dataclass.

Port of ``fewshot/config.py``.  The dataclass, its validation and the
``--data/--model/--task/--set`` surface are the same, so one set of YAML
files drives both packages.  The config files are flat mappings of plain
scalars, which the port reads itself (``_load_yaml``): the card machine
has no PyYAML.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any


@dataclasses.dataclass(frozen=True)
class Config:
    """The same fields, defaults and checks as ``fewshot.config.Config``.

    Fields that only later slices of the port read (transformer, cache
    head, finetune, training) are kept so a YAML file loads identically."""
    # ---- data (configs/data/*.yaml) ----
    dataset: str = "lyrics"          # lyrics | midi
    corpus_dir: str = "data/lyrics"  # dir holding corpus.npz (+ vocab.json)
    vocab_size: int = 5000           # cap on learned vocab (incl. specials)
    max_len: int = 256               # per-song token budget (pad/truncate)

    # ---- model (configs/model/*.yaml) ----
    model: str = "lstm"              # lstm | transformer | moonlight
    embed_dim: int = 256
    hidden_dim: int = 512
    num_layers: int = 1
    dropout: float = 0.0
    support_mode: str = "state"      # none | state | mean_state | finetune
    support_cache: bool = False      # neural-cache head
    cache_backoff: str = "global"    # global | uniform
    cache_calib: bool = False
    cache_calib_freq: bool = False
    cache_dynamic: bool = False
    cache_lm_aux: float = 0.0
    cache_resp_floor: float = 0.0
    inner_steps: int = 3             # finetune: SGD steps on the support set
    inner_lr: float = 0.1            # finetune: inner-loop learning rate
    first_order: bool = True         # finetune: FOMAML
    cell: str = "scan"               # scan | pallas (LSTM recurrence impl;
                                     # "pallas" selects the CUDA kernels)
    compute_dtype: str = "float32"   # float32 | bfloat16 (matmul dtype)
    tie_embeddings: bool = True
    # transformer-only
    num_heads: int = 2
    mlp_ratio: int = 4
    remat: bool = False
    flash: bool = False
    prefix_flash: bool = True

    # ---- task (configs/task/*.yaml) ----
    task: str = "episodic"           # lm | episodic
    batch_size: int = 16             # episodes per step
    support_size: int = 5            # K songs conditioned on
    query_size: int = 5              # Q songs scored
    max_steps: int = 2000
    lr: float = 1e-3
    optimizer: str = "adam"          # adam | sgd
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 0
    eval_interval: int = 200
    eval_episodes: int = 64
    checkpoint_interval: int = 500
    log_interval: int = 20
    steps_per_call: int = 1
    seed: int = 0
    data_parallel: bool = True
    pipeline: str = "device"         # device | host

    # ---- sampling (sample entry point) ----
    sample_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 40                  # 0 = full ancestral
    top_p: float = 0.0               # nucleus sampling; 0 disables
    grammar_sampling: bool = True    # midi: enforce SHIFT/PITCH/DUR/VEL cycle

    # -- validation ---------------------------------------------------------

    _CHOICES = {
        "dataset": ("lyrics", "midi"),
        "model": ("lstm", "transformer", "moonlight"),
        "support_mode": ("none", "state", "mean_state", "finetune"),
        "cache_backoff": ("global", "uniform"),
        "cell": ("scan", "pallas"),
        "compute_dtype": ("float32", "bfloat16"),
        "task": ("lm", "episodic"),
        "optimizer": ("adam", "sgd"),
        "pipeline": ("device", "host"),
    }

    def __post_init__(self) -> None:
        for field, choices in self._CHOICES.items():
            val = getattr(self, field)
            if val not in choices:
                raise ValueError(
                    f"config: {field}={val!r} not in {choices}")
        for field in ("vocab_size", "max_len", "embed_dim", "hidden_dim",
                      "num_layers", "batch_size", "support_size",
                      "query_size", "max_steps"):
            if getattr(self, field) <= 0:
                raise ValueError(f"config: {field} must be positive")
        if self.model == "transformer" and self.embed_dim % self.num_heads:
            raise ValueError(
                "config: num_heads must divide embed_dim evenly")
        if self.task == "episodic" and self.query_size < 1:
            raise ValueError("config: episodic task needs query_size >= 1")
        if self.support_cache:
            if self.task != "episodic":
                raise ValueError(
                    "config: support_cache requires task: episodic (it "
                    "mixes in the support-set count posterior)")
        elif self.cache_calib or self.cache_dynamic:
            raise ValueError(
                "config: cache_calib/cache_dynamic require "
                "support_cache: true (they modify the cache posterior)")
        if self.cache_lm_aux < 0:
            raise ValueError("config: cache_lm_aux must be >= 0")
        if self.cache_lm_aux > 0 and not self.support_cache:
            raise ValueError(
                "config: cache_lm_aux requires support_cache: true (it "
                "is the mixture's auxiliary LM-branch loss)")
        if not 0.0 <= self.cache_resp_floor < 1.0:
            raise ValueError(
                "config: cache_resp_floor must be in [0, 1) (it is a "
                "floor on a posterior responsibility)")
        if self.cache_resp_floor > 0 and not self.support_cache:
            raise ValueError(
                "config: cache_resp_floor requires support_cache: true "
                "(it floors the mixture's LM-branch gradient)")
        if self.cache_calib_freq and not (
                self.cache_calib and self.cache_backoff == "global"):
            raise ValueError(
                "config: cache_calib_freq requires cache_calib: true and "
                "cache_backoff: global (the frequency feature is the "
                "learned backoff unigram)")
        if self.steps_per_call > 1:
            for f in ("log_interval", "eval_interval",
                      "checkpoint_interval", "max_steps"):
                v = getattr(self, f)
                if v and v % self.steps_per_call:
                    raise ValueError(
                        f"config: {f} ({v}) must be a multiple of "
                        f"steps_per_call ({self.steps_per_call})")


_FIELDS = {f.name for f in dataclasses.fields(Config)}


_YAML_FLOAT = re.compile(
    r"^[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?$")
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_BOOL = {"true": True, "yes": True, "on": True,
              "false": False, "no": False, "off": False}


def _scalar(text: str) -> Any:
    """One plain YAML 1.1 scalar as PyYAML's safe_load reads it: null,
    bool, a decimal int, a float (with a dot, or .inf/.nan), a quoted or a
    plain string."""
    t = text.strip()
    if t in ("", "~") or t.lower() == "null":
        return None
    if t.lower() in _YAML_BOOL and t in (t.lower(), t.upper(),
                                         t.capitalize()):
        return _YAML_BOOL[t.lower()]
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if _YAML_INT.match(t):
        return int(t.replace("_", ""))
    if _YAML_FLOAT.match(t) and any(c.isdigit() for c in t):
        return float(t.replace("_", ""))
    if t.lower() in (".inf", "+.inf", "-.inf", ".nan"):
        return float(t.replace(".", "", 1))
    return t


def _load_yaml(path: str | Path) -> dict[str, Any]:
    """A config file: a flat YAML mapping of plain scalars (every shipped
    config), read without PyYAML, which the card machine lacks.  Comments
    and blank lines are skipped; anything nested is refused."""
    doc: dict[str, Any] = {}
    for n, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = re.sub(r"(^|\s)#.*$", "", raw).rstrip()
        if not line or line == "---":
            continue
        key, sep, value = line.partition(":")
        if line[0].isspace() or not sep or not key.strip() \
                or line.lstrip().startswith("- "):
            raise ValueError(f"config file {path}:{n}: only a flat mapping "
                             f"of scalars is read, got {raw!r}")
        doc[key.strip()] = _scalar(value)
    return doc


def merge_configs(*dicts: dict[str, Any]) -> Config:
    """Merge config dicts left-to-right (later wins) into a validated Config."""
    merged: dict[str, Any] = {}
    for d in dicts:
        for k, v in d.items():
            if k not in _FIELDS:
                raise ValueError(
                    f"config: unknown key {k!r} (known: {sorted(_FIELDS)})")
            merged[k] = v
    return Config(**merged)


def load_config(data: str | None = None, model: str | None = None,
                task: str | None = None,
                overrides: dict[str, Any] | None = None) -> Config:
    """Load and merge the ``--data/--model/--task`` YAMLs."""
    parts = [_load_yaml(p) for p in (data, model, task) if p]
    if overrides:
        parts.append(overrides)
    return merge_configs(*parts)


def add_config_flags(parser) -> None:
    """Attach the shared CLI surface to an argparse parser."""
    parser.add_argument("--data", type=str, default=None,
                        help="data YAML config")
    parser.add_argument("--model", type=str, default=None,
                        help="model YAML config")
    parser.add_argument("--task", type=str, default=None,
                        help="task YAML config")
    parser.add_argument("--checkpt_dir", type=str, default=None,
                        help="checkpoint directory (one subdirectory per "
                             "saved step, or a bare params.npz)")
    parser.add_argument("--set", nargs="*", default=[], metavar="K=V",
                        help="inline overrides, e.g. --set lr=3e-4 seed=1")


def parse_overrides(pairs: list[str]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects K=V, got {pair!r}")
        k, v = pair.split("=", 1)
        # YAML 1.1 won't parse "3e-4" as a float (needs a dot): try plain
        # numeric coercion first, then a YAML scalar for bool/str/etc.
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = _scalar(v)
    return out
