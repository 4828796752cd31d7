"""A cell, found by name: its configuration, traffic mix, limits and
metrics, each in a file of its own under ``portbench/``.

  BENCHMARK.json              the cells and the metrics, by name
  configs/<config>.json       the model's sizes and recipe ("program"),
                              its source, reductions and the corpus recipe
  backbones/<model>.py        the configuration's "model": its weight
  reference/backbones/<model>.py  leaves, the program's objects and FLOPs;
                              the reference's hidden states
  traffic/<traffic>.json      the mix: its "kind" names the generator in
                              kinds/<kind>.py, the rest are its parameters
  limits/<workload>.json      the limit of each number compared
  metrics/<metric>.py         the reader of each per-layer metric
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<workload>.json
    end_to_end: list        # BENCHMARK.json entries that this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, benchmark: Path | None = None) -> Cell:
    bench = load_json(benchmark or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` of metrics/<metric>.py (a file name may hold
    dots, so it is loaded by path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _module(package: str, name: str, files: list):
    """portbench.<package>.<name>, where every file of `files` (paths
    under portbench/ that the name needs) is there."""
    if not (re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name)
            and all((HERE / f).is_file() for f in files)):
        raise ValueError(f"no module for {name!r}: it needs "
                         + " and ".join(f"portbench/{f}" for f in files))
    return importlib.import_module(f"portbench.{package}.{name}")


def backbone(model: str, reference: bool = False):
    """The module of a configuration's "model": backbones/<model>.py, the
    program's side, or with `reference` reference/backbones/<model>.py.
    Each side needs the other."""
    files = [f"backbones/{model}.py", f"reference/backbones/{model}.py"]
    return _module("reference.backbones" if reference else "backbones",
                   model, files)


def kind(name: str):
    """The module of a traffic mix's "kind": kinds/<name>.py."""
    return _module("kinds", name, [f"kinds/{name}.py"])
