"""Shared fixtures of the harness's tests: a tiny corpus and tiny sizes,
so that every cell runs end to end on the CPU through the program's plain
route (its kernels' twins)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CORPUS = {"name": "tiny", "artists": 12, "songs": 12, "extra_vocab": 0,
               "vocab_size": 5000, "max_len": 24, "seed": 0}
# the recurrence kernels' route takes H % 128 == 0; the heads stay 2; the
# tiny LSTM's head is narrower, so its embedding spreads wider for its
# greedy rows to follow the backbone (as the cell's do at full width); at
# the tiny sizes the cache gates open wider, for the cache branch to weigh
# in the greedy rows as much as it does at full width
TINY_CONFIG = {
    "lstm": {"embed_dim": 16, "hidden_dim": 128, "batch_size": 4,
             "support_size": 2, "query_size": 2, "corpus": TINY_CORPUS,
             "init": {"gate_b": 0.0, "embed_std": 3.0}},
    "transformer": {"embed_dim": 32, "num_layers": 2, "batch_size": 4,
                    "support_size": 2, "query_size": 2,
                    "corpus": TINY_CORPUS,
                    "init": {"gate_b": -2.0, "embed_std": 0.1, "eos_b": -30.0,
                             "gain": {"w2": 3.0, "wqkv": 2.0}}}}
TINY_TRAFFIC = {
    "train": {"steps_per_call": 2, "check_steps": 3, "trace_calls": 1},
    "sample": {"jobs": 4, "continuations": 2, "tokens": 12, "check_rows": 8,
               "trace_calls": 1}}


def workloads() -> list:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def shrink(workload: str, **config) -> dict:
    from portbench import cells
    cell = cells.load(workload)
    return {"config": dict(TINY_CONFIG[cell.config["model"]], **config),
            "traffic": TINY_TRAFFIC[cell.traffic["kind"]]}


@pytest.fixture(scope="session")
def corpus_root(tmp_path_factory):
    return tmp_path_factory.mktemp("corpora")


@pytest.fixture
def run_tiny(corpus_root, capsys):
    """run_tiny(workload, trace=0, seed=..., **config) -> (rc, the result
    line's object or None, standard error)."""
    from portbench import run

    def go(workload, trace=0, seed=31_415_926_535, **config):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.5", "--trace", str(trace)],
                      device="cpu", corpus_root=corpus_root,
                      shrink=shrink(workload, **config))
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err
    return go


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
