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

# every cell runs on this corpus, at its backbone's TINY sizes
# (backbones/<model>.py) and its kind's TINY mix (kinds/<kind>.py)
TINY_CORPUS = {"name": "tiny", "artists": 12, "songs": 12, "extra_vocab": 0,
               "vocab_size": 5000, "max_len": 24, "seed": 0}


def workloads() -> list:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def shrink(workload: str, **config) -> dict:
    from portbench import cells
    cell = cells.load(workload)
    tiny = cells.backbone(cell.config["model"]).TINY
    return {"config": dict(tiny, corpus=TINY_CORPUS, **config),
            "traffic": cells.kind(cell.traffic["kind"]).TINY}


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
