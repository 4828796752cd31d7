"""A new architecture comes in as new files only: a backbone that no
accepted file names (here the transformer's two modules under another
name), its configuration, a cell and its limits, and the cell appended
to the metrics' lists in BENCHMARK.json.  Staged in a copy of the
checkout, it runs end to end at the tiny size through ``run.main``."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT

TWIN = "transformer_twin"
CONFIG, CELL, LIKE = "twin_cache", "twin_cache.sample", "tfm_cache.sample"

# runs each (workload, trace) in the staged checkout; prints the backbone
# modules loaded after the first workload's runs, [rc, result line] of each
# run, and each workload's FLOPs of a train step and a sampling call
SCRIPT = """
import contextlib, io, json, sys
import numpy as np
checkout, corpus_root, runs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, checkout + "/portbench/tests")
from conftest import shrink
import portbench
from portbench import cells, run
from portbench.counts import flops
assert portbench.__file__.startswith(checkout), portbench.__file__
out, loaded = [], None
for workload, trace in runs:
    if workload != runs[0][0] and loaded is None:
        loaded = sorted(m for m in sys.modules if ".backbones." in m)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", "27182818284",
                       "--seconds", "0.5", "--trace", str(trace)],
                      device="cpu", corpus_root=corpus_root,
                      shrink=shrink(workload))
    lines = buf.getvalue().strip().splitlines()
    out.append([rc, json.loads(lines[-1]) if lines else None])
sl, ql = np.array([[5, 9], [3, 1]]), np.array([[4, 6], [2, 8]])
counts = {}
for workload, _ in runs:
    spec = dict(cells.load(workload).config, max_len=10)
    counts[workload] = [int(flops.train_step(spec, 50, sl, ql)),
                        int(flops.sample_call(spec, 50, sl, ql[:, 0]))]
print(json.dumps({"loaded": loaded, "runs": out, "flops": counts}))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _stage(checkout):
    """The checkout's BENCHMARK.json and portbench/, with the new files
    and entries that a configuration of a new backbone brings."""
    skip = shutil.ignore_patterns("data", ".cache", "__pycache__")
    shutil.copytree(ROOT / "portbench", checkout / "portbench", ignore=skip)
    pb = checkout / "portbench"
    for side in ("backbones", "reference/backbones"):
        shutil.copy(pb / side / "transformer.py", pb / side / f"{TWIN}.py")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    like = next(w for w in bench["workloads"] if w["name"] == LIKE)
    like_cfg = next(c for c in bench["configs"]
                    if c["name"] == like["config"])
    cfg = json.loads((ROOT / like_cfg["file"]).read_text())
    cfg.update(name=CONFIG, model=TWIN)
    (pb / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "limits" / f"{LIKE}.json", pb / "limits" / f"{CELL}.json")
    bench["configs"].append(dict(like_cfg, name=CONFIG,
                                 file=f"portbench/configs/{CONFIG}.json"))
    bench["workloads"].append(dict(like, name=CELL, config=CONFIG))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LIKE in m.get("workloads", []):
            m["workloads"].append(CELL)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_backbone_is_new_files_only(tmp_path, corpus_root):
    checkout = tmp_path / "checkout"
    _stage(checkout)
    before = _digests(ROOT / "portbench")
    after = _digests(checkout / "portbench")
    kept = {p: d for p, d in before.items() if p.parts[0] not in
            ("data", ".cache") and "__pycache__" not in p.parts}
    assert {p: after[p] for p in kept} == kept      # no file edited
    assert set(after) - set(kept) == {Path(f) for f in (
        f"backbones/{TWIN}.py", f"reference/backbones/{TWIN}.py",
        f"configs/{CONFIG}.json", f"limits/{CELL}.json")}

    runs = [[CELL, 0], [CELL, 1], [LIKE, 1]]
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(checkout), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(checkout), str(corpus_root),
         json.dumps(runs)], cwd=checkout, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded, results = got["loaded"], got["runs"]
    assert f"portbench.backbones.{TWIN}" in loaded
    assert f"portbench.reference.backbones.{TWIN}" in loaded
    assert "portbench.backbones.transformer" not in loaded
    (rc0, twin0), (rc1, twin1), (rc2, like1) = results
    assert rc0 == rc1 == rc2 == 0, proc.stderr[-4000:]
    assert set(twin0["metrics"]) == {"sample_tokens_per_s", "setup_s"}
    assert twin0["attempted"] > 0 and twin0["failed"] == 0
    # the same backbone under another name: the same FLOPs and, at the
    # traced run's fixed work, the same numbers compared
    assert got["flops"][CELL] == got["flops"][LIKE]
    assert twin1["checks"] == like1["checks"]
    assert twin1["numbers"] == like1["numbers"]
    assert twin1["correct"] == like1["correct"]


@pytest.mark.parametrize("reference", [False, True])
def test_an_unknown_backbone_names_both_files(reference):
    from portbench import cells
    with pytest.raises(ValueError, match=r"portbench/backbones/mamba\.py "
                       r"and portbench/reference/backbones/mamba\.py"):
        cells.backbone("mamba", reference=reference)


def test_an_unknown_kind_names_its_file():
    from portbench import cells
    with pytest.raises(ValueError, match=r"portbench/kinds/stream\.py"):
        cells.kind("stream")
