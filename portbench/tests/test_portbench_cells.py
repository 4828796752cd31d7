"""Every cell of BENCHMARK.json runs end to end at a tiny size on the CPU
and prints the contract's result line."""

import json

import pytest

from conftest import ROOT, workloads

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", workloads())
def test_cell_prints_the_result_line(run_tiny, workload, trace):
    rc, res, err = run_tiny(workload, trace)
    assert rc == 0, err
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert res["attempted"] > 0 and res["failed"] == 0
    dev = res["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] >= 0
    for name, check in res["checks"].items():
        assert set(check) == {"value", "limit"}
        assert f"check {name}: " in err
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in BENCH["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(res["metrics"]) == want
        for m in res["metrics"].values():
            assert m["value"] > 0


def test_cells_name_their_files():
    """Each cell's configuration, traffic mix, limits and metric readers
    are found by name."""
    from portbench import cells
    for w in workloads():
        cell = cells.load(w)
        kind = cells.kind(cell.traffic["kind"])
        assert cell.limits and callable(kind.run) and \
            callable(kind.readings) and isinstance(kind.TINY, dict)
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))


def test_no_cpu_fallback_without_a_card(monkeypatch, capsys):
    """Without the cell's cards a run exits 2 and prints no result."""
    import torch
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", workloads()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc == 2 and out == ""
