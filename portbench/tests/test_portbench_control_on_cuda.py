"""On the card: at the cell's widths and fewer rows, the program's sound
runs pass every limit and the fp8 control fails one (the kind's SMALL
mix, kinds/<kind>.py).  Run with
``python3 -m pytest portbench/tests -k on_cuda``."""

import pytest

from conftest import workloads


@pytest.mark.parametrize("workload", workloads())
def test_control_fails_and_program_passes_on_cuda(cuda_device, workload):
    from portbench import cells, inputs, prove
    cell = cells.load(workload)
    cell.traffic.update(cells.kind(cell.traffic["kind"]).SMALL)
    rec = prove.readings(cell, 2_718_281_828, True, cuda_device,
                         inputs.CORPUS_ROOT, calls=2)
    lim = cell.limits
    assert all(rec["program"][k] <= v for k, v in lim.items()), rec
    assert any(rec["control"][k] > v for k, v in lim.items()), rec
