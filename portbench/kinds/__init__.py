"""Traffic generators, one module per "kind" of traffic/<mix>.json, found
by that name (``cells.kind``).  A module gives:

  run(cell, seed, seconds, trace, device, corpus_root, t_start)
          one run: set-up, the window (or the traced calls), the check;
          returns what ``run.py`` prints
  readings(cell, seed, control, device, corpus_root, calls)
          the numbers of one seed for ``portbench.prove``: "program",
          with control also "control" and the kind's faults
  TINY    the CPU tests' tiny mix (``tests/conftest.py``)
  SMALL   the on-card control test's mix (``test_portbench_control_on_cuda``)
"""
