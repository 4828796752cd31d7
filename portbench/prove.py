"""Readings that set a cell's limits: the program's numbers over many seeds,
the control's (the reference in float8, the precision below the
configuration's bfloat16), and faults planted in the reference put in the
program's place: for training half of the batch left out, for sampling
the cache branch left out and the cache's counts kept static.

    python3 -m portbench.prove --workload <name> --seeds 12 --controls 3
        [--first-seed N] [--out prove.json]

Training needs no window: each seed runs set-up and the first steps, as a
run does.  Sampling runs `--calls` calls at the cell's load, enough for the
check's rows.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

RUN_KEYS = {"program", "control", "seed", "seconds"}   # the rest: faults


def readings(cell, seed: int, control: bool, device, corpus_root,
             calls: int = 2) -> dict:
    """The numbers of one seed, by the ``readings`` of the cell's kind
    (kinds/<kind>.py): "program", and with control also "control" and the
    kind's faults."""
    from portbench import cells
    return cells.kind(cell.traffic["kind"]).readings(
        cell, seed, control, device, corpus_root, calls)


def summary(runs: list, limits: dict) -> dict:
    out = {}
    for name in sorted(set(limits) | {
            "loss_rel", "loss1_rel", "grad_rel", "change_rel",
            "grad_diff_rel", "change_diff_rel", "served_gap"}):
        if name not in runs[0]["program"]:
            continue
        prog = [r["program"][name] for r in runs]
        ctl = [r["control"][name] for r in runs if "control" in r]
        out[name] = {"program_max": max(prog), "control_min":
                     min(ctl) if ctl else None, "limit": limits.get(name)}
        for fault in sorted({k for r in runs for k in r} - RUN_KEYS):
            got = [r[fault][name] for r in runs if name in r.get(fault, {})]
            if got:
                out[name][fault + "_min"] = min(got)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.prove")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench.run import cache_dirs, power_limit
    cache_dirs()
    import torch
    from portbench import cells, inputs
    if not torch.cuda.is_available():
        print("portbench.prove: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    runs = []
    for i in range(args.seeds):
        seed = args.first_seed + 7_777_777 * i
        t0 = time.perf_counter()
        rec = readings(cell, seed, i < args.controls, "cuda:0",
                       inputs.CORPUS_ROOT, args.calls)
        rec.update(seed=seed, seconds=time.perf_counter() - t0)
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    res = {"workload": args.workload, "card": power_limit(),
           "device": torch.cuda.get_device_name(0), "runs": runs,
           "summary": summary(runs, cell.limits)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
