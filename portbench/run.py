"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards.  Set-up
(the corpus, built once into portbench/data/, the weights from the seed,
the program's kernels, the warm-up) is timed from the start of the
process; then the window runs for --seconds (--trace 0: the end-to-end
metrics) or a few calls run under torch.profiler, once with device
activity alone and once with host operations too (--trace 1: the
per-layer metrics from the first, the breakdown's idle gaps from the
second); then the reference checks what the timed path produced.  The
last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key.  Exit codes: 0 with a result; 2 without the cards the
cell needs; 3 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fewshot")
NAME_CHARS = 96     # of an operation's name in the breakdown


def forbidden(names) -> list:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name (``fewshot_torch`` is not ``fewshot``)."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's
    nvcc builds go to its own .torch_ext/ there)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(HERE / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, corpus_root=None, shrink=None,
         t_start: float = T_START) -> int:
    """The run.  device, corpus_root and shrink (overrides of the cell's
    "config" and "traffic" entries) are for the CPU tests; a run without
    them needs the cell's cards."""
    args = parse(argv)
    cache_dirs()
    import torch
    from portbench import cells, inputs
    from portbench.reference.check import judge
    cell = cells.load(args.workload)
    if shrink:
        cell.config.update(shrink.get("config", {}))
        cell.traffic.update(shrink.get("traffic", {}))
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s); this machine has {have}", file=sys.stderr)
            return 2
        device = "cuda:0"
    kind = cells.kind(cell.traffic["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), device,
                   corpus_root or inputs.CORPUS_ROOT, t_start)
    correct, checks = judge(out["numbers"], cell.limits)
    correct = correct and out["failed"] == 0
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        ctx = out["ctx"]
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        result["metrics"] = metrics
        result["device"] = dev
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in
                           ctx["trace"].top_device_ops()],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in
                          ctx["host_trace"].idle_gaps()]}
    else:
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["card"] = power_limit() if cuda else None
    result["numbers"] = {k: v for k, v in out["numbers"].items()
                         if k not in checks}
    result["checks"] = checks
    bad = forbidden(sys.modules)
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
