#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into the PyTorch port's layout.

    python orbax_to_torch.py --src CKPT_DIR --out TORCH_DIR [--step N]
        [--seed SEED]

CKPT_DIR is a ``--checkpt_dir`` written by ``fewshot.utils.ckpt.
save_checkpoint`` (orbax ``StandardSave`` of the ``TrainState`` as a dict:
params, opt_state, step, key; ``meta.json`` beside the steps).  The step
(the latest unless ``--step``) is read back as numpy and written by
``fewshot_torch.utils.ckpt.save_checkpoint`` into TORCH_DIR/<step>/:
``params.npz`` through ``fewshot_torch.bridge``, ``opt.npz`` (the Adam
count and moments: optax's ``ScaleByAdamState`` is the port's layout
already), ``step.json``, and ``meta.json`` (the vocab hash and the
semantic hyperparameters, the JAX file's own values).  A resumed port run
(``python -m fewshot_torch.cli train --checkpt_dir TORCH_DIR ...``) then
continues from these parameters and moments.

JAX's PRNG key cannot become a torch generator state, so ``rng.npz`` holds
a seed, ``SEED + step`` (``--seed``: the run's config seed, 0 by default),
and the port seeds its episode generator from it on restore (each rank of
several processes with its own seed of it, ``mesh.rank_seed``): the
resumed run draws other episodes than the JAX run would have, by design.

This script imports JAX and orbax (it is the one place where the two
packages meet), so it runs where JAX is installed, e.g. on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def read_orbax_step(src: Path, step: int | None = None):
    """(step, the saved TrainState dict as numpy trees) of an orbax
    checkpoint directory."""
    import jax
    import orbax.checkpoint as ocp
    steps = sorted(int(p.name) for p in src.iterdir()
                   if p.is_dir() and p.name.isdigit())
    if not steps:
        raise FileNotFoundError(f"no orbax steps in {src}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"step {step} not in {src}: {steps}")
    tree = ocp.StandardCheckpointer().restore(
        (src / str(step) / "default").absolute())
    return step, jax.tree.map(np.asarray, tree)


def find_adam(opt_state):
    """optax's ScaleByAdamState (restored as a dict with count, mu and nu)
    inside the optimizer chain's state, or None."""
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        nodes = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        nodes = opt_state
    else:
        return None
    for node in nodes:
        found = find_adam(node)
        if found is not None:
            return found
    return None


def convert(src: Path, out: Path, step: int | None = None,
            seed: int = 0) -> Path:
    """Write the port's checkpoint of src's step under out; returns the
    step's directory."""
    import torch
    from fewshot_torch import bridge
    from fewshot_torch.utils import ckpt

    step, tree = read_orbax_step(src, step)
    params = bridge.params_from_numpy(tree["params"], "cpu")
    adam = find_adam(tree["opt_state"])
    if adam is None:
        raise ValueError(f"{src}/{step} holds no Adam state: the converter "
                         f"takes checkpoints of optimizer: adam")
    opt = bridge.adam_state_from_numpy(adam["count"], adam["mu"],
                                       adam["nu"], "cpu")
    if int(tree["step"]) != step:
        raise ValueError(f"{src}/{step} holds step {int(tree['step'])}")
    meta_path = src / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    state = SimpleNamespace(params=params, opt_state=opt, step=step,
                            gen=torch.Generator())
    final = ckpt.save_checkpoint(out, state, meta.get("vocab_hash", ""),
                                 hparams=meta.get("hparams"))
    # the seed in place of the generator state (module docstring)
    np.savez(final / "rng.npz", seed=np.int64(seed + step))
    return final


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True,
                   help="the JAX package's --checkpt_dir")
    p.add_argument("--out", required=True,
                   help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, default=None,
                   help="the step to convert (default: the latest)")
    p.add_argument("--seed", type=int, default=0,
                   help="the run's config seed; the port's episode "
                        "generator is seeded with seed + step")
    args = p.parse_args(argv)
    final = convert(Path(args.src), Path(args.out), args.step, args.seed)
    print(f"wrote {final}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
