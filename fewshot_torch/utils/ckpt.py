"""Checkpoint / resume: parameters, Adam state, step and the sampler's
generator state, one directory per step.

Port of ``fewshot/utils/ckpt.py`` without orbax.  ``<ckpt_dir>/<step>/``
holds ``params.npz`` (the bridge's file: ``bridge.save_params``),
``opt.npz`` (the optimizer's update count and Adam moments in optax's
layout, ``bridge.adam_state_to_numpy``), ``rng.npz`` (the state of the
``torch.Generator`` the device episode sampler draws from, so that a
resumed run draws the episodes an unbroken run would) and ``step.json``.
``<ckpt_dir>/meta.json`` holds the vocab's content hash, which a restore
against another vocab refuses, and the ``SEMANTIC_HPARAMS``, which a
restore under other values warns about.  A step is written under a
temporary name and renamed into place, so a killed save leaves no
half-written step; the newest ``max_to_keep`` steps are kept.  Saves are
synchronous: nothing is left in flight at exit.

Under a data mesh of W > 1 processes, ``rng.npz`` holds every rank's
generator state (``gens``, row r for rank r): rank 0 gathers them and does
every write while the other ranks wait at a barrier, and a restore under
another world size raises.  A world of one writes the single-process file
(``gen``).  A file holding ``seed`` in place of a state (written by
``orbax_to_torch.py``, which cannot carry JAX's key over) seeds each
rank's generator on restore with the rank's seed of it (``rank_seed``).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from fewshot_torch import bridge
from fewshot_torch.parallel.mesh import (barrier, gather_objects, rank_seed,
                                        world_of)

# Hyperparameters whose value changes the model's function without changing
# any parameter shape (num_heads splits the same fused [E, 3E] QKV
# differently): stored in meta.json at save, compared (warn, not fail) at
# restore.  The JAX package's names, so that both packages record the same.
SEMANTIC_HPARAMS = ("model", "num_heads", "support_mode", "cell",
                    "tie_embeddings", "dataset", "support_cache",
                    "cache_backoff", "cache_calib", "cache_calib_freq",
                    "cache_dynamic")
MAX_TO_KEEP = 3


def hparams_of(cfg) -> dict:
    """The semantics-bearing hyperparams of a Config, for checkpoint meta."""
    return {k: getattr(cfg, k) for k in SEMANTIC_HPARAMS if hasattr(cfg, k)}


def steps(ckpt_dir: str | Path) -> list[int]:
    """The saved steps in ckpt_dir, oldest first."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.is_dir() and p.name.isdigit())


def latest_step(ckpt_dir: str | Path) -> int | None:
    found = steps(ckpt_dir)
    return found[-1] if found else None


def _write_json(path: Path, obj) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str | Path, state, vocab_hash: str = "",
                    hparams: dict | None = None,
                    max_to_keep: int = MAX_TO_KEEP, mesh=None) -> Path:
    """Write state (a ``training.TrainState``) as ``<ckpt_dir>/<step>/``
    and prune all but the newest max_to_keep steps.  Returns the step's
    directory.  Every rank of `mesh` calls it; rank 0 writes."""
    gens = gather_objects(state.gen.get_state().numpy(), mesh)
    final = Path(ckpt_dir) / str(int(state.step))
    if mesh is None or mesh.rank == 0:
        _write_step(Path(ckpt_dir), state, vocab_hash, hparams, max_to_keep,
                    gens)
    barrier(mesh)
    return final


def _write_step(d: Path, state, vocab_hash: str, hparams: dict | None,
                max_to_keep: int, gens: list) -> None:
    d.mkdir(parents=True, exist_ok=True)
    meta = {"vocab_hash": vocab_hash}
    if hparams:
        meta["hparams"] = hparams
    _write_json(d / "meta.json", meta)
    step = int(state.step)
    tmp = d / f".{step}.{os.getpid()}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    bridge.save_params(state.params, tmp / "params.npz")
    count, mu, nu = bridge.adam_state_to_numpy(state.opt_state)
    np.savez(tmp / "opt.npz", count=count,
             **{f"mu:{k}": v for k, v in bridge.flatten(mu).items()},
             **{f"nu:{k}": v for k, v in bridge.flatten(nu).items()})
    if len(gens) == 1:
        np.savez(tmp / "rng.npz", gen=gens[0])
    else:
        np.savez(tmp / "rng.npz", gens=np.stack(gens))
    (tmp / "step.json").write_text(json.dumps({"step": step}))
    final = d / str(step)
    if final.exists():              # the same step saved again
        old = d / f".{step}.{os.getpid()}.old"
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    for s in steps(d)[:-max_to_keep]:
        shutil.rmtree(d / str(s))


def _check_meta(d: Path, vocab_hash: str, hparams: dict | None) -> None:
    """Refuse another vocab; warn about other semantic hyperparameters."""
    meta_path = d / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    if vocab_hash:
        stored = meta.get("vocab_hash", "")
        if stored and stored != vocab_hash:
            raise ValueError(
                f"checkpoint {d} was trained with a different vocab "
                f"(hash {stored} != {vocab_hash})")
    if hparams and meta.get("hparams"):
        for k, saved in meta["hparams"].items():
            if k in hparams and hparams[k] != saved:
                # shape-compatible changes the restore cannot catch: the
                # parameters load and compute a different function
                print(f"warning: checkpoint {d} was trained with "
                      f"{k}={saved!r} but the config says "
                      f"{k}={hparams[k]!r} — outputs will differ; pin --set "
                      f"{k}={saved} to match the checkpoint", flush=True)


def _restore_generator(path: Path, gen: torch.Generator, mesh) -> None:
    """Set gen to this rank's state in rng.npz, or seed it with the rank's
    seed of the file's (``mesh.rank_seed``: the ranks draw different
    episodes, and a world of one takes the seed itself)."""
    world = world_of(mesh)
    with np.load(path) as z:
        if "seed" in z.files:
            gen.manual_seed(rank_seed(int(z["seed"]), mesh))
            return
        saved = len(z["gens"]) if "gens" in z.files else 1
        if saved != world:
            raise ValueError(
                f"checkpoint {path.parent} was written by {saved} "
                f"process(es) and this run has {world}: the episode "
                f"generators cannot be split anew; resume with "
                f"FEWSHOT_NUM_PROCESSES={saved}")
        state = z["gens"][mesh.rank] if world > 1 else z["gen"]
    gen.set_state(torch.from_numpy(state.copy()))


def recover_or_init(ckpt_dir: str | Path | None, init_state,
                    vocab_hash: str = "", hparams: dict | None = None,
                    mesh=None):
    """Restore the latest checkpoint if there is one, else the given init
    state (its parameters' device and its generator are kept).  Under
    `mesh`, the rank's generator state.  Returns (state, restored)."""
    if ckpt_dir is None:
        return init_state, False
    d = Path(ckpt_dir)
    latest = latest_step(d)
    if latest is None:
        return init_state, False
    _check_meta(d, vocab_hash, hparams)
    src = d / str(latest)
    dev = init_state.opt_state.count.device
    params = bridge.load_params(src / "params.npz", dev)
    want = {k: tuple(p.shape) for k, p in
            init_state.params.named_parameters()}
    got = {k: tuple(p.shape) for k, p in params.named_parameters()}
    if got != want:
        raise ValueError(f"checkpoint {src} does not fit the config's "
                         f"parameters: {got} != {want}")
    with np.load(src / "opt.npz") as z:
        mu = bridge.unflatten({k[3:]: z[k] for k in z.files
                               if k.startswith("mu:")})
        nu = bridge.unflatten({k[3:]: z[k] for k in z.files
                               if k.startswith("nu:")})
        opt = bridge.adam_state_from_numpy(z["count"], mu, nu, dev)
    _restore_generator(src / "rng.npz", init_state.gen, mesh)
    step = json.loads((src / "step.json").read_text())["step"]
    return init_state._replace(params=params, opt_state=opt,
                               step=step), True


def restore_params(ckpt_dir: str | Path, device, vocab_hash: str = "",
                   hparams: dict | None = None):
    """The parameters to serve from ckpt_dir: its latest step's, or a bare
    ``params.npz`` directory's; None where it holds neither.  The vocab
    and hyperparameter checks of ``recover_or_init`` apply."""
    d = Path(ckpt_dir)
    latest = latest_step(d)
    path = (d / str(latest) / "params.npz" if latest is not None
            else d / "params.npz")
    if not path.exists():
        return None
    _check_meta(d, vocab_hash, hparams)
    return bridge.load_params(path, device)
