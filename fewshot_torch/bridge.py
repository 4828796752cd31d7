"""Parameters and optimizer state between the JAX trees (as numpy arrays)
and the port, and the port's checkpoint file.

The JAX package's parameter tree (``fewshot/models/lm.py`` init_lm) is
``embed``, the backbone (``lstm[l].{wx, wh, b}`` or
``transformer.{layers[l].{ln1, wqkv, wo, ln2, w1, w2}, ln_f}``),
``out_proj`` or ``out_w``, ``out_b`` and, with the cache head,
``cache_gate.{w, b}``, ``cache_prior.{u, log_s}`` and ``cache_calib.{t,
a}`` (``b`` and ``log_s`` are 0-d).  The port keeps the same layouts (wx
[in, 4H], wqkv [E, 3E] ...), so conversion copies arrays and transposes
nothing.  The port names a tensor by its flat path (``lstm.0.wx``,
``transformer.layers.0.wqkv``, ``cache_gate.b``: the module's parameter
name); ``params.npz`` holds the arrays under those names and is what
``--checkpt_dir`` points at.

optax's ``ScaleByAdamState`` (count, mu, nu; mu and nu are trees shaped like
the parameters) converts to the port's ``training.OptState`` and back, so a
run can continue from the other package's state.  The port keeps one count
for the bias correction and the learning-rate schedule; optax's schedule
state counts the same updates.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from fewshot_torch.device import resolve_device
from fewshot_torch.models.lm import LM
from fewshot_torch.models.lstm import LSTMLayer
from fewshot_torch.models.transformer import Transformer, TransformerLayer

_HEAD = ("out_proj", "out_w")
_CACHE = ("cache_gate", "cache_prior", "cache_calib")
_TOP = {"embed", "lstm", "transformer", "out_b", *_HEAD, *_CACHE}
_TFM_LAYER = ("ln1", "wqkv", "wo", "ln2", "w1", "w2")


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def params_from_numpy(tree: dict, device: torch.device | str | None = None
                      ) -> LM:
    """The port's parameters from a JAX tree of numpy arrays."""
    unknown = set(tree) - _TOP
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to parts of the model "
            f"that are not ported yet")
    lstm = tfm = None
    if "lstm" in tree:
        lstm = nn.ModuleList(
            [LSTMLayer(_tensor(l["wx"]), _tensor(l["wh"]), _tensor(l["b"]))
             for l in tree["lstm"]])
    if "transformer" in tree:
        t = tree["transformer"]
        tfm = Transformer(nn.ModuleList(
            [TransformerLayer(*(_tensor(l[n]) for n in _TFM_LAYER))
             for l in t["layers"]]), _tensor(t["ln_f"]))
    head = {k: _tensor(tree[k]) for k in _HEAD if k in tree}
    cache = {k: {n: _tensor(v) for n, v in tree[k].items()}
             for k in _CACHE if k in tree}
    model = LM(_tensor(tree["embed"]), lstm, _tensor(tree["out_b"]),
               **head, **cache, transformer=tfm)
    return model.to(resolve_device(device))


def params_to_numpy(params: LM) -> dict:
    """The JAX tree (numpy fp32 arrays) of the port's parameters."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree = {"embed": arr(params.embed), "out_b": arr(params.out_b)}
    if params.lstm is not None:
        tree["lstm"] = [{"wx": arr(l.wx), "wh": arr(l.wh), "b": arr(l.b)}
                        for l in params.lstm]
    if params.transformer is not None:
        tree["transformer"] = {
            "layers": [{n: arr(getattr(l, n)) for n in _TFM_LAYER}
                       for l in params.transformer.layers],
            "ln_f": arr(params.transformer.ln_f)}
    for k in _HEAD:
        if getattr(params, k) is not None:
            tree[k] = arr(getattr(params, k))
    for k in _CACHE:
        group = getattr(params, k)
        if group is not None:
            tree[k] = {n: arr(p) for n, p in group.named_parameters()}
    return tree


def flatten(tree, prefix: str = "") -> dict:
    """{flat name: array} of a JAX tree (``lstm.0.wx``,
    ``transformer.layers.0.wqkv``, ``cache_gate.b`` ...)."""
    flat = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            flat.update(flatten(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def unflatten(flat: dict) -> dict:
    """The JAX tree of {flat name: array}: dotted names nest as dicts, and
    a level named by the numbers 0..n-1 (the layers) forms a list."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def save_params(params: LM, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten(params_to_numpy(params)))


def load_params(path: str | Path, device: torch.device | str | None = None
                ) -> LM:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(unflatten(flat), device)


def adam_state_from_numpy(count, mu: dict, nu: dict,
                          device: torch.device | str | None = None):
    """The port's Adam state from optax's ScaleByAdamState fields as numpy
    (count a scalar, mu and nu trees shaped like the parameters)."""
    from fewshot_torch.training import OptState
    dev = resolve_device(device)

    def put(tree):
        return {k: _tensor(v).to(dev) for k, v in flatten(tree).items()}

    return OptState(torch.tensor(int(np.asarray(count)), dtype=torch.int64,
                                 device=dev), put(mu), put(nu))


def adam_state_to_numpy(state) -> tuple[np.ndarray, dict, dict]:
    """(count int32, mu tree, nu tree) as numpy, optax's layout."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    return (np.int32(int(state.count)),
            unflatten({k: arr(v) for k, v in state.mu.items()}),
            unflatten({k: arr(v) for k, v in state.nu.items()}))
