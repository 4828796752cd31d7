"""Parameters between the JAX tree (as numpy arrays) and the port, and the
port's checkpoint file.

The JAX package's LSTM parameter tree (``fewshot/models/lm.py`` init_lm) is
``embed``, ``lstm[l].{wx, wh, b}``, ``out_proj`` or ``out_w``, and
``out_b``.  The port keeps the same layouts (wx [in, 4H], wh [H, 4H]), so
conversion copies arrays and transposes nothing.  ``params.npz`` holds the
same arrays under flat names (``lstm.0.wx``); it is what ``--checkpt_dir``
points at.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from fewshot_torch.device import resolve_device
from fewshot_torch.models.lm import LSTMLM
from fewshot_torch.models.lstm import LSTMLayer

_HEAD = ("out_proj", "out_w")
_TOP = {"embed", "lstm", "out_b", *_HEAD}


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def params_from_numpy(tree: dict, device: torch.device | str | None = None
                      ) -> LSTMLM:
    """The port's parameters from a JAX LSTM tree of numpy arrays."""
    unknown = set(tree) - _TOP
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to parts of the model "
            f"that are not ported yet")
    lstm = nn.ModuleList(
        [LSTMLayer(_tensor(l["wx"]), _tensor(l["wh"]), _tensor(l["b"]))
         for l in tree["lstm"]])
    head = {k: _tensor(tree[k]) for k in _HEAD if k in tree}
    model = LSTMLM(_tensor(tree["embed"]), lstm, _tensor(tree["out_b"]),
                   **head)
    return model.to(resolve_device(device))


def params_to_numpy(params: LSTMLM) -> dict:
    """The JAX tree (numpy fp32 arrays) of the port's parameters."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy().copy()

    tree = {"embed": arr(params.embed), "out_b": arr(params.out_b),
            "lstm": [{"wx": arr(l.wx), "wh": arr(l.wh), "b": arr(l.b)}
                     for l in params.lstm]}
    for k in _HEAD:
        if getattr(params, k) is not None:
            tree[k] = arr(getattr(params, k))
    return tree


def save_params(params: LSTMLM, path: str | Path) -> None:
    tree = params_to_numpy(params)
    flat = {k: v for k, v in tree.items() if k != "lstm"}
    for i, layer in enumerate(tree["lstm"]):
        for k, v in layer.items():
            flat[f"lstm.{i}.{k}"] = v
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)


def load_params(path: str | Path, device: torch.device | str | None = None
                ) -> LSTMLM:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    n_layers = len({k.split(".")[1] for k in flat if k.startswith("lstm.")})
    tree = {k: v for k, v in flat.items() if not k.startswith("lstm.")}
    tree["lstm"] = [{k: flat[f"lstm.{i}.{k}"] for k in ("wx", "wh", "b")}
                    for i in range(n_layers)]
    return params_from_numpy(tree, device)
