"""The system under test, as the benchmark drives it: the program's
configuration and its model built around the benchmark's weights.  The
harness reaches ``fewshot_torch`` through this module and the kinds."""

from __future__ import annotations

import dataclasses

import torch

from portbench import cells


def config(spec: dict, vocab: int, max_len: int):
    """The program's Config from configs/<name>.json's "program" block,
    with the corpus's vocabulary and song length; its ``model`` is the one
    that runs the backbone that the configuration names."""
    from fewshot_torch.config import Config
    fields = {f.name for f in dataclasses.fields(Config)}
    over = {k: v for k, v in spec.items() if k in fields}
    over.update(model=cells.backbone(spec["model"]).MODEL, vocab_size=vocab,
                max_len=max_len, data_parallel=False)
    return Config(**over)


def model(spec: dict, cfg, w: dict):
    """The program's LM holding the tensors of w (they become its
    parameters and are updated in place), its backbone built by
    backbones/<spec's model>.py; its parameter names must be w's, shape
    for shape."""
    from fewshot_torch.models import lm as lm_mod
    backbone = cells.backbone(spec["model"]).build(cfg, w)
    groups: dict = {}
    for name, value in w.items():
        if name.startswith("cache_"):
            group, leaf = name.split(".", 1)
            groups.setdefault(group, {})[leaf] = value
    lm = lm_mod.LM(embed=w["embed"], out_b=w["out_b"],
                   out_proj=w.get("out_proj"), **backbone, **groups)
    got = {k: tuple(v.shape) for k, v in lm.named_parameters()}
    want = {k: tuple(v.shape) for k, v in w.items()}
    if got != want:
        raise RuntimeError(f"the program's parameters {got} are not the "
                           f"benchmark's {want}")
    return lm


def clone(w: dict) -> dict:
    return {k: v.detach().clone() for k, v in w.items()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
