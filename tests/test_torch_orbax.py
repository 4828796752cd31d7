"""orbax_to_torch.py: a checkpoint of the JAX package restored by the port.

A JAX ``TrainState`` after two Adam steps (the LSTM with the full cache
head, so its 0-d parameters are covered) is saved by
``fewshot.utils.ckpt.save_checkpoint`` (orbax), converted by the script's
``main``, and restored by ``fewshot_torch.utils.ckpt.recover_or_init`` on
the CPU: the parameters, the Adam moments and count, and the step are the
same bits, the generator is seeded ``seed + step`` (JAX's key does not
carry over), ``meta.json`` carries the vocab hash (another vocab is
refused) and the hyperparameters, and the port trains on from it.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fewshot import training as jax_training
from fewshot.config import Config as JaxConfig
from fewshot.data import episodes as jax_eps
from fewshot.utils.ckpt import hparams_of, save_checkpoint, \
    wait_for_checkpoints
from fewshot_torch import bridge, training
from fewshot_torch.config import Config
from fewshot_torch.data import episodes as eps
from fewshot_torch.utils import ckpt

REPO = Path(__file__).resolve().parent.parent
CFG = dict(vocab_size=64, max_len=24, embed_dim=16, hidden_dim=24,
           num_layers=1, batch_size=4, support_size=2, query_size=2,
           lr=5e-3, cell="scan", compute_dtype="float32",
           support_cache=True, cache_calib=True, cache_dynamic=True,
           data_parallel=False, seed=5)


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", REPO / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converted_checkpoint_restores_bit_for_bit(tiny_corpus, tmp_path,
                                                   capsys):
    jcfg = JaxConfig(**CFG)
    v = len(tiny_corpus.vocab)
    data = jax_eps.put_corpus(tiny_corpus)
    split = jax.numpy.asarray(tiny_corpus.splits["train"])
    state = jax_training.init_train_state(jcfg, v)
    step = jax_training.make_train_step(jcfg, data, split)
    for _ in range(2):
        state, _ = step(state)
    vocab_hash = tiny_corpus.vocab.content_hash()
    save_checkpoint(tmp_path / "jax", state, vocab_hash, block=True,
                    hparams=hparams_of(jcfg))
    wait_for_checkpoints()

    assert _script().main(["--src", str(tmp_path / "jax"), "--out",
                           str(tmp_path / "torch"), "--seed", "5"]) == 0
    assert "wrote" in capsys.readouterr().out

    cfg = Config(**CFG)
    init = training.init_train_state(cfg, v, device="cpu")
    got, restored = ckpt.recover_or_init(tmp_path / "torch", init,
                                         vocab_hash, ckpt.hparams_of(cfg))
    assert restored and got.step == 2
    want = bridge.flatten(jax.tree.map(np.asarray, state.params))
    have = dict(got.params.named_parameters())
    assert set(want) == set(have)
    for k, a in want.items():
        assert np.array_equal(have[k].detach().numpy(), a), k
    adam = [s for s in jax.tree.leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    assert int(got.opt_state.count) == int(adam.count) == 2
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for k, a in bridge.flatten(jax.tree.map(np.asarray, tree)).items():
            assert np.array_equal(
                getattr(got.opt_state, name)[k].numpy(), a), (name, k)
    assert torch.equal(got.gen.get_state(),
                       torch.Generator().manual_seed(5 + 2).get_state())
    meta = json.loads((tmp_path / "torch" / "meta.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "meta.json").read_text())
    with pytest.raises(ValueError, match="different vocab"):
        ckpt.recover_or_init(tmp_path / "torch", init, "0" * 16)

    # the port trains on from the converted state
    step = training.make_train_step(cfg, eps.put_corpus(tiny_corpus, "cpu"),
                                    torch.as_tensor(tiny_corpus.splits[
                                        "train"], dtype=torch.int64))
    got, m = step(got)
    assert got.step == 3 and np.isfinite(float(m["loss"]))
