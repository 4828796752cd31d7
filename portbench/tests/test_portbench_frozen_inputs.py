"""The accepted configurations' weights read as they always have: the
leaves in their order (frozen from the harness before the backbones had
modules of their own), and the bits of the tiny weights that one seed
draws on the CPU."""

import hashlib
import json

import pytest

from conftest import ROOT

LEAVES = {
    "lstm_cache_floor_v5000": [
        ('embed', (5000, 256), 'n', 1.0, 0.0),
        ('lstm.0.wx', (256, 2048), 'u', 0.046159309117249775, 0.0),
        ('lstm.0.wh', (512, 2048), 'u', 0.046159309117249775, 0.0),
        ('lstm.0.b', (2048,), 'n', 0.0, 0.0),
        ('lstm.1.wx', (512, 2048), 'u', 0.04419417382415922, 0.0),
        ('lstm.1.wh', (512, 2048), 'u', 0.04419417382415922, 0.0),
        ('lstm.1.b', (2048,), 'n', 0.0, 0.0),
        ('out_b', (5000,), 'n', 0.1, 0.0),
        ('out_proj', (512, 256), 'u', 0.08838834764831845, 0.0),
        ('cache_gate.w', (512,), 'n', 0.044194173824159216, 0.0),
        ('cache_gate.b', (), 'n', 0.2, -3.0),
        ('cache_prior.u', (5000,), 'n', 0.5, 0.0),
        ('cache_prior.log_s', (), 'n', 0.1, 3.912023005428146),
        ('cache_calib.t', (32,), 'n', 0.1, 0.0),
    ],
    "tfm_cache_floor_v5000": [
        ('embed', (5000, 256), 'n', 0.1, 0.0),
        ('transformer.layers.0.ln1', (256,), 'n', 0.1, 1.0),
        ('transformer.layers.0.wqkv', (256, 768), 'u', 0.07654655446197431,
         0.0),
        ('transformer.layers.0.wo', (256, 256), 'u', 0.10825317547305482,
         0.0),
        ('transformer.layers.0.ln2', (256,), 'n', 0.1, 1.0),
        ('transformer.layers.0.w1', (256, 1024), 'u', 0.06846531968814576,
         0.0),
        ('transformer.layers.0.w2', (1024, 256), 'u', 0.06846531968814576,
         0.0),
        ('transformer.layers.1.ln1', (256,), 'n', 0.1, 1.0),
        ('transformer.layers.1.wqkv', (256, 768), 'u', 0.07654655446197431,
         0.0),
        ('transformer.layers.1.wo', (256, 256), 'u', 0.10825317547305482,
         0.0),
        ('transformer.layers.1.ln2', (256,), 'n', 0.1, 1.0),
        ('transformer.layers.1.w1', (256, 1024), 'u', 0.06846531968814576,
         0.0),
        ('transformer.layers.1.w2', (1024, 256), 'u', 0.06846531968814576,
         0.0),
        ('transformer.ln_f', (256,), 'n', 0.1, 1.0),
        ('out_b', (5000,), 'n', 0.1, 0.0),
        ('cache_gate.w', (256,), 'n', 0.0625, 0.0),
        ('cache_gate.b', (), 'n', 0.2, -2.5),
        ('cache_prior.u', (5000,), 'n', 0.5, 0.0),
        ('cache_prior.log_s', (), 'n', 0.1, 3.912023005428146),
        ('cache_calib.t', (32,), 'n', 0.1, 0.0),
    ],
}
# sha256 over each leaf's name and fp32 bytes, in order: the tiny sizes,
# V = 300, the weights' sub-seed of run seed 31415926535, on the CPU
TINY_DIGESTS = {
    "lstm_cache_floor_v5000":
        "acfb8c401ef711522b83c7e090f3387edb0444534a24b6b73b650c73ce93b613",
    "tfm_cache_floor_v5000":
        "df8fa5323da3de45ca68cbf0c560580811d6da613aa0b2c4f937c7c1b19100bd",
}


def _config(name: str) -> dict:
    return json.loads((ROOT / "portbench/configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_leaves_are_the_accepted_ones(name):
    from portbench import inputs
    spec = dict(_config(name), max_len=96)
    assert inputs.leaves(spec, 5000) == LEAVES[name]


@pytest.mark.parametrize("name", sorted(TINY_DIGESTS))
def test_tiny_weights_are_the_accepted_bits(name):
    from portbench import cells, inputs
    config = _config(name)
    spec = dict(config, **cells.backbone(config["model"]).TINY)
    w = inputs.weights(spec, 300, inputs.sub_seeds(31_415_926_535, 3)[0],
                       "cpu")
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == TINY_DIGESTS[name]
