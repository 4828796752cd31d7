"""The import check: JAX and the JAX package by whole top-level name."""

import re
import sys
from pathlib import Path

import portbench

from portbench.run import forbidden


def test_forbidden_names_whole_top_level_modules():
    assert forbidden(["fewshot", "fewshot.data.corpus", "jax", "jax.numpy",
                      "jaxlib", "flax.linen"]) == [
        "fewshot", "fewshot.data.corpus", "flax.linen", "jax", "jax.numpy",
        "jaxlib"]
    assert forbidden(["fewshot_torch", "fewshot_torch.training",
                      "jaxtyping", "torch", "flaxen"]) == []


def test_the_reference_imports_nothing_of_the_program():
    """The reference, its backbones and the comparisons name no module of
    the program or of the JAX package."""
    for path in sorted((Path(portbench.__file__).parent / "reference")
                       .rglob("*.py")):
        src = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(fewshot|jax|flax)",
                             src, re.M), path


def test_a_run_loads_neither_jax_nor_the_jax_package(run_tiny):
    rc, res, err = run_tiny("lstm_cache.train")
    assert rc == 0, err
    assert forbidden(sys.modules) == []
