"""PyTorch/CUDA port of the ``fewshot`` package (few-shot episodic LMs).

The JAX package ``fewshot`` is the reference; this package imports nothing
from it and nothing of JAX.  Entry points run on a CUDA card unless the
caller passes ``device="cpu"``.
"""
