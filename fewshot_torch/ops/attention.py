"""Causal self-attention dispatch: the einsum path or the no-prefix kernel.

Port of ``fewshot/ops/attention.py``.  ``use_flash`` (``cfg.flash``, off by
default) routes to the prefix-attention kernels with no prefix
(``ops/prefix_attention.py`` ``causal_self_attention_flash``: the CUDA
kernel on the card, its plain twin on the CPU), which never materialises
the [B, nh, T, T] scores; the JAX package's flash route is JAX's shipped
TPU kernel.  Both compute the same function at the real positions.  At pad
positions they differ by design: the TPU kernel's segment ids make a pad
query attend only to pad keys, the port's key mask makes it attend to the
real keys before it.  Pad rows feed only pad rows and masked loss terms.
Otherwise the einsum path runs, the JAX package's reference numerics.
"""

from __future__ import annotations

import math

import torch

from fewshot_torch.ops.prefix_attention import (NEG,
                                                causal_self_attention_flash)


def _einsum_attention(q, k, v, mask):
    """Reference path.  q/k/v [B, T, nh, hd]; mask [B, T] bool or None.
    Returns [B, T, E] fp32 (products of the stored values, fp32 sums)."""
    b, t, nh, hd = q.shape
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    bias = torch.where(causal, 0.0, NEG)[None, None]
    if mask is not None:
        bias = bias + torch.where(mask, 0.0, NEG)[:, None, None, :]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(b, t, nh * hd)


def causal_attention(q, k, v, mask, use_flash: bool) -> torch.Tensor:
    """q/k/v [B, T, nh, hd], mask [B, T] bool (True = real) or None.

    Returns [B, T, nh*hd]: the kernel route in q's dtype (as the flash
    route returns it), the einsum route in fp32.  Callers pass cfg.flash."""
    if use_flash:
        return causal_self_attention_flash(q, k, v, mask).to(q.dtype)
    return _einsum_attention(q, k, v, mask)
