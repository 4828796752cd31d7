"""Decode attention over the KV cache: the CUDA kernel, its plain twin and
the entry point that ``models.transformer.transformer_step`` calls once a
layer a decode step.

The TPU package has no kernel here: ``fewshot/models/transformer.py``
``_attend`` leaves a decode step's attention to XLA's einsums.  The port
ran the same einsums in PyTorch, which upcast the whole bf16 cache slice
to fp32 and laid it out again every step; ``decode_attn``
(``csrc/decode_attn.cu``) reads the cache in place, once, and skips the
keys it masks.  Arithmetic and rounding points are the einsum path's:
fp32 scores of the cache-dtype operands over sqrt(hd), an fp32 softmax
against the row's final maximum, p rounded to the cache dtype, then p v
summed in fp32.  The keys admitted are ``valid & (position <= idx)``.

The wrapper runs the kernel on CUDA tensors and the plain twin (the einsum
path, ``decode_attn_plain``) on CPU tensors; there is no fallback from one
to the other.  ``decode_attn.launches`` counts the calls that launched the
kernel.
"""

from __future__ import annotations

import math

import torch

from fewshot_torch.ops import _ext
from fewshot_torch.ops._ext import DTYPE_CODE, stream
from fewshot_torch.ops.prefix_attention import NEG


def decode_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, idx: int) -> torch.Tensor:
    """The einsum path: q [B, 1, nh, hd], k/v [B, T, nh, hd], valid [B, T]
    bool, idx the decode position -> [B, 1, nh hd] fp32."""
    b, tq, nh, hd = q.shape
    key_ok = valid & (torch.arange(valid.shape[1], device=valid.device)
                      <= idx)
    bias = torch.where(key_ok, 0.0, NEG)[:, None, None, :]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(b, tq, nh * hd)


def _check_inputs(q, k, v, valid, idx) -> None:
    ok = (k.dim() == 4 and q.dim() == 4 and v.shape == k.shape
          and tuple(q.shape) == (k.shape[0], 1, *k.shape[2:])
          and q.dtype == k.dtype == v.dtype and q.dtype in DTYPE_CODE
          and valid.dtype == torch.bool
          and tuple(valid.shape) == tuple(k.shape[:2])
          and 0 <= idx < k.shape[1])
    if not ok:
        raise ValueError(
            f"bad decode attention inputs: q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} {v.dtype}, "
            f"valid {tuple(valid.shape)} {valid.dtype}, idx {idx}")
    devs = {x.device for x in (q, k, v, valid)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor, idx: int) -> torch.Tensor:
    """One decode step's attention for each row and head: the CUDA kernel
    on CUDA tensors, the plain twin on CPU tensors.  q [B, 1, nh, hd]
    (after RoPE), k/v [B, T, nh, hd] one layer's cache, read in place
    (contiguous), valid [B, T] bool, 0 <= idx < T.  Returns [B, 1, nh hd]
    fp32.  Raises where the kernel has no plan for the shape (a head wider
    than it takes, or T past its shared memory)."""
    idx = int(idx)
    _check_inputs(q, k, v, valid, idx)
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, valid, idx)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for device "
                         f"{q.device}")
    b, t, nh, hd = k.shape
    code = DTYPE_CODE[q.dtype]
    lib = _ext.load("decode_attn")
    smem = lib.decode_attn_smem(t, hd, code)
    if not 0 <= smem <= _ext.SMEM_BYTES:
        raise ValueError(
            f"decode_attn takes no T = {t}, hd = {hd} in {q.dtype}: "
            + ("no kernel instance takes the head width" if smem < 0 else
               f"{smem} bytes of shared memory a block, past "
               f"{_ext.SMEM_BYTES}"))
    if not (k.is_contiguous() and v.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("k, v and valid must be contiguous: the kernel "
                         "reads the cache in place")
    q = q.contiguous()
    out = torch.empty((b, 1, nh * hd), device=q.device)
    with torch.cuda.device(q.device):
        err = lib.decode_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              valid.data_ptr(), out.data_ptr(), b, t, nh, hd,
                              idx, math.sqrt(hd), code, stream(q))
    _ext.check(err, "decode_attn")
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
