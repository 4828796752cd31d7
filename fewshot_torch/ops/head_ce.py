"""Fused LM head + cross-entropy: CUDA kernels, plain twins, the autograd
Function and the routing predicate.

Port of ``fewshot/ops/head_ce.py``.  Per row of h2 [R, D] the loss needs
two scalars of logits = h2 @ w + b: lse = logsumexp(logits) and the logit at
the target, and the kernels compute them without writing the [R, V] logits
to device memory (``csrc/head_ce.cu``): the forward (``head_ce_fwd``) merges
a running (max, sum-exp) over 64-column tiles; the backward
(``head_ce_bwd``) recomputes each logits tile, forms dlogits = dlse p + dtl
onehot(target), rounds it to the operand dtype, and contracts it into dh2
(one pass over row tiles) and into per-chunk dW/db partials (one pass over
vocab tiles) that the wrapper adds up.  bf16 backs onto the tensor-core
backward (mma.sync bf16 tiles, register accumulators); fp32, and the
forward in both dtypes, onto the v1 SIMT kernels.

Rounding points are the TPU kernels': operands in the compute dtype with
fp32 products and sums, w cast to h2's dtype, dlogits rounded before both
products, db summed from the unrounded fp32 dlogits, dh2 returned in h2's
dtype and dw in fp32 (then w's dtype).

``head_ce_fwd`` and ``head_ce_bwd`` run the kernels on CUDA tensors and the
plain twins on CPU tensors; there is no fallback from one to the other.
``fused_head_nll_supported`` routes where the JAX package's predicate
does, so one config takes the fused head in both packages; on the card the
backward takes D up to ``max_head_dim`` and raises above it.
"""

from __future__ import annotations

import torch

from fewshot_torch.ops import _ext
from fewshot_torch.ops._ext import (DTYPE_CODE, SMEM_BYTES, check_tensors,
                                    contiguous_as, itemsize, needs_grad,
                                    stream)

_TILE = 64          # rows / vocab columns of a kernel tile (csrc/head_ce.cu)

# ---------------------------------------------------------------------------
# routing: the JAX package's plan arithmetic (fewshot/ops/head_ce.py:64-135)
# ---------------------------------------------------------------------------

_VMEM_BUDGET = 14 * 2 ** 20


def _tiled_tiles(d: int, itemsize: int) -> tuple[int, int]:
    """(row_tile, vocab_tile) of the TPU's vocab-tiled plan, or (0, 0)."""
    for rt in (512, 256, 128, 64, 32, 16, 8):
        for vt in (2048, 1024, 512, 256, 128):
            shared = 2 * d * vt * itemsize + 2 * rt * d * itemsize
            est = max(shared + 2 * rt * vt * 4,
                      shared + 3 * rt * vt * 4 + rt * d * 4,
                      shared + 3 * rt * vt * 4 + d * vt * 4 + vt * 4)
            if est <= _VMEM_BUDGET:
                return rt, vt
    return 0, 0


def fused_head_nll_supported(d: int, v: int,
                             dtype: torch.dtype = torch.bfloat16) -> bool:
    """True where the JAX package scores with its fused head+CE kernels: D
    lane-aligned and the TPU's vocab-tiled plan fits, which depends on D
    alone.  JAX tries a VMEM-resident plan first, but below D = 9216
    (fp32) / 13952 (bf16), far past ``max_head_dim``, it admits no (D, V)
    that the tiled plan refuses; so v does not change the answer."""
    return d % 128 == 0 and _tiled_tiles(d, itemsize(dtype))[0] >= 8


def max_head_dim(dtype: torch.dtype) -> int:
    """The largest head width D the backward kernels take in dtype (a
    multiple of 64; the forward takes any multiple of 64).

    fp32 (the v1 SIMT kernels): a block keeps an fp32 [64, D + 16]
    accumulator in shared memory beside its staging buffers (two
    double-buffered [64, 32 + 16 B] operand chunks, aliased by one
    [64, 64 + 16 B] window) and the [64, 65] fp32 dlogits tile.
    bf16 (the tensor-core kernels): a block keeps a [64, D + 8] bf16 outer
    tile and two stages of a [32, D + 8] bf16 inner tile with 4 floats per
    inner row (csrc/head_ce.cu TcLayout; its accumulators live in
    registers, 256 columns a block)."""
    if dtype == torch.bfloat16:
        per_col = 2 * (_TILE + 2 * 32)          # bytes per unit of D + 8
        return ((SMEM_BYTES - 2 * 4 * 32 * 4) // per_col - 8) // 64 * 64
    size = itemsize(dtype)
    vec = 16 // size
    stage = max(2 * 2 * _TILE * (32 + vec) * size, _TILE * (64 + vec) * size)
    free = SMEM_BYTES - stage - _TILE * (_TILE + 1) * 4
    return (free // (_TILE * 4) - 16) // 64 * 64


def check_head_dim(d: int, dtype: torch.dtype, train: bool) -> None:
    if d % 64:
        raise ValueError(
            f"the head+CE kernels take D a multiple of 64, got {d}")
    if train and d > max_head_dim(dtype):
        raise ValueError(
            f"head width {d} exceeds the head+CE backward kernels' limit of "
            f"{max_head_dim(dtype)} for {dtype} (one block's shared memory "
            f"holds its [64, D] tiles)")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def head_lse_tgt_plain(h2, w, b, targets):
    """Plain PyTorch twin of the forward kernel: dense logits at the kernels'
    rounding points.  h2 [R, D] (bf16 or fp32), w [D, V] (cast to h2's
    dtype), b [V] fp32, targets [R] int.  Returns (lse, tl) [R] fp32."""
    logits = h2.float() @ w.to(h2.dtype).float() + b.float()
    tl = logits.gather(-1, targets.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), tl


def head_lse_tgt_bwd_plain(h2, w, b, targets, lse, dlse, dtl):
    """Plain PyTorch twin of the backward kernels.  The forward's inputs,
    lse and the cotangents dlse, dtl [R] fp32.  Returns dh2 [R, D] in h2's
    dtype, dw [D, V] and db [V] fp32."""
    dt = h2.dtype
    wf = w.to(dt).float()
    p = torch.exp(h2.float() @ wf + b.float() - lse[:, None])
    # + dtl at the target column: the same sums as + dtl * onehot
    dlogits = (dlse[:, None] * p).scatter_add_(
        1, targets.long()[:, None], dtl[:, None].float())
    dlg = dlogits.to(dt).float()
    return (dlg @ wf.T).to(dt), h2.float().T @ dlg, dlogits.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(h2, w, b, targets, *per_row) -> None:
    r, d = h2.shape
    if h2.dtype not in DTYPE_CODE:
        raise TypeError(f"h2 must be fp32 or bf16, got {h2.dtype}")
    if w.dim() != 2 or w.shape[0] != d or tuple(b.shape) != (w.shape[1],) \
            or tuple(targets.shape) != (r,):
        raise ValueError(f"bad shapes h2 {tuple(h2.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, targets "
                         f"{tuple(targets.shape)}")
    for x in per_row:
        if x.dtype != torch.float32 or tuple(x.shape) != (r,):
            raise ValueError(f"per-row inputs must be fp32 [{r}], got "
                             f"{x.dtype} {tuple(x.shape)}")
    devs = {x.device for x in (h2, w, b, targets, *per_row)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _kernel_args(h2, w, b, targets):
    """h2, wt = w^T [V, D] and b fp32, targets int32, all contiguous: the
    tied head's w is embed^T, so wt is the table itself (cast to h2's dtype
    where it is stored in another)."""
    wt = w.T
    if wt.dtype != h2.dtype or not wt.is_contiguous():
        wt = contiguous_as(wt, h2.dtype)
    args = (h2.contiguous(), wt, b.float().contiguous(),
            targets.to(torch.int32).contiguous())
    check_tensors(*args)
    return args


def head_ce_fwd(h2, w, b, targets):
    """Per-row (lse, target logit) of h2 @ w + b: the CUDA kernel on CUDA
    tensors, the plain twin on CPU tensors.  Same arguments and results as
    ``head_lse_tgt_plain``.

    ``head_ce_fwd.launches`` counts the calls that launched the kernel."""
    _check_inputs(h2, w, b, targets)
    if h2.device.type == "cpu":
        return head_lse_tgt_plain(h2, w, b, targets)
    if h2.device.type != "cuda":
        raise ValueError(f"no head+CE kernel for device {h2.device}")
    r, d = h2.shape
    check_head_dim(d, h2.dtype, train=False)
    h2c, wt, bc, tgt = _kernel_args(h2, w, b, targets)
    lib = _ext.load("head_ce")
    with torch.cuda.device(h2.device):
        lse = torch.empty(r, device=h2.device)
        tl = torch.empty(r, device=h2.device)
        err = lib.head_ce_fwd(h2c.data_ptr(), wt.data_ptr(), bc.data_ptr(),
                              tgt.data_ptr(), lse.data_ptr(), tl.data_ptr(),
                              r, wt.shape[0], d, DTYPE_CODE[h2.dtype],
                              stream(h2))
    _ext.check(err, "head_ce_fwd")
    head_ce_fwd.launches += 1
    return lse, tl


head_ce_fwd.launches = 0


def _dw_splits(rows: int, vocab: int, dtype: torch.dtype,
               device: torch.device) -> int:
    """Row chunks of the dW pass: vocab tiles alone are fewer blocks than
    the card has SMs, so each tile's rows split into chunks.  bf16: as many
    as fill the two blocks an SM holds in one wave; fp32: about two blocks
    per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    vtiles = -(-vocab // _TILE)
    rtiles = max(1, -(-rows // _TILE))
    per_tile = (2 * sms // vtiles if dtype == torch.bfloat16
                else -(-2 * sms // vtiles))
    return max(1, min(rtiles, per_tile))


def head_ce_bwd(h2, w, b, targets, lse, dlse, dtl):
    """The head+CE backward: the CUDA kernels on CUDA tensors, the plain
    twin on CPU tensors.  Same arguments and results as
    ``head_lse_tgt_bwd_plain``; on the card dw is a [D, V] view of the
    kernels' [V, D] result (the tied head's table layout).

    ``head_ce_bwd.launches`` counts the calls that launched the kernels (one
    call launches the dh2 pass and the dW/db pass)."""
    _check_inputs(h2, w, b, targets, lse, dlse, dtl)
    if h2.device.type == "cpu":
        return head_lse_tgt_bwd_plain(h2, w, b, targets, lse, dlse, dtl)
    if h2.device.type != "cuda":
        raise ValueError(f"no head+CE kernel for device {h2.device}")
    r, d = h2.shape
    check_head_dim(d, h2.dtype, train=True)
    h2c, wt, bc, tgt = _kernel_args(h2, w, b, targets)
    rows = (lse.contiguous(), dlse.contiguous(), dtl.contiguous())
    check_tensors(*rows)
    v = wt.shape[0]
    lib = _ext.load("head_ce")
    with torch.cuda.device(h2.device):
        splits = _dw_splits(r, v, h2.dtype, h2.device)
        dh2 = torch.empty_like(h2c)
        dwt = torch.empty((splits, v, d), device=h2.device)
        db = torch.empty((splits, v), device=h2.device)
        err = lib.head_ce_bwd(h2c.data_ptr(), wt.data_ptr(), bc.data_ptr(),
                              tgt.data_ptr(), *(x.data_ptr() for x in rows),
                              dh2.data_ptr(), dwt.data_ptr(), db.data_ptr(),
                              r, v, d, splits, DTYPE_CODE[h2.dtype],
                              stream(h2))
    _ext.check(err, "head_ce_bwd")
    head_ce_bwd.launches += 1
    # the partials of the row chunks, added in chunk order
    return dh2, dwt.sum(dim=0).T, db.sum(dim=0)


head_ce_bwd.launches = 0


class HeadLseTgtFn(torch.autograd.Function):
    """head_lse_tgt with its custom VJP: (h2, w, b, targets) -> (lse, tl);
    the backward kernels recompute the logits from the saved inputs and
    lse."""

    @staticmethod
    def forward(ctx, h2, w, b, targets):
        lse, tl = head_ce_fwd(h2, w, b, targets)
        ctx.save_for_backward(h2, w, b, targets, lse)
        return lse, tl

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dlse, dtl):
        h2, w, b, targets, lse = ctx.saved_tensors
        dlse = torch.zeros_like(lse) if dlse is None else dlse.float()
        dtl = torch.zeros_like(lse) if dtl is None else dtl.float()
        dh2, dw, db = head_ce_bwd(h2, w, b, targets, lse, dlse, dtl)
        return dh2, dw.to(w.dtype), db.to(b.dtype), None


def head_lse_tgt(h2, w, b, targets):
    """(lse [R], target logit [R]) of logits = h2 @ w + b, fused.

    h2 [R, D] (bf16 or fp32), w [D, V], b [V] fp32, targets [R] int in
    [0, V): the JAX package's signature.  CE per row is lse - tl.
    Differentiable in h2, w and b when a grad is needed."""
    if needs_grad(h2, w, b):
        return HeadLseTgtFn.apply(h2, w, b, targets)
    return head_ce_fwd(h2, w, b, targets)
