"""Single-layer LSTM recurrence: CUDA kernels, their plain twins, the
autograd Function and the adapter.

Port of ``fewshot/ops/lstm_pallas.py``.  The input projection zx = x @ Wx
for all steps is one large product outside the kernels; the forward kernel
runs the sequential part: per step h @ Wh, the gates and the masked state
update (``csrc/lstm_fwd.cu``, ``lstm_fwd_layer``).  In train mode it also
saves the gate activations, and the backward kernel (``csrc/lstm_bwd.cu``,
``lstm_bwd_layer``) runs BPTT in reverse time from them, producing dzx,
dh0, dc0 and db; dWh is one bulk product over the saved streams.

Streams (zx, ys, cs, gates, dys, dzx) are bf16 when the compute dtype is
bf16 and fp32 otherwise; the carried h, c, dh and dc are always fp32, as in
the TPU kernels.

``lstm_layer_fwd`` and ``lstm_layer_bwd`` run the kernels on CUDA tensors
and the plain twins on CPU tensors; there is no fallback from one to the
other.  Both refuse a hidden size whose narrowest kernel tile does not fit
in one block's shared memory; the backward's contraction is 4H deep, so
its limit (``max_hidden_bwd``) is lower, and train mode raises above it.
"""

from __future__ import annotations

import torch

from fewshot_torch.models.lstm import FORGET_BIAS, cell_update, matmul_f32
from fewshot_torch.ops import _ext
from fewshot_torch.ops._ext import (DTYPE_CODE, SMEM_BYTES, check_tensors,
                                    contiguous_as, itemsize, needs_grad,
                                    stream)

def max_hidden(dtype: torch.dtype) -> int:
    """The largest hidden size the forward kernels take in dtype.

    Their narrowest tile (csrc/lstm_fwd.cu: 16 rows x 4 units) stages 16
    fp32 h rows of H + 4 floats and the H x 16 weight columns of its units
    in shared memory."""
    per_unit = 16 * 4 + 16 * itemsize(dtype)
    return (SMEM_BYTES - 16 * 4 * 4) // per_unit // 32 * 32


def max_hidden_bwd(dtype: torch.dtype) -> int:
    """The largest hidden size the backward kernels take in dtype.

    Their narrowest tile (csrc/lstm_bwd.cu: 16 rows x 4 units) stages 16
    rows of dz and the 4 Wh rows of its units, each 4H wide in dtype plus
    16 bytes of padding."""
    per_row = SMEM_BYTES // 20 - 16
    return per_row // (4 * itemsize(dtype)) // 32 * 32


def _check_fp32(want: dict) -> None:
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be fp32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")


def _check_inputs(zx, wh, b, mask, h0, c0) -> None:
    t_, b_, four_h = zx.shape
    hidden = four_h // 4
    if zx.dtype not in DTYPE_CODE or wh.dtype != zx.dtype:
        raise TypeError(f"zx/wh must share fp32 or bf16, got {zx.dtype}, "
                        f"{wh.dtype}")
    if four_h % 4 or hidden % 32 or tuple(wh.shape) != (hidden, four_h):
        raise ValueError(f"bad shapes zx {tuple(zx.shape)}, wh "
                         f"{tuple(wh.shape)} (H must be a multiple of 32)")
    check_hidden(hidden, zx.dtype)
    _check_fp32({"b": (b, (four_h,)), "mask": (mask, (t_, b_, 1)),
                 "h0": (h0, (b_, hidden)), "c0": (c0, (b_, hidden))})
    check_tensors(zx, wh, b, mask, h0, c0)


def _check_bwd_inputs(gates, wh, mask, cs, c0, dys, dhT, dcT) -> None:
    t_, b_, four_h = gates.shape
    hidden = four_h // 4
    if gates.dtype not in DTYPE_CODE or {wh.dtype, cs.dtype, dys.dtype} \
            != {gates.dtype}:
        raise TypeError("gates/wh/cs/dys must share fp32 or bf16")
    if hidden % 32 or tuple(wh.shape) != (hidden, four_h) \
            or tuple(cs.shape) != (t_, b_, hidden) \
            or tuple(dys.shape) != (t_, b_, hidden):
        raise ValueError(f"bad shapes gates {tuple(gates.shape)}, wh "
                         f"{tuple(wh.shape)}, cs {tuple(cs.shape)}, dys "
                         f"{tuple(dys.shape)}")
    check_hidden_bwd(hidden, gates.dtype)
    _check_fp32({"mask": (mask, (t_, b_, 1)), "c0": (c0, (b_, hidden)),
                 "dhT": (dhT, (b_, hidden)), "dcT": (dcT, (b_, hidden))})
    check_tensors(gates, wh, mask, cs, c0, dys, dhT, dcT)


def check_hidden(hidden: int, dtype: torch.dtype) -> None:
    """Raise on a hidden size past the forward kernels' shared-memory
    limit."""
    if hidden > max_hidden(dtype):
        raise ValueError(
            f"hidden size {hidden} exceeds the LSTM kernels' limit of "
            f"{max_hidden(dtype)} for {dtype} (one block's shared memory)")


def check_hidden_bwd(hidden: int, dtype: torch.dtype) -> None:
    """Raise on a hidden size past the backward kernels' shared-memory
    limit (train mode)."""
    if hidden > max_hidden_bwd(dtype):
        raise ValueError(
            f"hidden size {hidden} exceeds the LSTM backward kernels' limit "
            f"of {max_hidden_bwd(dtype)} for {dtype} (one block's shared "
            f"memory holds 16 rows of the 4H-deep contraction); train at a "
            f"smaller hidden size")


def cell_bwd(g, c_t, c_prev, dh, dc, mf):
    """One step of the cell's backward, the TPU kernels' arithmetic.

    g [B, 4H] saved gate activations (sigmoid i, tanh j, sigmoid(f+1),
    sigmoid o); c_t, c_prev [B, H] the cell stream at t and t-1; dh, dc
    [B, H] the incoming cotangents; mf [B, 1] 1.0 on real steps.  All fp32.
    Returns (dz [B, 4H], the dc carried to step t-1 [B, H])."""
    si, tj, sf, so = g.chunk(4, dim=-1)
    tc = torch.tanh(c_t)
    d_new_h = mf * dh
    d_new_c = d_new_h * so * (1.0 - tc * tc) + mf * dc
    dz = torch.cat([d_new_c * tj * si * (1.0 - si),
                    d_new_c * si * (1.0 - tj * tj),
                    d_new_c * c_prev * sf * (1.0 - sf),
                    d_new_h * tc * so * (1.0 - so)], dim=-1)
    return dz, d_new_c * sf + (1.0 - mf) * dc


def gate_acts(z: torch.Tensor) -> torch.Tensor:
    """(sigmoid i, tanh j, sigmoid(f + 1), sigmoid o) of z [.., 4H]."""
    i, j, f, o = z.chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.tanh(j),
                      torch.sigmoid(f + FORGET_BIAS), torch.sigmoid(o)],
                     dim=-1)


def lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0, save_gates=False):
    """Plain PyTorch twin of the forward kernel: the same function, step by
    step.

    zx [T,B,4H] stream dtype; wh [H,4H] compute dtype; b [4H] fp32; mask
    [T,B,1] fp32 (1 = real step); h0/c0 [B,H] fp32.
    Returns (ys, cs) [T,B,H] in the stream dtype and (hT, cT) [B,H] fp32,
    then with save_gates the gate activations [T,B,4H] in the stream
    dtype."""
    w = wh.float()
    h, c = h0, c0
    ys, cs, gates = [], [], []
    for t in range(zx.shape[0]):
        z = zx[t].float() + h.to(wh.dtype).float() @ w + b
        if save_gates:
            gates.append(gate_acts(z).to(zx.dtype))
        new_h, new_c = cell_update(z, c)
        live = mask[t] > 0
        h = torch.where(live, new_h, h)
        c = torch.where(live, new_c, c)
        ys.append(h.to(zx.dtype))
        cs.append(c.to(zx.dtype))
    if not ys:
        empty = zx.new_empty((0,) + tuple(h0.shape))
        out = (empty, empty, h, c)
        return out + (zx.new_empty(zx.shape),) if save_gates else out
    out = (torch.stack(ys), torch.stack(cs), h, c)
    return out + (torch.stack(gates),) if save_gates else out


def lstm_layer_fwd(zx, wh, b, mask, h0, c0, save_gates=False):
    """One layer's recurrence: the CUDA kernel on CUDA tensors, the plain
    twin on CPU tensors.  Same arguments and results as the twin.

    ``lstm_layer_fwd.launches`` counts the calls that launched the kernel
    (one call launches one step kernel per time step)."""
    _check_inputs(zx, wh, b, mask, h0, c0)
    if zx.device.type == "cpu":
        return lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0, save_gates)
    if zx.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {zx.device}")
    t_, b_, four_h = zx.shape
    hidden = four_h // 4
    lib = _ext.load("lstm_fwd")
    # every input is on zx's device (_check_inputs); the outputs go there
    # too, and the launch runs with that device current, on its stream
    with torch.cuda.device(zx.device):
        h_buf = torch.empty((2, b_, hidden), dtype=torch.float32,
                            device=zx.device)
        h_buf[0].copy_(h0)
        c = c0.clone()
        ys = torch.empty((t_, b_, hidden), dtype=zx.dtype, device=zx.device)
        cs = torch.empty_like(ys)
        gates = torch.empty_like(zx) if save_gates else None
        err = lib.lstm_fwd_layer(
            zx.data_ptr(), wh.data_ptr(), b.data_ptr(), mask.data_ptr(),
            h_buf.data_ptr(), c.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            gates.data_ptr() if save_gates else None, t_, b_, hidden,
            DTYPE_CODE[zx.dtype], stream(zx))
    _ext.check(err, "lstm_fwd_layer")
    lstm_layer_fwd.launches += 1
    out = (ys, cs, h_buf[t_ % 2], c)
    return out + (gates,) if save_gates else out


lstm_layer_fwd.launches = 0


def lstm_layer_bwd_plain(gates, wh, mask, cs, c0, dys, dhT, dcT):
    """Plain PyTorch twin of the backward kernel: reverse-time BPTT with
    the arithmetic of fewshot/ops/lstm_pallas.py _bwd_kernel.

    gates [T,B,4H], cs and dys [T,B,H] in the stream dtype; wh [H,4H]
    compute dtype; mask [T,B,1], c0, dhT, dcT [B,H] fp32.  c_{t-1} and
    tanh(c_t) come from the stream-dtype cs (c0 at t = 0); dz is stored in
    the stream dtype and rounded to the weight dtype for dz @ Wh^T.
    Returns dzx [T,B,4H] (stream dtype), dh0, dc0 [B,H] and db [4H]
    (fp32, the sum of the unrounded dz)."""
    wt = wh.float().T
    dh_c, dc_c = dhT, dcT
    db = torch.zeros(gates.shape[-1], device=gates.device)
    dzx = []
    for t in reversed(range(gates.shape[0])):
        c_prev = cs[t - 1].float() if t > 0 else c0
        mf = (mask[t] > 0).float()
        dh = dys[t].float() + dh_c
        dz, dc_c = cell_bwd(gates[t].float(), cs[t].float(), c_prev, dh,
                            dc_c, mf)
        dzx.append(dz.to(dys.dtype))
        db = db + dz.sum(dim=0)
        dh_c = dz.to(wh.dtype).float() @ wt + (1.0 - mf) * dh
    if not dzx:
        return gates.new_empty(gates.shape), dh_c, dc_c, db
    return torch.stack(dzx[::-1]), dh_c, dc_c, db


def lstm_layer_bwd(gates, wh, mask, cs, c0, dys, dhT, dcT):
    """One layer's BPTT: the CUDA kernel on CUDA tensors, the plain twin on
    CPU tensors.  Same arguments and results as the twin.

    ``lstm_layer_bwd.launches`` counts the calls that launched the kernel
    (one call launches T + 1 step kernels)."""
    _check_bwd_inputs(gates, wh, mask, cs, c0, dys, dhT, dcT)
    if gates.device.type == "cpu":
        return lstm_layer_bwd_plain(gates, wh, mask, cs, c0, dys, dhT, dcT)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {gates.device}")
    t_, b_, four_h = gates.shape
    lib = _ext.load("lstm_bwd")
    with torch.cuda.device(gates.device):
        dh = dhT.clone()
        dc = dcT.clone()
        dzx = torch.empty_like(gates)
        # per-row-block partials of db (16-row blocks, the narrowest tile)
        db = torch.zeros(((b_ + 15) // 16, four_h), device=gates.device)
        err = lib.lstm_bwd_layer(
            gates.data_ptr(), wh.data_ptr(), mask.data_ptr(), cs.data_ptr(),
            c0.data_ptr(), dys.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            dzx.data_ptr(), db.data_ptr(), t_, b_, four_h // 4,
            DTYPE_CODE[gates.dtype], stream(gates))
    _ext.check(err, "lstm_bwd_layer")
    lstm_layer_bwd.launches += 1
    return dzx, dh, dc, db.sum(dim=0)


lstm_layer_bwd.launches = 0


def weight_grad(h0, ys, dzx):
    """dWh = sum over (t, rows) of h_{t-1}^T dz_t with h_{-1} = h0, in fp32:
    h0 [..., B, H] fp32, ys [..., T, B, H], dzx [..., T, B, 4H] (a leading
    layer axis is optional)."""
    hprev0 = h0.to(ys.dtype).float()
    dwh = torch.einsum("...bh,...bg->...hg", hprev0, dzx[..., 0, :, :].float())
    if ys.shape[-3] > 1:
        dwh = dwh + torch.einsum("...tbh,...tbg->...hg",
                                 ys[..., :-1, :, :].float(),
                                 dzx[..., 1:, :, :].float())
    return dwh


class LSTMLayerFn(torch.autograd.Function):
    """lstm_scan_pallas with its custom VJP: the forward kernel saving the
    gate activations, the backward kernel, and dWh as one bulk product.

    (zx, wh, b, mask, h0, c0) -> (ys [T,B,H] stream dtype, hT, cT)."""

    @staticmethod
    def forward(ctx, zx, wh, b, mask, h0, c0):
        check_hidden_bwd(wh.shape[0], wh.dtype)
        ys, cs, hT, cT, gates = lstm_layer_fwd(zx, wh, b, mask, h0, c0,
                                               save_gates=True)
        ctx.save_for_backward(wh, mask, h0, c0, ys, cs, gates)
        return ys, hT, cT

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys, dhT, dcT):
        wh, mask, h0, c0, ys, cs, gates = ctx.saved_tensors
        dys = (torch.zeros_like(ys) if dys is None
               else dys.to(ys.dtype).contiguous())
        dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
        dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        dzx, dh0, dc0, db = lstm_layer_bwd(gates, wh, mask, cs, c0, dys,
                                           dhT, dcT)
        if ys.shape[0] == 0:
            dwh = torch.zeros_like(wh)
        else:
            dwh = weight_grad(h0, ys, dzx).to(wh.dtype)
        return dzx, dwh, db, None, dh0, dc0


def lstm_layer_pallas(layer, x, mask, h0c0, compute_dtype, zx=None):
    """Drop-in replacement for models.lstm._layer_scan (same signature).

    zx: optional precomputed input projection [B, T, 4H]; x is then
    ignored.  Differentiable: when a grad is needed the forward kernel
    saves its gates and the backward kernel runs in the backward pass.
    Returns (ys [B, T, H] fp32, (hT, cT))."""
    b_, t_, _ = (zx if zx is not None else x).shape
    hidden = layer.wh.shape[0]
    if hidden % 128:
        raise ValueError(
            f"cell='pallas' requires hidden_dim % 128 == 0, got {hidden}")
    stream_dt = (torch.bfloat16 if compute_dtype == torch.bfloat16
                 else torch.float32)
    if zx is None:
        zx = matmul_f32(x, layer.wx, compute_dtype)          # [B, T, 4H]
    zx_t = contiguous_as(zx.transpose(0, 1), stream_dt)
    if mask is None:
        mask_t = torch.ones((t_, b_, 1), device=zx.device)
    else:
        mask_t = contiguous_as(mask.transpose(0, 1)[..., None], torch.float32)
    h0, c0 = h0c0
    args = (zx_t, layer.wh.to(compute_dtype).contiguous(),
            layer.b.float().contiguous(), mask_t, h0.float().contiguous(),
            c0.float().contiguous())
    if needs_grad(*args):
        ys, hT, cT = LSTMLayerFn.apply(*args)
    else:
        ys, _cs, hT, cT = lstm_layer_fwd(*args)
    return ys.transpose(0, 1).float(), (hT, cT)
