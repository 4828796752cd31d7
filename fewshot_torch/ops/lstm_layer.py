"""Single-layer LSTM recurrence: CUDA kernels, their plain twins, the
autograd Function and the adapter.

Port of ``fewshot/ops/lstm_pallas.py``.  The input projection zx = x @ Wx
for all steps is one large product outside the kernels; the forward kernel
runs the sequential part: per step h @ Wh, the gates and the masked state
update.  In train mode it also saves the gate activations, and the backward
kernel runs BPTT in reverse time from them, producing dzx, dh0, dc0 and db;
dWh is one bulk product over the saved streams.

Two routes, chosen by shape (``persistent_route``), never by failure:
bf16 at H = 128..512 (a multiple of 128) runs the persistent kernels
(``csrc/lstm_fwd.cu`` ``lstm_fwd_persist``, ``csrc/lstm_bwd.cu``
``lstm_bwd_persist``: one launch a call, a thread-block cluster per 32-row
tile, Wh resident, tensor-core products; the backward trades its dh
partials through a scratch buffer it is given); fp32, and bf16 past that
width, run the step kernels (``lstm_fwd_layer``, ``lstm_bwd_layer``: one
launch per time step).

Streams (zx, ys, cs, gates, dys, dzx) are bf16 when the compute dtype is
bf16 and fp32 otherwise; the carried h, c, dh and dc are always fp32, as in
the TPU kernels.  With ``FEWSHOT_LSTM_GATES_INT8`` set (read once, at
import, as lstm_pallas.py does) the saved gates are int8-coded wherever the
TPU kernel's batch tile is a multiple of 32 (``saved_gates_dtype``).

``lstm_layer_fwd`` and ``lstm_layer_bwd`` run the kernels on CUDA tensors
and the plain twins on CPU tensors; there is no fallback from one to the
other.  The step kernels walk the contraction in chunks through a
shared-memory ring, so they take every H that is a multiple of 32, in train
mode and serving alike: where the JAX package leaves its kernel for the
plain scan (Wh past the TPU's VMEM budget), the port still runs its kernels.
"""

from __future__ import annotations

import os

import torch

from fewshot_torch.models.lstm import FORGET_BIAS, cell_update, matmul_f32
from fewshot_torch.ops import _ext
from fewshot_torch.ops._ext import (DTYPE_CODE, check_tensors,
                                    contiguous_as, itemsize, needs_grad,
                                    stream)

# FEWSHOT_LSTM_GATES_INT8=1 stores the train-mode forward's saved gate
# activations int8-coded instead of in the stream dtype (lstm_pallas.py:56):
# sigmoids s -> 2s - 1, tanh j as it is, q = round(127 g), round half to
# even; the backward decodes g = q / 127, then (g + 1) / 2 for the sigmoids
GATES_INT8 = bool(os.environ.get("FEWSHOT_LSTM_GATES_INT8"))

ROUTES = ("step", "persistent")
PERSIST_MAX_HIDDEN = 512     # csrc/lstm_cluster.cuh: 16 blocks of 32 units


def persistent_route(rows: int, hidden: int, dtype: torch.dtype) -> bool:
    """Whether the persistent kernels take (rows, hidden, dtype): bf16 at
    H = 128, 256, 384 or 512 (a cluster of H / 32 blocks, each holding its
    H x 128 slice of Wh in shared memory), any rows.  A mirror of
    csrc/lstm_cluster.cuh persist_ok; everything else takes the step
    kernels."""
    return (dtype == torch.bfloat16 and rows > 0 and hidden % 128 == 0
            and 128 <= hidden <= PERSIST_MAX_HIDDEN)


def _batch_tile(b: int, hidden: int = 0, itemsize: int = 4) -> int:
    """The TPU kernel's batch tile (lstm_pallas.py:59-78): the largest
    divisor of b (<= 256, a multiple of 8 unless b itself) whose per-tile
    VMEM footprint fits 8 MiB."""
    budget = 8 * 2 ** 20
    for cand in range(min(b, 256), 0, -1):
        if b % cand and cand != b:
            continue
        if cand % 8 and cand != b:
            continue
        if hidden and cand * hidden * (10 * 2 * itemsize + 6 * 4) > budget:
            continue
        return cand
    return b


def _tiles(b: int, t: int, hidden: int, itemsize: int,
           streams_h: int = 10) -> tuple[int, int]:
    """The TPU kernel's (batch tile, time chunk) (lstm_pallas.py:93-120),
    FEWSHOT_LSTM_TILES="bt,u" overriding both."""
    override = os.environ.get("FEWSHOT_LSTM_TILES")
    if override:
        bt, u = (int(x) for x in override.split(","))
        return bt, u
    budget = 15 * 2 ** 20 - 4 * hidden * hidden * itemsize      # minus Wh
    bt = _batch_tile(b, hidden, itemsize)

    def fits(u):
        per_row = hidden * (streams_h * 2 * itemsize * u + 6 * 4 + 8 * 4)
        return bt * per_row <= budget
    u = 1
    for cand in range(min(8, t), 0, -1):
        if t % cand == 0 and fits(cand):
            u = cand
            break
    return bt, u


def saved_gates_dtype(rows: int, steps: int, hidden: int,
                      dtype: torch.dtype) -> torch.dtype:
    """The dtype of the saved gates of a [steps, rows, 4H] forward in the
    stream dtype: int8 when GATES_INT8 is set and the TPU kernel's batch
    tile is a multiple of 32 (lstm_pallas.py:198-201), else the stream
    dtype, so that both packages code the same calls."""
    bt, _ = _tiles(rows, steps, hidden, itemsize(dtype))
    return torch.int8 if GATES_INT8 and bt % 32 == 0 else dtype


def code_gates(g: torch.Tensor) -> torch.Tensor:
    """fp32 gate activations [.., 4H] (si, tj, sf, so) -> int8 codes."""
    si, tj, sf, so = g.chunk(4, dim=-1)
    coded = torch.cat([2.0 * si - 1.0, tj, 2.0 * sf - 1.0, 2.0 * so - 1.0],
                      dim=-1)
    return torch.round(coded * 127.0).to(torch.int8)


def decode_gates(q: torch.Tensor) -> torch.Tensor:
    """int8 codes [.., 4H] -> fp32 gate activations (si, tj, sf, so)."""
    g = q.float() * (1.0 / 127.0)
    si, tj, sf, so = g.chunk(4, dim=-1)
    return torch.cat([(si + 1.0) * 0.5, tj, (sf + 1.0) * 0.5,
                      (so + 1.0) * 0.5], dim=-1)


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
    _check_fp32({"b": (b, (four_h,)), "mask": (mask, (t_, b_, 1)),
                 "h0": (h0, (b_, hidden)), "c0": (c0, (b_, hidden))})
    check_tensors(zx, wh, b, mask, h0, c0)


def _check_bwd_inputs(gates, wh, mask, cs, c0, dys, dhT, dcT) -> None:
    t_, b_, four_h = gates.shape
    hidden = four_h // 4
    if dys.dtype not in DTYPE_CODE or {wh.dtype, cs.dtype} != {dys.dtype} \
            or gates.dtype not in (dys.dtype, torch.int8):
        raise TypeError("wh/cs/dys must share fp32 or bf16, gates that "
                        "dtype or int8")
    if hidden % 32 or tuple(wh.shape) != (hidden, four_h) \
            or tuple(cs.shape) != (t_, b_, hidden) \
            or tuple(dys.shape) != (t_, b_, hidden):
        raise ValueError(f"bad shapes gates {tuple(gates.shape)}, wh "
                         f"{tuple(wh.shape)}, cs {tuple(cs.shape)}, dys "
                         f"{tuple(dys.shape)}")
    _check_fp32({"mask": (mask, (t_, b_, 1)), "c0": (c0, (b_, hidden)),
                 "dhT": (dhT, (b_, hidden)), "dcT": (dcT, (b_, hidden))})
    check_tensors(gates, wh, mask, cs, c0, dys, dhT, dcT)


def pick_route(route, fits: bool, shape: str) -> str:
    """The route a call takes: by shape (fits: the persistent kernels take
    it) unless named; a named persistent route on a shape it does not take
    raises."""
    if route is None:
        return "persistent" if fits else "step"
    if route not in ROUTES or (route == "persistent" and not fits):
        raise ValueError(f"route {route!r} does not take {shape}")
    return route


def _route(route, rows: int, hidden: int, dtype: torch.dtype) -> str:
    return pick_route(route, persistent_route(rows, hidden, dtype),
                      f"rows={rows}, hidden={hidden}, {dtype}")


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


def lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0, save_gates=False,
                         gates_dtype=None):
    """Plain PyTorch twin of the forward kernels: the same function, step
    by step.

    zx [T,B,4H] stream dtype; wh [H,4H] compute dtype; b [4H] fp32; mask
    [T,B,1] fp32 (1 = real step); h0/c0 [B,H] fp32.
    Returns (ys, cs) [T,B,H] in the stream dtype and (hT, cT) [B,H] fp32,
    then with save_gates the gate activations [T,B,4H] in gates_dtype (the
    stream dtype by default, or torch.int8: coded)."""
    gdt = gates_dtype or zx.dtype
    w = wh.float()
    h, c = h0, c0
    ys, cs, gates = [], [], []
    for t in range(zx.shape[0]):
        z = zx[t].float() + h.to(wh.dtype).float() @ w + b
        if save_gates:
            acts = gate_acts(z)
            gates.append(code_gates(acts) if gdt == torch.int8
                         else acts.to(gdt))
        new_h, new_c = cell_update(z, c)
        live = mask[t] > 0
        h = torch.where(live, new_h, h)
        c = torch.where(live, new_c, c)
        ys.append(h.to(zx.dtype))
        cs.append(c.to(zx.dtype))
    if not ys:
        empty = zx.new_empty((0,) + tuple(h0.shape))
        out = (empty, empty, h, c)
        return out + (zx.new_empty(zx.shape, dtype=gdt),) if save_gates \
            else out
    out = (torch.stack(ys), torch.stack(cs), h, c)
    return out + (torch.stack(gates),) if save_gates else out


def lstm_layer_fwd(zx, wh, b, mask, h0, c0, save_gates=False, route=None,
                   gates_dtype=None):
    """One layer's recurrence: the CUDA kernels on CUDA tensors, the plain
    twin on CPU tensors.  Same arguments and results as the twin; route
    (None: by shape) names the kernels, gates_dtype (None: the
    ``saved_gates_dtype`` rule) the saved gates' dtype.

    ``lstm_layer_fwd.launches`` counts the calls that launched a kernel,
    ``lstm_layer_fwd.route_launches`` them by route (one call launches the
    persistent kernel once, or one step kernel per time step)."""
    _check_inputs(zx, wh, b, mask, h0, c0)
    t_, b_, four_h = zx.shape
    hidden = four_h // 4
    route = _route(route, b_, hidden, zx.dtype)
    gdt = None
    if save_gates:
        gdt = gates_dtype or saved_gates_dtype(b_, t_, hidden, zx.dtype)
        if gdt not in (zx.dtype, torch.int8):
            raise TypeError(f"gates must be {zx.dtype} or int8, not {gdt}")
    if zx.device.type == "cpu":
        return lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0, save_gates, gdt)
    if zx.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {zx.device}")
    lib = _ext.load("lstm_fwd")
    gates_code = int(gdt == torch.int8)
    # every input is on zx's device (_check_inputs); the outputs go there
    # too, and the launch runs with that device current, on its stream
    with torch.cuda.device(zx.device):
        ys = torch.empty((t_, b_, hidden), dtype=zx.dtype, device=zx.device)
        cs = torch.empty_like(ys)
        gates = (torch.empty(zx.shape, dtype=gdt, device=zx.device)
                 if save_gates else None)
        gates_ptr = gates.data_ptr() if save_gates else None
        if route == "persistent":
            h, c = torch.empty_like(h0), torch.empty_like(c0)
            # h's exchange between a cluster's blocks: two halves of
            # [32-row tiles, 32, H]
            xh = torch.empty((2, (b_ + 31) // 32 * 32, hidden),
                             dtype=zx.dtype, device=zx.device)
            err = lib.lstm_fwd_persist(
                zx.data_ptr(), wh.data_ptr(), b.data_ptr(), mask.data_ptr(),
                h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), cs.data_ptr(),
                gates_ptr, h.data_ptr(), c.data_ptr(), xh.data_ptr(), t_, b_,
                hidden, DTYPE_CODE[zx.dtype], gates_code, stream(zx))
        else:
            h_buf = torch.empty((2, b_, hidden), dtype=torch.float32,
                                device=zx.device)
            h_buf[0].copy_(h0)
            c = c0.clone()
            err = lib.lstm_fwd_layer(
                zx.data_ptr(), wh.data_ptr(), b.data_ptr(), mask.data_ptr(),
                h_buf.data_ptr(), c.data_ptr(), ys.data_ptr(), cs.data_ptr(),
                gates_ptr, t_, b_, hidden, DTYPE_CODE[zx.dtype], gates_code,
                stream(zx))
            h = h_buf[t_ % 2]
    _ext.check(err, f"lstm_fwd ({route})")
    lstm_layer_fwd.launches += 1
    lstm_layer_fwd.route_launches[route] += 1
    out = (ys, cs, h, c)
    return out + (gates,) if save_gates else out


lstm_layer_fwd.launches = 0
lstm_layer_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def lstm_layer_bwd_plain(gates, wh, mask, cs, c0, dys, dhT, dcT):
    """Plain PyTorch twin of the backward kernels: reverse-time BPTT with
    the arithmetic of fewshot/ops/lstm_pallas.py _bwd_kernel.

    gates [T,B,4H] in the stream dtype or int8-coded (decoded first), cs
    and dys [T,B,H] in the stream dtype; wh [H,4H] compute dtype; mask
    [T,B,1], c0, dhT, dcT [B,H] fp32.  c_{t-1} and tanh(c_t) come from the
    stream-dtype cs (c0 at t = 0); dz is stored in the stream dtype and
    rounded to the weight dtype for dz @ Wh^T.
    Returns dzx [T,B,4H] (stream dtype), dh0, dc0 [B,H] and db [4H]
    (fp32, the sum of the unrounded dz)."""
    acts = decode_gates if gates.dtype == torch.int8 else torch.Tensor.float
    wt = wh.float().T
    dh_c, dc_c = dhT, dcT
    db = torch.zeros(gates.shape[-1], device=gates.device)
    dzx = []
    for t in reversed(range(gates.shape[0])):
        c_prev = cs[t - 1].float() if t > 0 else c0
        mf = (mask[t] > 0).float()
        dh = dys[t].float() + dh_c
        dz, dc_c = cell_bwd(acts(gates[t]), cs[t].float(), c_prev, dh, dc_c,
                            mf)
        dzx.append(dz.to(dys.dtype))
        db = db + dz.sum(dim=0)
        dh_c = dz.to(wh.dtype).float() @ wt + (1.0 - mf) * dh
    if not dzx:
        return dys.new_empty(gates.shape), dh_c, dc_c, db
    return torch.stack(dzx[::-1]), dh_c, dc_c, db


def lstm_layer_bwd(gates, wh, mask, cs, c0, dys, dhT, dcT, route=None):
    """One layer's BPTT: the CUDA kernels on CUDA tensors, the plain twin
    on CPU tensors.  Same arguments and results as the twin; route (None:
    by shape) names the kernels.

    ``lstm_layer_bwd.launches`` counts the calls that launched a kernel,
    ``lstm_layer_bwd.route_launches`` them by route (one call launches the
    persistent kernel once, or T + 1 step kernels)."""
    _check_bwd_inputs(gates, wh, mask, cs, c0, dys, dhT, dcT)
    t_, b_, four_h = gates.shape
    hidden = four_h // 4
    route = _route(route, b_, hidden, dys.dtype)
    if gates.device.type == "cpu":
        return lstm_layer_bwd_plain(gates, wh, mask, cs, c0, dys, dhT, dcT)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {gates.device}")
    lib = _ext.load("lstm_bwd")
    gates_code = int(gates.dtype == torch.int8)
    with torch.cuda.device(gates.device):
        dzx = torch.empty(gates.shape, dtype=dys.dtype, device=gates.device)
        if route == "persistent":
            dh, dc = torch.empty_like(dhT), torch.empty_like(dcT)
            # one partial of db per 32-row tile, every entry written; the
            # dh partials' exchange, two halves of [tiles, H, H] fp32
            tiles = (b_ + 31) // 32
            db = torch.empty((tiles, four_h), device=gates.device)
            xbuf = torch.empty((2, tiles, hidden, hidden),
                               device=gates.device)
            err = lib.lstm_bwd_persist(
                gates.data_ptr(), wh.data_ptr(), mask.data_ptr(),
                cs.data_ptr(), c0.data_ptr(), dys.data_ptr(), dhT.data_ptr(),
                dcT.data_ptr(), dh.data_ptr(), dc.data_ptr(), dzx.data_ptr(),
                db.data_ptr(), xbuf.data_ptr(), t_, b_, hidden,
                DTYPE_CODE[dys.dtype], gates_code, stream(gates))
        else:
            dh = dhT.clone()
            dc = dcT.clone()
            # per-row-block partials of db (16-row blocks, the narrowest
            # tile)
            db = torch.zeros(((b_ + 15) // 16, four_h), device=gates.device)
            err = lib.lstm_bwd_layer(
                gates.data_ptr(), wh.data_ptr(), mask.data_ptr(),
                cs.data_ptr(), c0.data_ptr(), dys.data_ptr(), dh.data_ptr(),
                dc.data_ptr(), dzx.data_ptr(), db.data_ptr(), t_, b_, hidden,
                DTYPE_CODE[dys.dtype], gates_code, stream(gates))
    _ext.check(err, f"lstm_bwd ({route})")
    lstm_layer_bwd.launches += 1
    lstm_layer_bwd.route_launches[route] += 1
    return dzx, dh, dc, db.sum(dim=0)


lstm_layer_bwd.launches = 0
lstm_layer_bwd.route_launches = dict.fromkeys(ROUTES, 0)


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
