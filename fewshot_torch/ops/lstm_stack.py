"""Multi-layer LSTM recurrence: CUDA kernels, their plain twins, the
autograd Function, the adapter and the routing predicate.

Port of ``fewshot/ops/lstm_fused.py``.  All L layers advance inside one time
step (``csrc/lstm_fwd.cu``, ``lstm_fwd_stack``): layer 0 reads the
precomputed projection zx = x @ Wx_0, and each layer l >= 1 projects layer
l-1's masked fp32 h of the same step inside the kernel, so the inter-layer
activations never round through a stream.  The backward
(``csrc/lstm_bwd.cu``, ``lstm_bwd_stack``) runs all layers of one step in
reverse time, top layer first; a lower layer's incoming dh is the layer
above's dz contracted with its Wx^T inside the kernel.  dWh and dWx are bulk
products over the saved streams.

``stack_fused_supported`` is a copy of the JAX package's predicate,
including its TPU VMEM arithmetic, so that one config runs the same kernel
family in both packages; the autograd Function keeps the JAX package's
refusal to differentiate a shape admitted only in eval mode.
"""

from __future__ import annotations

import torch

from fewshot_torch.models.lstm import cell_update, matmul_f32
from fewshot_torch.ops import _ext
from fewshot_torch.ops._ext import (DTYPE_CODE, check_tensors, contiguous_as,
                                    needs_grad, stream)
from fewshot_torch.ops.lstm_layer import (_check_fp32, cell_bwd, check_hidden,
                                          check_hidden_bwd, gate_acts,
                                          weight_grad)


def _check_inputs(zx, wx_rest, wh, b, mask, h0, c0) -> None:
    t_, b_, four_h = zx.shape
    n_layers, hidden = wh.shape[0], four_h // 4
    if zx.dtype not in DTYPE_CODE or wh.dtype != zx.dtype \
            or wx_rest.dtype != zx.dtype:
        raise TypeError("zx/wx_rest/wh must share fp32 or bf16")
    if n_layers < 2:
        raise ValueError("the fused kernel runs stacks of 2 or more layers")
    if hidden % 32 or tuple(wh.shape) != (n_layers, hidden, four_h) \
            or tuple(wx_rest.shape) != (n_layers - 1, hidden, four_h):
        raise ValueError(f"bad shapes zx {tuple(zx.shape)}, wx_rest "
                         f"{tuple(wx_rest.shape)}, wh {tuple(wh.shape)}")
    check_hidden(hidden, zx.dtype)
    _check_fp32({"b": (b, (n_layers, four_h)), "mask": (mask, (t_, b_, 1)),
                 "h0": (h0, (n_layers, b_, hidden)),
                 "c0": (c0, (n_layers, b_, hidden))})
    check_tensors(zx, wx_rest, wh, b, mask, h0, c0)


def _check_bwd_inputs(gates, wx_rest, wh, mask, cs, c0, dys, dhT,
                      dcT) -> None:
    n_layers, t_, b_, four_h = gates.shape
    hidden = four_h // 4
    if gates.dtype not in DTYPE_CODE or \
            {wx_rest.dtype, wh.dtype, cs.dtype, dys.dtype} != {gates.dtype}:
        raise TypeError("gates/wx_rest/wh/cs/dys must share fp32 or bf16")
    if n_layers < 2:
        raise ValueError("the fused kernel runs stacks of 2 or more layers")
    if hidden % 32 or tuple(wh.shape) != (n_layers, hidden, four_h) \
            or tuple(wx_rest.shape) != (n_layers - 1, hidden, four_h) \
            or tuple(cs.shape) != (n_layers, t_, b_, hidden) \
            or tuple(dys.shape) != (t_, b_, hidden):
        raise ValueError(f"bad shapes gates {tuple(gates.shape)}, wx_rest "
                         f"{tuple(wx_rest.shape)}, wh {tuple(wh.shape)}, cs "
                         f"{tuple(cs.shape)}, dys {tuple(dys.shape)}")
    check_hidden_bwd(hidden, gates.dtype)
    state = (n_layers, b_, hidden)
    _check_fp32({"mask": (mask, (t_, b_, 1)), "c0": (c0, state),
                 "dhT": (dhT, state), "dcT": (dcT, state)})
    check_tensors(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT)


def lstm_stack_fwd_plain(zx, wx_rest, wh, b, mask, h0, c0, save_gates=False):
    """Plain PyTorch twin of the fused forward kernel, step by step.

    zx [T,B,4H] stream dtype (layer-0 projection); wx_rest [L-1,H,4H] and
    wh [L,H,4H] compute dtype; b [L,4H] fp32; mask [T,B,1] fp32; h0/c0
    [L,B,H] fp32.  Returns (ys, cs) [L,T,B,H] in the stream dtype and
    (hT, cT) [L,B,H] fp32, then with save_gates the gate activations
    [L,T,B,4H] in the stream dtype."""
    n_layers = wh.shape[0]
    wxf, whf = wx_rest.float(), wh.float()
    h = list(h0.unbind(0))
    c = list(c0.unbind(0))
    ys = [[] for _ in range(n_layers)]
    cs = [[] for _ in range(n_layers)]
    gates = [[] for _ in range(n_layers)]
    for t in range(zx.shape[0]):
        live = mask[t] > 0
        inp = None
        for l in range(n_layers):
            if l == 0:
                z = zx[t].float()
            else:
                z = inp.to(wx_rest.dtype).float() @ wxf[l - 1]
            z = z + h[l].to(wh.dtype).float() @ whf[l] + b[l]
            if save_gates:
                gates[l].append(gate_acts(z).to(zx.dtype))
            new_h, new_c = cell_update(z, c[l])
            h[l] = torch.where(live, new_h, h[l])
            c[l] = torch.where(live, new_c, c[l])
            ys[l].append(h[l].to(zx.dtype))
            cs[l].append(c[l].to(zx.dtype))
            inp = h[l]
    if zx.shape[0] == 0:
        empty = zx.new_empty((n_layers, 0) + tuple(h0.shape[1:]))
        out = (empty, empty, h0, c0)
        return (out + (zx.new_empty((n_layers,) + tuple(zx.shape)),)
                if save_gates else out)
    out = (torch.stack([torch.stack(y) for y in ys]),
           torch.stack([torch.stack(s) for s in cs]),
           torch.stack(h), torch.stack(c))
    if save_gates:
        out = out + (torch.stack([torch.stack(g) for g in gates]),)
    return out


def lstm_stack_fwd(zx, wx_rest, wh, b, mask, h0, c0, save_gates=False):
    """The whole stack's recurrence: the CUDA kernel on CUDA tensors, the
    plain twin on CPU tensors.  Same arguments and results as the twin.

    ``lstm_stack_fwd.launches`` counts the calls that launched the kernel
    (one call launches L step kernels per time step)."""
    _check_inputs(zx, wx_rest, wh, b, mask, h0, c0)
    if zx.device.type == "cpu":
        return lstm_stack_fwd_plain(zx, wx_rest, wh, b, mask, h0, c0,
                                    save_gates)
    if zx.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {zx.device}")
    t_, b_, four_h = zx.shape
    n_layers, hidden = wh.shape[0], four_h // 4
    lib = _ext.load("lstm_fwd")
    # as in lstm_layer_fwd: inputs and outputs on zx's device, made current
    with torch.cuda.device(zx.device):
        h_buf = torch.empty((2, n_layers, b_, hidden), dtype=torch.float32,
                            device=zx.device)
        h_buf[0].copy_(h0)
        c = c0.clone()
        ys = torch.empty((n_layers, t_, b_, hidden), dtype=zx.dtype,
                         device=zx.device)
        cs = torch.empty_like(ys)
        gates = (torch.empty((n_layers, t_, b_, four_h), dtype=zx.dtype,
                             device=zx.device) if save_gates else None)
        err = lib.lstm_fwd_stack(
            zx.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(), b.data_ptr(),
            mask.data_ptr(), h_buf.data_ptr(), c.data_ptr(), ys.data_ptr(),
            cs.data_ptr(), gates.data_ptr() if save_gates else None, t_, b_,
            hidden, n_layers, DTYPE_CODE[zx.dtype], stream(zx))
    _ext.check(err, "lstm_fwd_stack")
    lstm_stack_fwd.launches += 1
    out = (ys, cs, h_buf[t_ % 2], c)
    return out + (gates,) if save_gates else out


lstm_stack_fwd.launches = 0


def lstm_stack_bwd_plain(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT):
    """Plain PyTorch twin of the fused backward kernel: the arithmetic of
    fewshot/ops/lstm_fused.py _bwd_kernel, step by step.

    gates [L,T,B,4H], cs [L,T,B,H] and dys [T,B,H] (the top layer's
    cotangent) in the stream dtype; wx_rest [L-1,H,4H], wh [L,H,4H]
    compute dtype; mask [T,B,1], c0, dhT, dcT [L,B,H] fp32.  Per step the
    layers run top first; layer l < L-1 receives dz_{l+1} @ Wx_{l+1}^T.
    Returns dzx [L,T,B,4H] (stream dtype), dh0, dc0 [L,B,H] and db
    [L,4H] fp32."""
    n_layers, t_ = gates.shape[:2]
    wxt = [w.float().T for w in wx_rest]
    wht = [w.float().T for w in wh]
    dh_c = list(dhT.unbind(0))
    dc_c = list(dcT.unbind(0))
    db = torch.zeros(gates.shape[0], gates.shape[-1], device=gates.device)
    dzx = [[] for _ in range(n_layers)]
    for t in reversed(range(t_)):
        mf = (mask[t] > 0).float()
        ext = dys[t].float()
        for l in reversed(range(n_layers)):
            dh = ext + dh_c[l]
            c_prev = cs[l, t - 1].float() if t > 0 else c0[l]
            dz, dc_c[l] = cell_bwd(gates[l, t].float(), cs[l, t].float(),
                                   c_prev, dh, dc_c[l], mf)
            dzx[l].append(dz.to(dys.dtype))
            db[l] += dz.sum(dim=0)
            if l > 0:
                ext = dz.to(wx_rest.dtype).float() @ wxt[l - 1]
            dh_c[l] = dz.to(wh.dtype).float() @ wht[l] + (1.0 - mf) * dh
    if t_ == 0:
        return gates.new_empty(gates.shape), dhT, dcT, db
    return (torch.stack([torch.stack(d[::-1]) for d in dzx]),
            torch.stack(dh_c), torch.stack(dc_c), db)


def lstm_stack_bwd(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT):
    """The whole stack's BPTT: the CUDA kernel on CUDA tensors, the plain
    twin on CPU tensors.  Same arguments and results as the twin.

    ``lstm_stack_bwd.launches`` counts the calls that launched the kernel
    (one call launches L step kernels per time step, plus L)."""
    _check_bwd_inputs(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT)
    if gates.device.type == "cpu":
        return lstm_stack_bwd_plain(gates, wx_rest, wh, mask, cs, c0, dys,
                                    dhT, dcT)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {gates.device}")
    n_layers, t_, b_, four_h = gates.shape
    lib = _ext.load("lstm_bwd")
    with torch.cuda.device(gates.device):
        dh = dhT.clone()
        dc = dcT.clone()
        dzx = torch.empty_like(gates)
        db = torch.zeros(((b_ + 15) // 16, n_layers, four_h),
                         device=gates.device)
        err = lib.lstm_bwd_stack(
            gates.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(),
            mask.data_ptr(), cs.data_ptr(), c0.data_ptr(), dys.data_ptr(),
            dh.data_ptr(), dc.data_ptr(), dzx.data_ptr(), db.data_ptr(), t_,
            b_, four_h // 4, n_layers, DTYPE_CODE[gates.dtype],
            stream(gates))
    _ext.check(err, "lstm_bwd_stack")
    lstm_stack_bwd.launches += 1
    return dzx, dh, dc, db.sum(dim=0)


lstm_stack_bwd.launches = 0


def check_train_tiles(rows: int, hidden: int, n_layers: int,
                      dtype: torch.dtype) -> None:
    """The JAX package's refusal (lstm_fused.py _vjp_fwd): differentiating
    a shape that the fused stack admits only in eval mode raises."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    fw, bw = _stream_widths(n_layers, True)
    per_layer = _batch_tile(rows, hidden, itemsize)
    if (_fused_batch_tile(rows, hidden, n_layers, itemsize, fw) < per_layer
            or _fused_batch_tile(rows, hidden, n_layers, itemsize, bw)
            < per_layer):
        raise ValueError(
            "lstm_stack: differentiating a shape that is only eligible for "
            "the fused stack in eval_mode (forward-only footprint); use the "
            "per-layer kernels for training at this shape (models/lstm.py "
            "routes there when stack_fused_supported(..., eval_mode=False) "
            "is False)")


class LSTMStackFn(torch.autograd.Function):
    """lstm_stack_pallas with its custom VJP.

    (zx, wx_rest, wh, b, mask, h0, c0) -> (top-layer ys [T,B,H] stream
    dtype, hT [L,B,H], cT [L,B,H])."""

    @staticmethod
    def forward(ctx, zx, wx_rest, wh, b, mask, h0, c0):
        n_layers, hidden = wh.shape[0], wh.shape[1]
        check_train_tiles(zx.shape[1], hidden, n_layers, wh.dtype)
        check_hidden_bwd(hidden, wh.dtype)
        ys, cs, hT, cT, gates = lstm_stack_fwd(zx, wx_rest, wh, b, mask, h0,
                                               c0, save_gates=True)
        ctx.save_for_backward(wx_rest, wh, mask, h0, c0, ys, cs, gates)
        return ys[-1], hT, cT

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys, dhT, dcT):
        wx_rest, wh, mask, h0, c0, ys, cs, gates = ctx.saved_tensors
        dys = (torch.zeros_like(ys[-1]) if dys is None
               else dys.to(ys.dtype).contiguous())
        dhT = torch.zeros_like(h0) if dhT is None else dhT.contiguous()
        dcT = torch.zeros_like(c0) if dcT is None else dcT.contiguous()
        dzx, dh0, dc0, db = lstm_stack_bwd(gates, wx_rest, wh, mask, cs, c0,
                                           dys, dhT, dcT)
        if ys.shape[1] == 0:
            return (dzx[0], torch.zeros_like(wx_rest), torch.zeros_like(wh),
                    db, None, dh0, dc0)
        dwh = weight_grad(h0, ys, dzx).to(wh.dtype)
        # input_l[t] = ys_{l-1}[t] for l >= 1: a layer shift, not a time one
        dwx = torch.einsum("ltbh,ltbg->lhg", ys[:-1].float(),
                           dzx[1:].float()).to(wx_rest.dtype)
        return dzx[0], dwx, dwh, db, None, dh0, dc0


def lstm_stack_fused(layers, x, mask, state, compute_dtype, zx0=None):
    """Run the whole layer stack through the fused kernels.

    Same contract as looping models.lstm._layer_scan over layers: returns
    (top-layer ys [B,T,H] fp32, [(h, c)] per layer).  The caller has
    checked stack_fused_supported.  zx0: optional precomputed layer-0
    projection (x may then be None).  Differentiable, as
    lstm_layer_pallas."""
    b_, t_, _ = (zx0 if x is None else x).shape
    cdt = compute_dtype
    stream_dt = torch.bfloat16 if cdt == torch.bfloat16 else torch.float32
    zx = zx0 if zx0 is not None else matmul_f32(x, layers[0].wx, cdt)
    zx_t = contiguous_as(zx.transpose(0, 1), stream_dt)
    if mask is None:
        mask_t = torch.ones((t_, b_, 1), device=zx.device)
    else:
        mask_t = contiguous_as(mask.transpose(0, 1)[..., None], torch.float32)
    args = (zx_t, torch.stack([l.wx for l in layers[1:]]).to(cdt),
            torch.stack([l.wh for l in layers]).to(cdt),
            torch.stack([l.b for l in layers]).float(), mask_t,
            torch.stack([h for h, _ in state]).float(),
            torch.stack([c for _, c in state]).float())
    if needs_grad(*args):
        ys_top, hT, cT = LSTMStackFn.apply(*args)
    else:
        ys, _cs, hT, cT = lstm_stack_fwd(*args)
        ys_top = ys[-1]
    return (ys_top.transpose(0, 1).float(),
            [(hT[i], cT[i]) for i in range(len(layers))])


# ---------------------------------------------------------------------------
# Routing predicate: a copy of fewshot/ops/lstm_fused.py's, with the TPU
# VMEM arithmetic of _batch_tile / _fused_batch_tile / _stream_widths.
# ---------------------------------------------------------------------------

def _batch_tile(b: int, hidden: int = 0, itemsize: int = 4) -> int:
    """The per-layer TPU kernel's batch tile (fewshot/ops/lstm_pallas.py)."""
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


def _fused_batch_tile(b: int, hidden: int, n_layers: int, itemsize: int,
                      stream_h: int) -> int:
    """The fused TPU kernel's batch tile under its VMEM budget."""
    weight_bytes = (2 * n_layers - 1) * hidden * 4 * hidden * itemsize
    budget = 14 * 2 ** 20 - weight_bytes
    per_row = (hidden * stream_h * 2 * itemsize
               + hidden * n_layers * 4 * 4
               + hidden * 8 * 4)
    for cand in range(min(b, 256), 0, -1):
        if b % cand and cand != b:
            continue
        if cand % 8 and cand != b:
            continue
        if cand * per_row > budget and cand > 8:
            continue
        return cand
    return b


def _stream_widths(n_layers: int, save_gates: bool) -> tuple[int, int]:
    """(fwd, bwd) per-row stream widths in H units for the two passes."""
    fwd = 4 + (6 if save_gates else 4) * n_layers
    bwd = 10 * n_layers + 1
    return fwd, bwd


def stack_fused_supported(layers, compute_dtype, batch_rows: int = 0,
                          eval_mode: bool = False) -> bool:
    """Does this stack run on the fused kernel (else per layer)?

    The same answer as fewshot.ops.lstm_fused.stack_fused_supported for the
    same parameters, dtype, row count and mode."""
    if len(layers) < 2:
        return False
    hidden = layers[0].wh.shape[0]
    if hidden % 128:
        return False
    for p in layers[1:]:
        if p.wx.shape[0] != hidden or p.wh.shape[0] != hidden:
            return False
    itemsize = 2 if compute_dtype == torch.bfloat16 else 4
    n = len(layers)
    weight_bytes = (2 * n - 1) * hidden * 4 * hidden * itemsize
    if weight_bytes > 8 * 2 ** 20:
        return False
    if batch_rows:
        per_layer = _batch_tile(batch_rows, hidden, itemsize)
        if eval_mode:
            fw = _stream_widths(n, False)[0]
            return (_fused_batch_tile(batch_rows, hidden, n, itemsize, fw)
                    >= per_layer)
        fw, bw = _stream_widths(n, True)
        if (_fused_batch_tile(batch_rows, hidden, n, itemsize, fw)
                < per_layer
                or _fused_batch_tile(batch_rows, hidden, n, itemsize, bw)
                < per_layer):
            return False
    return True
