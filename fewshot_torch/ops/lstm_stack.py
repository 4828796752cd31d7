"""Multi-layer LSTM recurrence: CUDA kernel, its plain twin, the adapter and
the routing predicate.

Port of the forward half of ``fewshot/ops/lstm_fused.py``.  All L layers
advance inside one time step (``csrc/lstm_fwd.cu``, ``lstm_fwd_stack``):
layer 0 reads the precomputed projection zx = x @ Wx_0, and each layer
l >= 1 projects layer l-1's masked fp32 h of the same step inside the
kernel, so the inter-layer activations never round through a stream.

``stack_fused_supported`` is a copy of the JAX package's predicate,
including its TPU VMEM arithmetic, so that one config runs the same kernel
family in both packages.
"""

from __future__ import annotations

import torch

from fewshot_torch.models.lstm import cell_update, matmul_f32
from fewshot_torch.ops import _ext
from fewshot_torch.ops.lstm_layer import (_DTYPE_CODE, check_hidden,
                                          check_tensors, contiguous_as)


def _check_inputs(zx, wx_rest, wh, b, mask, h0, c0) -> None:
    t_, b_, four_h = zx.shape
    n_layers, hidden = wh.shape[0], four_h // 4
    if zx.dtype not in _DTYPE_CODE or wh.dtype != zx.dtype \
            or wx_rest.dtype != zx.dtype:
        raise TypeError("zx/wx_rest/wh must share fp32 or bf16")
    if n_layers < 2:
        raise ValueError("the fused kernel runs stacks of 2 or more layers")
    if hidden % 32 or tuple(wh.shape) != (n_layers, hidden, four_h) \
            or tuple(wx_rest.shape) != (n_layers - 1, hidden, four_h):
        raise ValueError(f"bad shapes zx {tuple(zx.shape)}, wx_rest "
                         f"{tuple(wx_rest.shape)}, wh {tuple(wh.shape)}")
    check_hidden(hidden, zx.dtype)
    want = {"b": (b, (n_layers, four_h)), "mask": (mask, (t_, b_, 1)),
            "h0": (h0, (n_layers, b_, hidden)),
            "c0": (c0, (n_layers, b_, hidden))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be fp32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    check_tensors(zx, wx_rest, wh, b, mask, h0, c0)


def lstm_stack_fwd_plain(zx, wx_rest, wh, b, mask, h0, c0):
    """Plain PyTorch twin of the fused kernel, step by step.

    zx [T,B,4H] stream dtype (layer-0 projection); wx_rest [L-1,H,4H] and
    wh [L,H,4H] compute dtype; b [L,4H] fp32; mask [T,B,1] fp32; h0/c0
    [L,B,H] fp32.  Returns (ys, cs) [L,T,B,H] in the stream dtype and
    (hT, cT) [L,B,H] fp32."""
    n_layers = wh.shape[0]
    wxf, whf = wx_rest.float(), wh.float()
    h = list(h0.unbind(0))
    c = list(c0.unbind(0))
    ys = [[] for _ in range(n_layers)]
    cs = [[] for _ in range(n_layers)]
    for t in range(zx.shape[0]):
        live = mask[t] > 0
        inp = None
        for l in range(n_layers):
            if l == 0:
                z = zx[t].float()
            else:
                z = inp.to(wx_rest.dtype).float() @ wxf[l - 1]
            z = z + h[l].to(wh.dtype).float() @ whf[l] + b[l]
            new_h, new_c = cell_update(z, c[l])
            h[l] = torch.where(live, new_h, h[l])
            c[l] = torch.where(live, new_c, c[l])
            ys[l].append(h[l].to(zx.dtype))
            cs[l].append(c[l].to(zx.dtype))
            inp = h[l]
    if zx.shape[0] == 0:
        empty = zx.new_empty((n_layers, 0) + tuple(h0.shape[1:]))
        return empty, empty, h0, c0
    return (torch.stack([torch.stack(y) for y in ys]),
            torch.stack([torch.stack(s) for s in cs]),
            torch.stack(h), torch.stack(c))


def lstm_stack_fwd(zx, wx_rest, wh, b, mask, h0, c0):
    """The whole stack's recurrence: the CUDA kernel on CUDA tensors, the
    plain twin on CPU tensors.  Same arguments and results as the twin.

    ``lstm_stack_fwd.launches`` counts the calls that launched the kernel
    (one call launches L step kernels per time step)."""
    _check_inputs(zx, wx_rest, wh, b, mask, h0, c0)
    if zx.device.type == "cpu":
        return lstm_stack_fwd_plain(zx, wx_rest, wh, b, mask, h0, c0)
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
        err = lib.lstm_fwd_stack(
            zx.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(), b.data_ptr(),
            mask.data_ptr(), h_buf.data_ptr(), c.data_ptr(), ys.data_ptr(),
            cs.data_ptr(), t_, b_, hidden, n_layers, _DTYPE_CODE[zx.dtype],
            torch.cuda.current_stream(zx.device).cuda_stream)
    _ext.check(err, "lstm_fwd_stack")
    lstm_stack_fwd.launches += 1
    return ys, cs, h_buf[t_ % 2], c


lstm_stack_fwd.launches = 0


def lstm_stack_fused(layers, x, mask, state, compute_dtype, zx0=None):
    """Run the whole layer stack through the fused kernel.

    Same contract as looping models.lstm._layer_scan over layers: returns
    (top-layer ys [B,T,H] fp32, [(h, c)] per layer).  The caller has
    checked stack_fused_supported.  zx0: optional precomputed layer-0
    projection (x may then be None)."""
    b_, t_, _ = (zx0 if x is None else x).shape
    cdt = compute_dtype
    stream_dt = torch.bfloat16 if cdt == torch.bfloat16 else torch.float32
    zx = zx0 if zx0 is not None else matmul_f32(x, layers[0].wx, cdt)
    zx_t = contiguous_as(zx.transpose(0, 1), stream_dt)
    if mask is None:
        mask_t = torch.ones((t_, b_, 1), device=zx.device)
    else:
        mask_t = contiguous_as(mask.transpose(0, 1)[..., None], torch.float32)
    wx_rest = torch.stack([l.wx for l in layers[1:]]).to(cdt)
    wh = torch.stack([l.wh for l in layers]).to(cdt)
    b = torch.stack([l.b for l in layers]).float()
    h0 = torch.stack([h for h, _ in state]).float()
    c0 = torch.stack([c for _, c in state]).float()
    ys, _cs, hT, cT = lstm_stack_fwd(zx_t, wx_rest, wh, b, mask_t, h0, c0)
    return (ys[-1].transpose(0, 1).float(),
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
