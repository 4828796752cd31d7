"""Multi-layer LSTM recurrence: CUDA kernels, their plain twins, the
autograd Function, the adapter and the routing predicate.

Port of ``fewshot/ops/lstm_fused.py``.  Layer 0 reads the precomputed
projection zx = x @ Wx_0, and each layer l >= 1 projects bf16 of layer
l-1's masked h of the same step; the backward runs in reverse time, top
layer first, and a lower layer's incoming dh is the layer above's bf16 dz
contracted with its Wx^T.  dWh and dWx are bulk products over the saved
streams.

Two routes, chosen by shape (``stack_persistent_route``), never by failure:
bf16 at H = 128..512 (a multiple of 128) with (2L - 1) H / 32 blocks a row
tile within ``STACK_MAX_BLOCKS`` runs the persistent stack
(``csrc/lstm_fwd.cu`` ``lstm_fwd_stack_persist``, ``csrc/lstm_bwd.cu``
``lstm_bwd_stack_persist``): a layer wavefront of 2L - 1 thread-block
clusters per 32-row tile (a recurrence per layer, a projection per layer
above the first) handing off through step flags and rings in L2, one
cooperative launch for as many row tiles as the card holds at once
(``stack_row_splits``).  Co-residency is the launch's contract: a launch
the card cannot hold is refused, never run in part.  fp32, and every other
stack, run the step kernels (``lstm_fwd_stack``, ``lstm_bwd_stack``: one
launch per layer and time step), which share the per-layer step kernels'
chunked contraction and so take every H % 32 == 0: the stack has no width
limit of its own, above what ``stack_fused_supported`` admits (the TPU's
8 MiB weight budget: at most H = 384 fp32 and 512 bf16 for two layers).

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
from fewshot_torch.ops.lstm_layer import (ROUTES, _check_fp32, cell_bwd,
                                          gate_acts, persistent_route,
                                          pick_route, weight_grad)

STACK_MAX_BLOCKS = 96   # csrc/lstm_cluster.cuh kStackMaxBlocks
STACK_RING = 4          # csrc/lstm_cluster.cuh kRingDepth: ring slots
TILE_ROWS = 32          # rows of one row tile (csrc/lstm_cluster.cuh kRows)


def stack_persistent_route(rows: int, hidden: int, layers: int,
                           dtype: torch.dtype) -> bool:
    """Whether the persistent stack kernels take (rows, hidden, layers,
    dtype): the per-layer persistent route's shapes (bf16, H = 128..512 in
    steps of 128), at least 2 layers, and a row tile's 2L - 1 clusters of
    H / 32 blocks within STACK_MAX_BLOCKS.  A mirror of csrc/lstm_cluster.cuh
    stack_persist_ok; everything else takes the step kernels."""
    return (persistent_route(rows, hidden, dtype) and layers >= 2
            and (2 * layers - 1) * (hidden // 32) <= STACK_MAX_BLOCKS)


def stack_row_splits(rows: int, tiles: int) -> list[tuple[int, int]]:
    """The row ranges [lo, hi) of the consecutive launches of one call:
    row tiles never interact, so each launch takes at most `tiles` 32-row
    tiles (as many as the card holds at once)."""
    per = TILE_ROWS * tiles
    return [(lo, min(lo + per, rows)) for lo in range(0, rows, per)]


_tiles_cache: dict = {}


def launch_tiles(kernel: str, hidden: int, layers: int,
                 device: torch.device) -> int:
    """How many row tiles one launch of the persistent stack kernel
    (``lstm_fwd`` or ``lstm_bwd``) holds on this card, from the occupancy
    query; raises where the card cannot hold even one."""
    key = (kernel, hidden, layers, device.index)
    if key not in _tiles_cache:
        fn = getattr(_ext.load(kernel), f"{kernel}_stack_persist_tiles")
        with torch.cuda.device(device):
            _tiles_cache[key] = fn(hidden, layers)
    if _tiles_cache[key] < 1:
        raise RuntimeError(
            f"{kernel}_stack_persist: the card holds no row tile's "
            f"{2 * layers - 1} clusters of {hidden // 32} blocks at once")
    return _tiles_cache[key]


def _route(route, rows: int, hidden: int, layers: int,
           dtype: torch.dtype) -> str:
    return pick_route(route,
                      stack_persistent_route(rows, hidden, layers, dtype),
                      f"rows={rows}, hidden={hidden}, layers={layers}, "
                      f"{dtype}")


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


def lstm_stack_fwd(zx, wx_rest, wh, b, mask, h0, c0, save_gates=False,
                   route=None):
    """The whole stack's recurrence: the CUDA kernels on CUDA tensors, the
    plain twin on CPU tensors.  Same arguments and results as the twin;
    route (None: by shape) names the kernels.

    ``lstm_stack_fwd.launches`` counts the calls that launched a kernel,
    ``lstm_stack_fwd.route_launches`` them by route (a persistent call is
    one launch per ``stack_row_splits`` range; a step call L launches per
    time step)."""
    _check_inputs(zx, wx_rest, wh, b, mask, h0, c0)
    t_, b_, four_h = zx.shape
    n_layers, hidden = wh.shape[0], four_h // 4
    route = _route(route, b_, hidden, n_layers, zx.dtype)
    if zx.device.type == "cpu":
        return lstm_stack_fwd_plain(zx, wx_rest, wh, b, mask, h0, c0,
                                    save_gates)
    if zx.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {zx.device}")
    lib = _ext.load("lstm_fwd")
    # as in lstm_layer_fwd: inputs and outputs on zx's device, made current
    with torch.cuda.device(zx.device):
        ys = torch.empty((n_layers, t_, b_, hidden), dtype=zx.dtype,
                         device=zx.device)
        cs = torch.empty_like(ys)
        gates = (torch.empty((n_layers, t_, b_, four_h), dtype=zx.dtype,
                             device=zx.device) if save_gates else None)
        gates_ptr = gates.data_ptr() if save_gates else None
        if route == "persistent":
            h, c = torch.empty_like(h0), torch.empty_like(c0)
            splits = stack_row_splits(
                b_, launch_tiles("lstm_fwd", hidden, n_layers, zx.device))
            tiles = -(-(splits[0][1] - splits[0][0]) // TILE_ROWS)
            # h's exchange per (tile, layer), x . Wx's ring per (tile,
            # layer >= 1), and per launch the step flags (zero) of each
            # (tile, stage, block)
            xh = torch.empty((tiles, n_layers, 2, TILE_ROWS, hidden),
                             dtype=zx.dtype, device=zx.device)
            ring = torch.empty((tiles, n_layers - 1, STACK_RING, TILE_ROWS,
                                four_h), device=zx.device)
            flags = torch.zeros((len(splits), tiles, 2 * n_layers - 1,
                                 hidden // 32), dtype=torch.int32,
                                device=zx.device)
            for i, (lo, hi) in enumerate(splits):
                err = lib.lstm_fwd_stack_persist(
                    zx.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(),
                    b.data_ptr(), mask.data_ptr(), h0.data_ptr(),
                    c0.data_ptr(), ys.data_ptr(), cs.data_ptr(), gates_ptr,
                    h.data_ptr(), c.data_ptr(), xh.data_ptr(),
                    ring.data_ptr(), flags[i].data_ptr(), t_, b_, lo, hi,
                    hidden, n_layers, DTYPE_CODE[zx.dtype], stream(zx))
                if err:
                    break
        else:
            h_buf = torch.empty((2, n_layers, b_, hidden),
                                dtype=torch.float32, device=zx.device)
            h_buf[0].copy_(h0)
            c = c0.clone()
            err = lib.lstm_fwd_stack(
                zx.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(),
                b.data_ptr(), mask.data_ptr(), h_buf.data_ptr(),
                c.data_ptr(), ys.data_ptr(), cs.data_ptr(), gates_ptr, t_,
                b_, hidden, n_layers, DTYPE_CODE[zx.dtype], stream(zx))
            h = h_buf[t_ % 2]
    _ext.check(err, f"lstm_fwd_stack ({route})")
    lstm_stack_fwd.launches += 1
    lstm_stack_fwd.route_launches[route] += 1
    out = (ys, cs, h, c)
    return out + (gates,) if save_gates else out


lstm_stack_fwd.launches = 0
lstm_stack_fwd.route_launches = dict.fromkeys(ROUTES, 0)


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


def lstm_stack_bwd(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT,
                   route=None):
    """The whole stack's BPTT: the CUDA kernels on CUDA tensors, the plain
    twin on CPU tensors.  Same arguments and results as the twin; route
    (None: by shape) names the kernels.

    ``lstm_stack_bwd.launches`` counts the calls that launched a kernel,
    ``lstm_stack_bwd.route_launches`` them by route (a persistent call is
    one launch per ``stack_row_splits`` range; a step call L launches per
    time step, plus L)."""
    _check_bwd_inputs(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT)
    n_layers, t_, b_, four_h = gates.shape
    hidden = four_h // 4
    route = _route(route, b_, hidden, n_layers, gates.dtype)
    if gates.device.type == "cpu":
        return lstm_stack_bwd_plain(gates, wx_rest, wh, mask, cs, c0, dys,
                                    dhT, dcT)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {gates.device}")
    lib = _ext.load("lstm_bwd")
    with torch.cuda.device(gates.device):
        dzx = torch.empty_like(gates)
        if route == "persistent":
            dh, dc = torch.empty_like(dhT), torch.empty_like(dcT)
            splits = stack_row_splits(
                b_, launch_tiles("lstm_bwd", hidden, n_layers, gates.device))
            tiles = -(-(splits[0][1] - splits[0][0]) // TILE_ROWS)
            # one partial of db per row tile and layer, every entry
            # written; per (tile, stage) the dh partials' exchange (two
            # halves of [H, H] fp32), per (tile, layer < L-1) the ring of
            # the dh from above, and per launch the step flags (zero)
            db = torch.empty((-(-b_ // TILE_ROWS), n_layers, four_h),
                             device=gates.device)
            xbuf = torch.empty((tiles, 2 * n_layers - 1, 2, hidden, hidden),
                               device=gates.device)
            ring = torch.empty((tiles, n_layers - 1, STACK_RING, TILE_ROWS,
                                hidden), device=gates.device)
            flags = torch.zeros((len(splits), tiles, 2 * n_layers - 1,
                                 hidden // 32), dtype=torch.int32,
                                device=gates.device)
            for i, (lo, hi) in enumerate(splits):
                err = lib.lstm_bwd_stack_persist(
                    gates.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(),
                    mask.data_ptr(), cs.data_ptr(), c0.data_ptr(),
                    dys.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
                    dh.data_ptr(), dc.data_ptr(), dzx.data_ptr(),
                    db[lo // TILE_ROWS].data_ptr(), xbuf.data_ptr(),
                    ring.data_ptr(), flags[i].data_ptr(), t_, b_, lo, hi,
                    hidden, n_layers, DTYPE_CODE[gates.dtype],
                    stream(gates))
                if err:
                    break
        else:
            dh = dhT.clone()
            dc = dcT.clone()
            db = torch.zeros(((b_ + 15) // 16, n_layers, four_h),
                             device=gates.device)
            err = lib.lstm_bwd_stack(
                gates.data_ptr(), wx_rest.data_ptr(), wh.data_ptr(),
                mask.data_ptr(), cs.data_ptr(), c0.data_ptr(),
                dys.data_ptr(), dh.data_ptr(), dc.data_ptr(), dzx.data_ptr(),
                db.data_ptr(), t_, b_, hidden, n_layers,
                DTYPE_CODE[gates.dtype], stream(gates))
    _ext.check(err, f"lstm_bwd_stack ({route})")
    lstm_stack_bwd.launches += 1
    lstm_stack_bwd.route_launches[route] += 1
    return dzx, dh, dc, db.sum(dim=0)


lstm_stack_bwd.launches = 0
lstm_stack_bwd.route_launches = dict.fromkeys(ROUTES, 0)


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
    same parameters, dtype, row count and mode.  Its weight budget admits
    no H the stack kernels refuse: they take every H % 32 == 0."""
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
