"""Single-layer LSTM recurrence: CUDA kernel, its plain twin, and the adapter.

Port of the forward half of ``fewshot/ops/lstm_pallas.py``.  The input
projection zx = x @ Wx for all steps is one large product outside the
kernel; the kernel runs the sequential part: per step h @ Wh, the gates and
the masked state update (``csrc/lstm_fwd.cu``, ``lstm_fwd_layer``).

Streams (zx, ys, cs) are bf16 when the compute dtype is bf16 and fp32
otherwise; the carried h and c are always fp32, as in the TPU kernel.

``lstm_layer_fwd`` runs the kernel on CUDA tensors and the plain twin on
CPU tensors; there is no fallback from one to the other.  Both refuse a
hidden size whose narrowest kernel tile does not fit in one block's shared
memory.  The backward kernel is not ported yet, so the wrapper refuses
tensors that need grads.
"""

from __future__ import annotations

import torch

from fewshot_torch.models.lstm import cell_update, matmul_f32
from fewshot_torch.ops import _ext

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_BYTES = 227 * 1024        # shared memory one block may use (H100)


def max_hidden(dtype: torch.dtype) -> int:
    """The largest hidden size the kernels take in dtype.

    Their narrowest tile (csrc/lstm_fwd.cu: 16 rows x 4 units) stages 16
    fp32 h rows of H + 4 floats and the H x 16 weight columns of its units
    in shared memory."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_unit = 16 * 4 + 16 * itemsize
    return (_SMEM_BYTES - 16 * 4 * 4) // per_unit // 32 * 32


def contiguous_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous copy of x (any strides) in dtype, in one pass."""
    return torch.empty(x.shape, dtype=dtype, device=x.device).copy_(x)


def _check_inputs(zx, wh, b, mask, h0, c0) -> None:
    t_, b_, four_h = zx.shape
    hidden = four_h // 4
    if zx.dtype not in _DTYPE_CODE or wh.dtype != zx.dtype:
        raise TypeError(f"zx/wh must share fp32 or bf16, got {zx.dtype}, "
                        f"{wh.dtype}")
    if four_h % 4 or hidden % 32 or tuple(wh.shape) != (hidden, four_h):
        raise ValueError(f"bad shapes zx {tuple(zx.shape)}, wh "
                         f"{tuple(wh.shape)} (H must be a multiple of 32)")
    check_hidden(hidden, zx.dtype)
    want = {"b": (b, (four_h,)), "mask": (mask, (t_, b_, 1)),
            "h0": (h0, (b_, hidden)), "c0": (c0, (b_, hidden))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be fp32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    check_tensors(zx, wh, b, mask, h0, c0)


def check_hidden(hidden: int, dtype: torch.dtype) -> None:
    """Raise on a hidden size past the kernels' shared-memory limit."""
    if hidden > max_hidden(dtype):
        raise ValueError(
            f"hidden size {hidden} exceeds the LSTM kernels' limit of "
            f"{max_hidden(dtype)} for {dtype} (one block's shared memory)")


def check_tensors(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one device, without grads."""
    for x in tensors:
        if x.device != tensors[0].device or not x.is_contiguous():
            raise ValueError("inputs must be contiguous, on one device")
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "the LSTM backward kernel is not ported yet; run the "
                "forward under torch.no_grad()")


def lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0):
    """Plain PyTorch twin of the kernel: the same function, step by step.

    zx [T,B,4H] stream dtype; wh [H,4H] compute dtype; b [4H] fp32; mask
    [T,B,1] fp32 (1 = real step); h0/c0 [B,H] fp32.
    Returns (ys, cs) [T,B,H] in the stream dtype and (hT, cT) [B,H] fp32."""
    w = wh.float()
    h, c = h0, c0
    ys, cs = [], []
    for t in range(zx.shape[0]):
        z = zx[t].float() + h.to(wh.dtype).float() @ w + b
        new_h, new_c = cell_update(z, c)
        live = mask[t] > 0
        h = torch.where(live, new_h, h)
        c = torch.where(live, new_c, c)
        ys.append(h.to(zx.dtype))
        cs.append(c.to(zx.dtype))
    if not ys:
        empty = zx.new_empty((0,) + tuple(h0.shape))
        return empty, empty, h, c
    return torch.stack(ys), torch.stack(cs), h, c


def lstm_layer_fwd(zx, wh, b, mask, h0, c0):
    """One layer's recurrence: the CUDA kernel on CUDA tensors, the plain
    twin on CPU tensors.  Same arguments and results as the twin.

    ``lstm_layer_fwd.launches`` counts the calls that launched the kernel
    (one call launches one step kernel per time step)."""
    _check_inputs(zx, wh, b, mask, h0, c0)
    if zx.device.type == "cpu":
        return lstm_layer_fwd_plain(zx, wh, b, mask, h0, c0)
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
        err = lib.lstm_fwd_layer(
            zx.data_ptr(), wh.data_ptr(), b.data_ptr(), mask.data_ptr(),
            h_buf.data_ptr(), c.data_ptr(), ys.data_ptr(), cs.data_ptr(),
            t_, b_, hidden, _DTYPE_CODE[zx.dtype],
            torch.cuda.current_stream(zx.device).cuda_stream)
    _ext.check(err, "lstm_fwd_layer")
    lstm_layer_fwd.launches += 1
    return ys, cs, h_buf[t_ % 2], c


lstm_layer_fwd.launches = 0


def lstm_layer_pallas(layer, x, mask, h0c0, compute_dtype, zx=None):
    """Drop-in replacement for models.lstm._layer_scan (same signature).

    zx: optional precomputed input projection [B, T, 4H]; x is then
    ignored.  Returns (ys [B, T, H] fp32, (hT, cT))."""
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
    wh = layer.wh.to(compute_dtype).contiguous()
    ys, _cs, hT, cT = lstm_layer_fwd(
        zx_t, wh, layer.b.float().contiguous(), mask_t,
        h0.float().contiguous(), c0.float().contiguous())
    return ys.transpose(0, 1).float(), (hT, cT)
