"""LSTM backbone: TF-gate-order cell, a plain step loop, and the kernel route.

Port of ``fewshot/models/lstm.py``.  The numerics are the reference's: TF
gate order (i, j, f, o), the +1.0 forget bias added inside the cell over a
zero-initialized bias, one glorot-uniform [in+H, 4H] matrix split into
``wx`` [in, 4H] and ``wh`` [H, 4H] (the JAX layouts, kept so that neither
side transposes), and a masked carry: a PAD step leaves (h, c) unchanged.

``cell="scan"`` runs the plain PyTorch step loop; ``cell="pallas"`` routes
to the CUDA recurrence kernels (``fewshot_torch/ops``), choosing between the
fused multi-layer kernel and the per-layer kernel with the same predicate as
the JAX package, so one config runs the same kernel family in both, in
eval and in train mode.  Both routes are differentiable: under
``cell="pallas"`` the backward kernels run in the backward pass.
"""

from __future__ import annotations

import math

import torch
from torch import nn

FORGET_BIAS = 1.0


class LSTMLayer(nn.Module):
    """One layer's parameters: wx [in, 4H], wh [H, 4H], b [4H]."""

    def __init__(self, wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.wx = nn.Parameter(wx)
        self.wh = nn.Parameter(wh)
        self.b = nn.Parameter(b)


def init_lstm_params(input_dim: int, hidden_dim: int, num_layers: int,
                     generator: torch.Generator,
                     device: torch.device | str = "cpu") -> nn.ModuleList:
    """Per-layer glorot-uniform [in+H, 4H] split into wx/wh; zero bias."""
    layers = []
    in_dim = input_dim
    for _ in range(num_layers):
        fan_in, fan_out = in_dim + hidden_dim, 4 * hidden_dim
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        w = (torch.rand(fan_in, fan_out, generator=generator) * 2 - 1) * limit
        layers.append(LSTMLayer(w[:in_dim].contiguous(),
                                w[in_dim:].contiguous(),
                                torch.zeros(4 * hidden_dim)))
        in_dim = hidden_dim
    return nn.ModuleList(layers).to(device)


def zero_state(batch: int, hidden_dim: int, num_layers: int,
               device: torch.device | str = "cpu"
               ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    z = torch.zeros(batch, hidden_dim, device=device)
    return [(z, z) for _ in range(num_layers)]


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to compute_dtype, fp32 result.

    The JAX code multiplies at the compute dtype with fp32 accumulation
    (preferred_element_type=float32).  A bf16 value is exact in fp32, so
    rounding the operands to bf16 and multiplying in fp32 gives that
    result; a bf16 x bf16 torch.matmul would round the result to bf16."""
    return a.to(compute_dtype).float() @ b.to(compute_dtype).float()


def cell_update(z: torch.Tensor, c: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(new_h, new_c) from the gate pre-activations z [.., 4H] (i, j, f, o)."""
    i, j, f, o = torch.chunk(z, 4, dim=-1)
    new_c = (torch.sigmoid(f + FORGET_BIAS) * c
             + torch.sigmoid(i) * torch.tanh(j))
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


def lstm_gates(zx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               wh: torch.Tensor, b: torch.Tensor, compute_dtype
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One cell update given the precomputed input projection zx."""
    return cell_update(zx + matmul_f32(h, wh, compute_dtype) + b, c)


def lstm_step(layers, x: torch.Tensor, state, compute_dtype=torch.float32):
    """Single-timestep multi-layer update for the sampling loop.

    x [B, E] -> (top-layer h [B, H], new per-layer state)."""
    new_state = []
    inp = x
    for layer, (h, c) in zip(layers, state):
        zx = matmul_f32(inp, layer.wx, compute_dtype)
        h, c = lstm_gates(zx, h, c, layer.wh, layer.b, compute_dtype)
        new_state.append((h, c))
        inp = h
    return inp, new_state


def _layer_scan(layer, x: torch.Tensor | None, mask: torch.Tensor | None,
                h0c0, compute_dtype, zx: torch.Tensor | None = None):
    """Run one layer over x [B, T, in] as a plain step loop.

    zx: optional precomputed input projection [B, T, 4H]; x is then
    ignored.  Returns (ys [B, T, H], (h, c))."""
    if zx is None:
        zx = matmul_f32(x, layer.wx, compute_dtype)          # [B, T, 4H]
    h, c = h0c0
    ys = []
    for t in range(zx.shape[1]):
        new_h, new_c = lstm_gates(zx[:, t], h, c, layer.wh, layer.b,
                                  compute_dtype)
        if mask is None:
            h, c = new_h, new_c
        else:
            m = mask[:, t, None]
            h = torch.where(m, new_h, h)
            c = torch.where(m, new_c, c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


def lstm_forward(layers, x: torch.Tensor | None,
                 mask: torch.Tensor | None = None, state=None,
                 compute_dtype=torch.float32, cell: str = "scan",
                 eval_mode: bool = False, zx0: torch.Tensor | None = None):
    """Multi-layer LSTM over embeddings x [B, T, E].

    mask [B, T] bool (False = padding, state held); state: per-layer (h, c)
    initial carries; eval_mode: the caller will not differentiate (admits
    the fused stack at forward-only widths, as in the JAX package); zx0:
    optional precomputed layer-0 projection [B, T, 4H] (x may then be None).
    Returns (top-layer outputs [B, T, H], final per-layer state)."""
    src = zx0 if x is None else x
    b_ = src.shape[0]
    hidden = layers[0].wh.shape[0]
    if state is None:
        state = zero_state(b_, hidden, len(layers), src.device)
    if cell == "pallas":
        from fewshot_torch.ops import lstm_stack
        if lstm_stack.stack_fused_supported(layers, compute_dtype,
                                            batch_rows=b_,
                                            eval_mode=eval_mode):
            return lstm_stack.lstm_stack_fused(layers, x, mask, state,
                                               compute_dtype, zx0=zx0)
        from fewshot_torch.ops.lstm_layer import lstm_layer_pallas
        layer_fn = lstm_layer_pallas
    else:
        layer_fn = _layer_scan
    ys = x
    new_state = []
    for i, (layer, h0c0) in enumerate(zip(layers, state)):
        ys, hc = layer_fn(layer, ys, mask, h0c0, compute_dtype,
                          zx=zx0 if i == 0 else None)
        new_state.append(hc)
    return ys, new_state
