"""Episodic prefix attention: CUDA kernels, plain twins, the autograd
Function and the public entry points.

Port of ``fewshot/ops/prefix_attention.py``.  Each of an episode's Q query
songs attends to the episode's support PREFIX (key-masked) ++ ITSELF
(causal, key-masked); with no prefix the same function is causal
self-attention (the prefix stream, the KV-cache prefill and ``cfg.flash``).
The TPU package computes it under three VMEM plans (streaming, resident
heads-outer, resident token-major: kernels 7-9); the port has one kernel
family in ``csrc/prefix_attn.cu``, on the token-major layout the QKV
product gives: q/k/v [S, T, E] (S = B Q songs, heads are hd-wide column
slices of E = nh hd), prefix k/v [B, P, E], read in place by the episode's
songs (song s belongs to episode s // Q).

* ``prefix_attn_fwd``: out [S, T, E] and lse [S, nh, T], fp32;
* ``prefix_attn_bwd_dq``: dq, fed the global (lse, delta = rowsum(g out));
* ``prefix_attn_bwd_dkv``: dk/dv of the self branch and, summed over the
  episode's songs, of the prefix.

bf16 streams run the three on tensor cores (``fwd_tc_kernel``,
``dq_tc_kernel``, ``dkv_tc_kernel``: ``mma.sync`` bf16 with fp32 sums);
fp32 streams run the v1 kernels on the fp32 SIMT units.  Both backward
kernels are deterministic: each block owns its outputs, with no atomics.

Rounding points are the TPU kernels': operands in the stream dtype with fp32
products; the unnormalised p rounded to the stream dtype before p v and
divided by l afterwards; g, p and ds rounded before their backward
products; every output fp32, cast to the input dtype by the Function.  The
twins take p against the row's final maximum (the resident plans, kernels
8-9), the kernels against the running maximum of their online softmax (the
streaming plan, kernel 7): in bf16 the two round p at different points.

The kernels take any head width: one that is not a multiple of 16 is
padded with zero columns for the launch (``pad_heads``: a copy of q, k, v,
g and the prefix per call, only at such widths), and past 128 the bf16
kernels are the v1 kernels run as 128-wide column windows
(``csrc/prefix_attn.cu``).  A wrapper runs its kernel on CUDA tensors and
its plain twin on CPU tensors; there is no fallback from one to the
other.  ``launches`` on each
wrapper counts the calls that launched the kernel.
"""

from __future__ import annotations

import math

import torch

from fewshot_torch.ops import _ext
from fewshot_torch.ops._ext import (DTYPE_CODE, check_tensors, needs_grad,
                                    stream)

NEG = -1e30
HD_STEP = 16            # the kernels' head width is a multiple of this


def pad_heads(x: torch.Tensor, nh: int, hdp: int) -> torch.Tensor:
    """[N, T, nh hd] -> [N, T, nh hdp] (contiguous): each head's hd columns
    followed by hdp - hd zero columns.  Zero columns of q, k, v and g leave
    every score, lse and delta unchanged."""
    n, t, e = x.shape
    hd = e // nh
    if hdp == hd:
        return x.contiguous()
    return torch.nn.functional.pad(x.reshape(n, t, nh, hd),
                                   (0, hdp - hd)).reshape(n, t, nh * hdp)


def unpad_heads(x: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    """The inverse of ``pad_heads``: each head's first hd columns."""
    n, t, ep = x.shape
    if ep == nh * hd:
        return x
    return x.view(n, t, nh, ep // nh)[..., :hd].reshape(n, t, nh * hd)


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """[N, T, E] -> [N, nh, T, hd] fp32."""
    n, t, e = x.shape
    return x.float().view(n, t, nh, e // nh).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[N, nh, T, hd] -> [N, T, E]."""
    n, nh, t, hd = x.shape
    return x.transpose(1, 2).reshape(n, t, nh * hd)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _scores(q, k, kmask, pk, pmask, nh):
    """Masked scaled scores, fp32: self [S, nh, T, T] (causal) and prefix
    [B, Q, nh, T, P] (None without a prefix)."""
    s_, t, e = q.shape
    scale = 1.0 / float(e // nh) ** 0.5
    qh = _heads(q, nh)
    s_self = (qh @ _heads(k, nh).transpose(-1, -2)) * scale
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s_self = torch.where((kmask[:, None, None, :] > 0) & causal, s_self, NEG)
    if pk is None:
        return s_self, None
    b = pk.shape[0]
    qe = qh.reshape(b, s_ // b, nh, t, e // nh)
    s_pre = (qe @ _heads(pk, nh)[:, None].transpose(-1, -2)) * scale
    s_pre = torch.where(pmask[:, None, None, None, :] > 0, s_pre, NEG)
    return s_self, s_pre


def prefix_attn_fwd_plain(q, k, v, kmask, pk, pv, pmask, nh):
    """Plain PyTorch twin of the forward kernel.  q/k/v [S, T, E] (bf16 or
    fp32), kmask [S, T] fp32, pk/pv [B, P, E] and pmask [B, P] or None.
    Returns (out [S, T, E], lse [S, nh, T]) fp32."""
    dt = q.dtype
    s_self, s_pre = _scores(q, k, kmask, pk, pmask, nh)
    m = s_self.amax(dim=-1)
    if s_pre is not None:
        m = torch.maximum(m, s_pre.amax(dim=-1).reshape(m.shape))
    p = torch.exp(s_self - m[..., None])
    l = p.sum(dim=-1)
    acc = p.to(dt).float() @ _heads(v, nh)
    if s_pre is not None:
        b = pk.shape[0]
        me = m.reshape(b, -1, *m.shape[1:])
        pp = torch.exp(s_pre - me[..., None])
        l = l + pp.sum(dim=-1).reshape(l.shape)
        acc = acc + (pp.to(dt).float()
                     @ _heads(pv, nh)[:, None]).reshape(acc.shape)
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return _merge_heads(out), m + torch.log(l.clamp_min(1e-30))


def _bwd_plain(q, k, v, kmask, pk, pv, pmask, g, lse, delta, nh):
    """(dq, dk, dv, dpk, dpv) fp32 of the twins (dpk, dpv None without a
    prefix)."""
    dt = q.dtype
    scale = 1.0 / float(q.shape[-1] // nh) ** 0.5
    s_self, s_pre = _scores(q, k, kmask, pk, pmask, nh)
    qh, gh = _heads(q, nh), _heads(g, nh)

    def branch(s, vh, gq, qq, lse_, delta_):
        p = torch.exp(s - lse_[..., None])
        ds = p * (gq @ vh.transpose(-1, -2) - delta_[..., None]) * scale
        ds = ds.to(dt).float()
        return ds, p.to(dt).float().transpose(-1, -2) @ gq, \
            ds.transpose(-1, -2) @ qq

    ds, dv, dk = branch(s_self, _heads(v, nh), gh, qh, lse, delta)
    dq = ds @ _heads(k, nh)
    dpk = dpv = None
    if s_pre is not None:
        b = pk.shape[0]

        def per_ep(x):
            return x.reshape(b, -1, *x.shape[1:])
        ds_p, dpv_q, dpk_q = branch(s_pre, _heads(pv, nh)[:, None],
                                    per_ep(gh), per_ep(qh), per_ep(lse),
                                    per_ep(delta))
        dq = dq + (ds_p @ _heads(pk, nh)[:, None]).reshape(dq.shape)
        dpk, dpv = (_merge_heads(x.sum(dim=1)) for x in (dpk_q, dpv_q))
    return _merge_heads(dq), _merge_heads(dk), _merge_heads(dv), dpk, dpv


def prefix_attn_bwd_dq_plain(q, k, v, kmask, pk, pv, pmask, g, lse, delta,
                             nh):
    """Plain twin of the dq kernel: the forward's inputs, the cotangent g
    [S, T, E] (the stream dtype), lse and delta [S, nh, T] fp32.  Returns
    dq [S, T, E] fp32."""
    return _bwd_plain(q, k, v, kmask, pk, pv, pmask, g, lse, delta, nh)[0]


def prefix_attn_bwd_dkv_plain(q, k, v, kmask, pk, pv, pmask, g, lse, delta,
                              nh):
    """Plain twin of the dk/dv kernel.  Returns (dk, dv) [S, T, E] and, with
    a prefix, (dpk, dpv) [B, P, E] summed over the episode's songs, fp32."""
    _, dk, dv, dpk, dpv = _bwd_plain(q, k, v, kmask, pk, pv, pmask, g, lse,
                                     delta, nh)
    return (dk, dv) if pk is None else (dk, dv, dpk, dpv)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(q, k, v, kmask, pk, pv, pmask, nh, *rest) -> None:
    """rest: the backward's (g, lse, delta): g in the streams' dtype and
    shape, lse and delta fp32 [S, nh, T]."""
    s_, t, e = q.shape
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"streams must be fp32 or bf16, got {q.dtype}")
    if e % nh:
        raise ValueError(f"nh={nh} does not divide E={e}")
    shapes_ok = (k.shape == v.shape == q.shape
                 and k.dtype == v.dtype == q.dtype
                 and tuple(kmask.shape) == (s_, t))
    if pk is not None:
        b = pk.shape[0]
        shapes_ok = shapes_ok and (
            b > 0 and s_ % b == 0 and pk.dim() == 3 and pk.shape[2] == e
            and pv.shape == pk.shape and pk.dtype == pv.dtype == q.dtype
            and tuple(pmask.shape) == tuple(pk.shape[:2]))
    if rest:
        g, lse, delta = rest
        shapes_ok = shapes_ok and (
            g.shape == q.shape and g.dtype == q.dtype
            and tuple(lse.shape) == tuple(delta.shape) == (s_, nh, t)
            and lse.dtype == delta.dtype == torch.float32)
    if not shapes_ok:
        raise ValueError(
            f"bad shapes q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, kmask {tuple(kmask.shape)}, pk "
            f"{None if pk is None else tuple(pk.shape)}")
    devs = {x.device for x in (q, k, v, kmask, pk, pv, pmask, *rest)
            if x is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _launch(fn_name, q, k, v, kmask, pk, pv, pmask, nh, rest, outs):
    """Launch one kernel on contiguous copies of the inputs, each head
    padded with zero columns to a multiple of HD_STEP where it is not one
    (``pad_heads``; the scale stays the unpadded head's); rest: the
    backward's (g, lse, delta); outs: the outputs' kinds, "stream" [S, T,
    E], "prefix" [B, P, E] or "lse" [S, nh, T], fp32.  Returns the
    outputs, unpadded."""
    if q.device.type != "cuda":
        raise ValueError(f"no prefix-attention kernel for device {q.device}")
    s_, t, e = q.shape
    hd = e // nh
    hdp = -(-hd // HD_STEP) * HD_STEP
    p = 0 if pk is None else pk.shape[1]
    q_per_ep = 1 if pk is None else s_ // pk.shape[0]
    ins = [pad_heads(x, nh, hdp) for x in (q, k, v)] + \
        [kmask.float().contiguous()]
    pre = ([None] * 3 if pk is None else
           [pad_heads(pk, nh, hdp), pad_heads(pv, nh, hdp),
            pmask.float().contiguous()])
    if rest:
        g, lse, delta = rest
        rest = [pad_heads(g, nh, hdp), lse.contiguous(), delta.contiguous()]
    shapes = {"stream": (s_, t, nh * hdp), "lse": (s_, nh, t),
              "prefix": (0 if pk is None else pk.shape[0], p, nh * hdp)}
    out = [torch.empty(shapes[kind], device=q.device) for kind in outs]
    check_tensors(*ins, *[x for x in pre if x is not None], *rest, *out)
    lib = _ext.load("prefix_attn")
    ptrs = [x.data_ptr() for x in out] + [None] * (
        4 - len(out) if fn_name == "prefix_attn_bwd_dkv" else 0)
    with torch.cuda.device(q.device):
        err = getattr(lib, fn_name)(
            *(x.data_ptr() for x in ins),
            *(None if x is None else x.data_ptr() for x in pre),
            *(x.data_ptr() for x in rest), *ptrs,
            s_, t, p, q_per_ep, nh, hdp, 1.0 / math.sqrt(hd),
            DTYPE_CODE[q.dtype], stream(q))
    _ext.check(err, fn_name)
    return [x if kind == "lse" else unpad_heads(x, nh, hd)
            for x, kind in zip(out, outs)]


def prefix_attn_fwd(q, k, v, kmask, pk, pv, pmask, nh):
    """The forward: the CUDA kernel on CUDA tensors, the plain twin on CPU
    tensors.  Same arguments and results as ``prefix_attn_fwd_plain``."""
    _check_inputs(q, k, v, kmask, pk, pv, pmask, nh)
    if q.device.type == "cpu":
        return prefix_attn_fwd_plain(q, k, v, kmask, pk, pv, pmask, nh)
    out, lse = _launch("prefix_attn_fwd", q, k, v, kmask, pk, pv, pmask, nh,
                       (), ("stream", "lse"))
    prefix_attn_fwd.launches += 1
    return out, lse


prefix_attn_fwd.launches = 0


def prefix_attn_bwd_dq(q, k, v, kmask, pk, pv, pmask, g, lse, delta, nh):
    """dq: the CUDA kernel on CUDA tensors, the plain twin on CPU tensors.
    Same arguments and result as ``prefix_attn_bwd_dq_plain``."""
    _check_inputs(q, k, v, kmask, pk, pv, pmask, nh, g, lse, delta)
    if q.device.type == "cpu":
        return prefix_attn_bwd_dq_plain(q, k, v, kmask, pk, pv, pmask, g,
                                        lse, delta, nh)
    dq, = _launch("prefix_attn_bwd_dq", q, k, v, kmask, pk, pv, pmask, nh,
                  (g, lse, delta), ("stream",))
    prefix_attn_bwd_dq.launches += 1
    return dq


prefix_attn_bwd_dq.launches = 0


def prefix_attn_bwd_dkv(q, k, v, kmask, pk, pv, pmask, g, lse, delta, nh):
    """dk/dv of both branches: the CUDA kernel (one launch) on CUDA tensors,
    the plain twin on CPU tensors.  Same arguments and results as
    ``prefix_attn_bwd_dkv_plain``."""
    _check_inputs(q, k, v, kmask, pk, pv, pmask, nh, g, lse, delta)
    if q.device.type == "cpu":
        return prefix_attn_bwd_dkv_plain(q, k, v, kmask, pk, pv, pmask, g,
                                         lse, delta, nh)
    kinds = ("stream", "stream") + (() if pk is None else
                                    ("prefix", "prefix"))
    outs = _launch("prefix_attn_bwd_dkv", q, k, v, kmask, pk, pv, pmask, nh,
                   (g, lse, delta), kinds)
    prefix_attn_bwd_dkv.launches += 1
    return tuple(outs)


prefix_attn_bwd_dkv.launches = 0


def _delta(g32: torch.Tensor, out: torch.Tensor, nh: int) -> torch.Tensor:
    """Per-head rowsum(g out): [S, T, E] -> [S, nh, T] fp32."""
    s_, t, e = g32.shape
    return (g32 * out).view(s_, t, nh, e // nh).sum(-1).transpose(1, 2) \
        .contiguous()


class PrefixAttnFn(torch.autograd.Function):
    """(q, k, v, pk, pv) -> out with the kernels' VJP: the backward feeds
    the saved global lse and delta = rowsum(g out) to the dq and dk/dv
    kernels (``fewshot/ops/prefix_attention.py:921-931``).  pk/pv may be
    None (causal self-attention)."""

    @staticmethod
    def forward(ctx, q, k, v, pk, pv, kmask, pmask, nh):
        out, lse = prefix_attn_fwd(q, k, v, kmask, pk, pv, pmask, nh)
        ctx.save_for_backward(q, k, v, pk, pv, kmask, pmask, out, lse)
        ctx.nh = nh
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, pk, pv, kmask, pmask, out, lse = ctx.saved_tensors
        nh = ctx.nh
        g32 = g.float()
        delta = _delta(g32, out, nh)
        gc = g32.to(q.dtype)
        dq = prefix_attn_bwd_dq(q, k, v, kmask, pk, pv, pmask, gc, lse,
                                delta, nh)
        grads = prefix_attn_bwd_dkv(q, k, v, kmask, pk, pv, pmask, gc, lse,
                                    delta, nh)
        dk, dv = grads[:2]
        dpk, dpv = grads[2:] if pk is not None else (None, None)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if dpk is None else dpk.to(pk.dtype),
                None if dpv is None else dpv.to(pv.dtype), None, None, None)


def _attend(q, k, v, kmask, pk, pv, pmask, nh):
    """out [S, T, E] fp32 of the kernels (twins on the CPU), through the
    autograd Function when a grad is needed."""
    tensors = (q, k, v) if pk is None else (q, k, v, pk, pv)
    if needs_grad(*tensors):
        return PrefixAttnFn.apply(q, k, v, pk, pv, kmask, pmask, nh)
    return prefix_attn_fwd(q, k, v, kmask, pk, pv, pmask, nh)[0]


# ---------------------------------------------------------------------------
# public entry points (the JAX package's layouts)
# ---------------------------------------------------------------------------

def prefix_attention(qq, qk, qv, pk, pv, query_mask, prefix_mask
                     ) -> torch.Tensor:
    """Episodic attention: query songs attend (shared prefix ++ self-causal).

    qq/qk/qv [B, Q, Lq, nh, hd]; pk/pv [B, P, nh, hd]; query_mask [B, Q,
    Lq] bool (key side), prefix_mask [B, P] bool.  Returns [B, Q, Lq, E]
    fp32, E = nh hd, without the [B, Q, nh, Lq, P + Lq] scores."""
    b, q_, lq, nh, hd = qq.shape
    e = nh * hd
    p = pk.shape[1]

    def songs(x):
        return x.reshape(b * q_, lq, e)
    out = _attend(songs(qq), songs(qk), songs(qv),
                  query_mask.reshape(b * q_, lq).float(),
                  pk.reshape(b, p, e), pv.reshape(b, p, e),
                  prefix_mask.float(), nh)
    return out.view(b, q_, lq, e)


def causal_self_attention_flash(q, k, v, mask) -> torch.Tensor:
    """Causal self-attention on the same kernels (no prefix).

    q/k/v [B, T, nh, hd]; mask [B, T] bool (True = real key) or None.
    Returns [B, T, E] fp32."""
    b, t, nh, hd = q.shape

    def seq(x):
        return x.reshape(b, t, nh * hd)
    kmask = (torch.ones((b, t), device=q.device) if mask is None
             else mask.float())
    return _attend(seq(q), seq(k), seq(v), kmask, None, None, None, nh)


def prefix_attention_reference(qq, qk, qv, pk, pv, query_mask, prefix_mask
                               ) -> torch.Tensor:
    """The einsum path (``fewshot/ops/prefix_attention.py:1174-1198``): the
    materialising reference, what ``prefix_flash=False`` runs."""
    b, q_, lq, nh, hd = qq.shape
    scale = math.sqrt(hd)
    dev = qq.device
    causal = torch.where(torch.ones((lq, lq), dtype=torch.bool,
                                    device=dev).tril(), 0.0, NEG)
    self_bias = causal + torch.where(query_mask, 0.0, NEG)[:, :, None, None]
    cross_bias = torch.where(prefix_mask, 0.0, NEG)[:, None, None, None, :]
    s_self = torch.einsum("bqlhd,bqmhd->bqhlm", qq.float(), qk.float())
    s_cross = torch.einsum("bqlhd,bphd->bqhlp", qq.float(), pk.float())
    s_self = s_self / scale + self_bias
    s_cross = s_cross / scale + cross_bias
    p = pk.shape[1]
    probs = torch.softmax(torch.cat([s_cross, s_self], dim=-1), dim=-1)
    probs = probs.to(qv.dtype).float()
    a_cross = torch.einsum("bqhlp,bphd->bqlhd", probs[..., :p], pv.float())
    a_self = torch.einsum("bqhlm,bqmhd->bqlhd", probs[..., p:], qv.float())
    return (a_cross + a_self).reshape(b, q_, lq, nh * hd)


def episodic_attention(qq, qk, qv, pk, pv, query_mask, prefix_mask,
                       use_flash: bool) -> torch.Tensor:
    """The kernels (``prefix_flash``, the default) or the einsum path."""
    if use_flash:
        return prefix_attention(qq, qk, qv, pk, pv, query_mask, prefix_mask)
    return prefix_attention_reference(qq, qk, qv, pk, pv, query_mask,
                                      prefix_mask)
