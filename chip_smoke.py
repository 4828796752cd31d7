#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from fewshot_torch/ops/csrc (one nvcc per
     source, all started together; sm_90a), and count the tensor-core
     (HMMA) instructions in the SASS of the two bf16 tensor-core kernels
     (the head+CE backward, the prefix-attention forward); a kernel with
     none fails the run;
  3. each recurrence kernel against its plain PyTorch twin at full width
     (E=256, H=512, 2 layers; bf16 and fp32; ragged masks): the two
     forward kernels (and their train-mode gate activations) and the two
     backward kernels, with each kernel's time (CUDA events), its bound,
     the twin's time and torch.nn.LSTM (cuDNN) timed at the same shape as
     a yardstick only: its forward for the forward kernels, its backward
     alone (the forward outside the timed window; forward and backward
     as a second figure) for the backward kernels;
  4. serving phase A, the bench config (support_mode=mean_state, batch 32,
     the per-layer kernel): an HTTP server answers concurrent /generate
     requests; the per-layer kernel's launch count must rise;
  5. serving phase B, the shipped config (support_mode=state, batch 16,
     the fused-stack kernel); the fused kernel's launch count must rise;
  6. training phase A, the bench config as bench.py trains it (B=32, 10
     steps per call, 2 warm-up calls, 4 timed calls): episodes/s, the
     loss of the first step and of the first and last calls (finite; the
     last call's below the first step's), one step's device idle share,
     one step's grads against the plain route; the per-layer forward and
     backward kernels' launch counts must rise;
  7. training phase B, the shipped config (support_mode=state, B=16): the
     fused-stack forward and backward kernels' counts must rise;
  8. the V=5000 synthetic lyrics corpus, then the fused head+CE forward
     and backward kernels against their twins at training C's head shape
     (R = B*Q*(L-1) rows, D=256, V=5000, neither a multiple of the 64-wide
     tiles; targets at 0 and V-1), with torch.logsumexp of the dense
     logits (its autograd backward alone for the backward) as the
     yardstick, and the backward's two launches on the same inputs
     bit-identical; after 4-7, so that those phases run in a process like
     the one before the V=5000 path existed;
  9. training phase C, the V=5000 neural-cache stack
     (scripts/scale_quality.py's plain_cache_full_floor leg: mean_state,
     B=32, global backoff, calibration, dynamic cache, responsibility floor
     0.25) on that corpus, as A: the per-layer kernels and the fused
     head+CE kernels' counts must rise; one step's grads, the cache
     parameters' included, against the plain route (the dense head); the
     validation NLL (512 episodes) before and after training, which must
     fall, with the head+CE forward counted and the backward idle during
     evaluation; the episodic-unigram floor on the same split;
 10. the three prefix-attention kernels (forward, dq, dk/dv) against their
     twins at the episodic transformer's two attention shapes (the query
     stream: 32 episodes x 5 songs x 95 rows against a 480-key prefix; the
     prefix stream: 32 x 480 rows, no prefix; nh=2, hd=128; bf16 and fp32;
     ragged masks), with F.scaled_dot_product_attention over [prefix ++
     self] under a boolean mask (its autograd backward alone for dq and
     dk/dv) as the yardstick;
 11. training phase D, the episodic transformer with the full cache stack
     (scripts/scale_quality.py's tfm_cache_full leg: 2 layers, E=256,
     nh=2, mean_state, B=32) on the V=5000 corpus, as C: the attention
     kernels' counters must show 3 launches each per step (the query
     stream's 2 layers, the prefix stream's first: the last layer's prefix
     tail is dead) and the head+CE kernels' one; one step's grads against
     the plain route (einsum attention, dense head); the validation NLL
     before and after, and the floor;
 12. serving phase C, the shipped transformer
     (configs/model/transformer.yaml: 4 layers, support_mode=state, batch
     16) on the bench corpus: the KV cache prefilled through the forward
     kernel (its count must rise) within tolerance of the einsum route;
 13. the cfg.flash route (row 10: ops.attention.causal_attention with
     use_flash) through the no-prefix kernel against the einsum route;
 14. the card line, a {"kernels": [...]} line, then the {"ok": true, ...}
     line.

Weights are random from a seed; the corpora (the bench corpus and the
V=5000 scale corpus of scripts/scale_test.py) are synthetic, built offline
in a temporary directory.  fp32 matmuls run in full fp32
(TF32 off for both matmul and cuDNN).
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent import futures
from pathlib import Path

import numpy as np
import torch

E, H, LAYERS = 256, 512, 2
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM
PEAK_BYTES = 3.35e12                                           # HBM3, B/s
# forward kernels against their twins, absolute, on (ys, cs, hT, cT): bf16
# streams and state can differ by one bf16 step near 1 when an fp32 sum
# lands on the other side of a rounding tie; fp32 only in summation order
FWD_TOL = {torch.float32: [1e-4] * 4, torch.bfloat16: [3e-2, 3e-2, 2e-2, 2e-2]}
GATES_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# backward kernels against their twins, relative to each output's largest
# magnitude (dzx, dh0, dc0, db): the same rounding points on both sides; a
# bf16 tie flipped by the order of an fp32 sum moves one dz by 2^-8 and the
# flip travels back through the remaining steps
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
STATE_TOL = 2e-2        # support state, kernel route vs plain route (bf16)
# the transformer's prefilled KV cache, kernel route vs the einsum route,
# relative to its largest entry: layer 0's K/V are the same; later layers'
# come through attention outputs that round p at other points (the kernel
# the unnormalised p, the einsum the normalised probs, 2^-9 each in bf16),
# carried by the residual stream and rounded to bf16 (2^-8) on the way
KV_TOL = 2e-2
# one train step's grads, kernel route vs the plain route (cell="scan",
# autograd through the step loop), relative to each leaf's largest
# magnitude: the routes round at different points in bf16 (kernels: bf16
# gates/cs streams, dz rounded before dz.Wh^T; plain: fp32 c, the product's
# grad rounded after), ~2^-9 per rounding over 95-480 steps, and the
# embedding's scatter-add sums in a run-dependent order
GRAD_TOL = 5e-2
# head+CE kernels against their twins: the same bf16- (or fp32-) rounded
# operands and fp32 sums on both sides, summed in another order (lse and
# tl absolute over 5000 columns); the backward rounds dlogits to bf16
# before both products, where an fp32 p that differs in its last bit can
# flip one entry by a bf16 step (relative to each output's largest; the bf16
# dh2 output is itself one rounding, 2^-8 of its entry); a skipped vocab
# tile removes ~1/79 of the softmax mass from dh2, above the bf16 limit
HEAD_FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
HEAD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
HEAD_D = E              # the tied head's inner width
# prefix-attention kernels against their twins: out absolute, lse absolute;
# fp32 only in summation order.  bf16: the kernels round the unnormalised p
# against the running row maximum of their online softmax, the twins
# against the final one (as kernels 8-9 do), 2^-9 of each p apart; the
# backward rounds p and ds at the same points on both sides from the same
# lse, where an fp32 p that differs in its last bit can flip one entry by a
# bf16 step (grads relative to each output's largest)
ATTN_HD = 128           # E = 256, nh = 2
ATTN_FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATTN_LSE_TOL = 1e-4
ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
EVAL_EPISODES = 512
KERNEL_REPS, PLAIN_REPS = 20, 3
ROUNDS = 3              # rounds of 7 requests per serving phase
TRAIN_WARMUP, TRAIN_CALLS = 2, 4    # calls of steps_per_call steps


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events.  The
    calls are enqueued while the card sleeps (torch.cuda._sleep, cycles at
    up to 2 GHz covering 1.5x the calls' measured enqueue time, at most
    0.25 s), so the events time the device's work back to back and not the
    host's dispatch rate, which a call of a few tens of microseconds would
    otherwise show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * enqueue_s + 1e-3, 0.25) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 5) -> float:
    """Median host time of fn() ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_busy_ms(fn, top: int = 0):
    """Device kernel time summed over one call of fn (torch.profiler);
    None when the profiler shows no device time.  With top > 0, returns
    (busy ms, [(kernel name, device ms, calls)] of the `top` largest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        log("  profiler: no device time recorded (not measured)")
        return (None, []) if top else None
    if not top:
        return total / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    return total / 1e3, [(e.key[:80], e.self_device_time_total / 1e3,
                          e.count) for e in events[:top]]


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def ragged_mask(gen, steps: int, rows: int, songs: int) -> torch.Tensor:
    """[T, B, 1] fp32: each row is `songs` songs of random length packed
    in equal slots (PAD between them), one row of length 1."""
    slot = steps // songs
    lens = torch.randint(1, slot + 1, (rows, songs), generator=gen)
    lens[0] = 0
    lens[0, 0] = 1
    live = torch.arange(slot)[None, None] < lens[..., None]   # [B, S, slot]
    return live.reshape(rows, steps).T[..., None].float().contiguous()


def cudnn_lstm_ms(wh, b, steps, rows, in_dim, layers, dtype,
                  backward=False):
    """torch.nn.LSTM (cuDNN) at the same shape: the yardstick only; with
    backward, (its backward alone, its forward and backward together), the
    backward giving the input and weight grads of a forward run once
    outside the timed window.

    Gates permuted from (i, j, f, o) to PyTorch's (i, f, g, o), forget bias
    folded into bias_ih.  It also projects its input (the kernels take
    that projection precomputed) and has no mask."""
    dev = wh.device
    lstm = torch.nn.LSTM(in_dim, H, num_layers=layers).to(dev, dtype)
    perm = torch.cat([torch.arange(0, H), torch.arange(2 * H, 3 * H),
                      torch.arange(H, 2 * H), torch.arange(3 * H, 4 * H)])
    bias = b.float().clone()
    bias[..., 2 * H:3 * H] += 1.0
    with torch.no_grad():
        for l in range(layers):
            w = wh[l] if wh.dim() == 3 else wh
            bl = bias[l] if bias.dim() == 2 else bias
            getattr(lstm, f"weight_hh_l{l}").copy_(w[:, perm].T)
            getattr(lstm, f"bias_ih_l{l}").copy_(bl[perm])
            getattr(lstm, f"bias_hh_l{l}").zero_()
    lstm.flatten_parameters()
    x = torch.randn(steps, rows, in_dim, device=dev, dtype=dtype,
                    requires_grad=backward)
    try:
        if not backward:
            with torch.no_grad():
                return cuda_ms(lambda: lstm(x), KERNEL_REPS)
        leaves = [x, *lstm.parameters()]
        return backward_ms(lambda: (lstm(x)[0],), leaves)
    except RuntimeError as e:            # no cuDNN LSTM for this dtype
        log(f"  cudnn yardstick unavailable for {dtype}: {e}")
        return None


def backward_ms(forward, leaves, cot=None) -> tuple[float, float]:
    """(backward alone, forward and backward) of a library call, by CUDA
    events: the backward alone runs torch.autograd.grad on one forward's
    retained graph (the forward outside the timed window).  forward()
    returns a tuple of outputs; cot: their cotangents (ones by default).
    Grads are returned, not accumulated into .grad."""
    outs = forward()
    cot = cot or tuple(torch.ones_like(o) for o in outs)
    bwd = cuda_ms(lambda: torch.autograd.grad(outs, leaves, cot,
                                              retain_graph=True), KERNEL_REPS)
    return bwd, cuda_ms(lambda: torch.autograd.grad(forward(), leaves, cot),
                        KERNEL_REPS)


def bound(byte_count: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = byte_count / PEAK_BYTES
    t_ops = ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_rel(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|) of two tensors."""
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def check_kernel(name, wrapper, plain, args, tols, relative, ops, dtype,
                 library, kw=None):
    """Run kernel and twin on the same inputs; returns the record.

    tols: one tolerance per output, absolute or (relative=True) relative to
    the output's largest magnitude; ops: the products this run's data
    needs (masked steps need none)."""
    kw = kw or {}
    with torch.no_grad():
        got = wrapper(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        errs = [max_rel(g, w) for g, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        checked = [e[1] if relative else e[0] for e in errs]
        live = all(bool(w.abs().max() > 0) for w in want)  # none all zero
        ok = finite and live and all(e <= t for e, t in zip(checked, tols))
        ms = cuda_ms(lambda: wrapper(*args, **kw), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), PLAIN_REPS, warmup=1)
    in_bytes = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
    out_bytes = sum(g.numel() * g.element_size() for g in got)
    bound_ms, bound_by = bound(in_bytes + out_bytes, ops, dtype)
    lib = library()                      # a backward's: (alone, fwd + bwd)
    lib_ms, lib_both = lib if isinstance(lib, tuple) else (lib, None)
    rec = {"name": name, "dtype": str(dtype).replace("torch.", ""),
           "shape": list(args[0].shape),
           "max_abs_err": max(e[0] for e in errs),
           "errors": [e[0] for e in errs],
           "rel_errors": [e[1] for e in errs], "tolerance": tols,
           "tolerance_relative": relative, "parity": ok, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms}
    if lib_both is not None:
        rec["library_fwd_bwd_ms"] = lib_both
    log(f"  {name} {rec['dtype']}: errors {checked} (tol {tols}, "
        f"{'relative' if relative else 'absolute'}) parity={ok} kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), library {lib_ms}"
        + ("" if lib_both is None
           else f" (backward alone; fwd+bwd {lib_both})"))
    if not ok:
        raise RuntimeError(f"{name} {dtype} disagrees with its twin: {errs}")
    return rec


def gates_err(name, wrapper, plain, args, dtype) -> float:
    """The train-mode forward's gate activations against the twin's."""
    with torch.no_grad():
        got = wrapper(*args, save_gates=True)
        want = plain(*args, save_gates=True)
        torch.cuda.synchronize()
    err = max(max_rel(g, w)[0] for g, w in zip(got, want))
    log(f"  {name} {dtype} save_gates: max abs err over the 5 outputs "
        f"{err:.3g} (tol {GATES_TOL[dtype]})")
    if not err <= GATES_TOL[dtype]:
        raise RuntimeError(f"{name} {dtype} gates disagree: {err}")
    return err


def kernel_phase(dev) -> dict:
    from fewshot_torch.ops import lstm_layer, lstm_stack
    gen = torch.Generator().manual_seed(0)
    lim = (6.0 / (5 * H)) ** 0.5

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def unif(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * lim).to(dev)

    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        # kernels 1 and 2: mean_state support pass, 32 episodes x 5 songs,
        # L=96
        t_, rows = 96, 160
        mask = ragged_mask(gen, t_, rows, 1).to(dev)
        live = float(mask.sum())
        args = (rand(t_, rows, 4 * H, scale=0.6).to(dtype),
                unif(H, 4 * H).to(dtype), rand(4 * H, scale=0.1), mask,
                rand(rows, H, scale=0.5), rand(rows, H, scale=0.5))
        yard = lambda: cudnn_lstm_ms(args[1], args[2], t_, rows, H, 1,  # noqa
                                     dtype)
        records[("layer", dtype)] = check_kernel(
            "lstm_layer_fwd", lstm_layer.lstm_layer_fwd,
            lstm_layer.lstm_layer_fwd_plain, args, FWD_TOL[dtype], False,
            2.0 * live * H * 4 * H, dtype, yard)
        records[("layer", dtype)]["gates_max_abs_err"] = gates_err(
            "lstm_layer_fwd", lstm_layer.lstm_layer_fwd,
            lstm_layer.lstm_layer_fwd_plain, args, dtype)
        with torch.no_grad():
            _, cs, _, _, gates = lstm_layer.lstm_layer_fwd(*args,
                                                           save_gates=True)
        bargs = (gates, args[1], mask, cs, args[5],
                 rand(t_, rows, H).to(dtype), rand(rows, H), rand(rows, H))
        records[("layer_bwd", dtype)] = check_kernel(
            "lstm_layer_bwd", lstm_layer.lstm_layer_bwd,
            lstm_layer.lstm_layer_bwd_plain, bargs, [BWD_TOL[dtype]] * 4,
            True, 2.0 * live * H * 4 * H, dtype,
            lambda: cudnn_lstm_ms(args[1], args[2], t_, rows, H, 1, dtype,
                                  backward=True))
        # kernels 3 and 4: state support pass, 16 episodes x 5 songs x L=96
        t_, rows = 480, 16
        mask = ragged_mask(gen, t_, rows, 5).to(dev)
        live = float(mask.sum())
        args = (rand(t_, rows, 4 * H, scale=0.6).to(dtype),
                unif(LAYERS - 1, H, 4 * H).to(dtype),
                unif(LAYERS, H, 4 * H).to(dtype),
                rand(LAYERS, 4 * H, scale=0.1), mask,
                rand(LAYERS, rows, H, scale=0.5),
                rand(LAYERS, rows, H, scale=0.5))
        # per live step: h.Wh for every layer, x.Wx for layers >= 1 (the
        # backward: dz.Wh^T and dz.Wx^T, the same count)
        ops = 2.0 * live * H * 4 * H * (2 * LAYERS - 1)
        yard = lambda: cudnn_lstm_ms(args[2], args[3], t_, rows, E,  # noqa
                                     LAYERS, dtype)
        records[("stack", dtype)] = check_kernel(
            "lstm_stack_fwd", lstm_stack.lstm_stack_fwd,
            lstm_stack.lstm_stack_fwd_plain, args, FWD_TOL[dtype], False,
            ops, dtype, yard)
        records[("stack", dtype)]["gates_max_abs_err"] = gates_err(
            "lstm_stack_fwd", lstm_stack.lstm_stack_fwd,
            lstm_stack.lstm_stack_fwd_plain, args, dtype)
        with torch.no_grad():
            _, cs, _, _, gates = lstm_stack.lstm_stack_fwd(*args,
                                                           save_gates=True)
        bargs = (gates, args[1], args[2], mask, cs, args[6],
                 rand(t_, rows, H).to(dtype), rand(LAYERS, rows, H),
                 rand(LAYERS, rows, H))
        records[("stack_bwd", dtype)] = check_kernel(
            "lstm_stack_bwd", lstm_stack.lstm_stack_bwd,
            lstm_stack.lstm_stack_bwd_plain, bargs, [BWD_TOL[dtype]] * 4,
            True, ops, dtype,
            lambda: cudnn_lstm_ms(args[2], args[3], t_, rows, E, LAYERS,
                                  dtype, backward=True))
    return records


def head_library_ms(h2, w, b, t, cot=None):
    """torch.logsumexp of the dense logits and the target's logit (cuBLAS
    at the operands' dtype); with cot=(dlse, dtl), (its autograd backward
    alone, forward and backward): the yardstick only, never called by the
    port."""
    leaves = [x.detach().requires_grad_(cot is not None) for x in (h2, w, b)]

    def run():
        hh, ww, bb = leaves
        logits = (hh @ ww.to(hh.dtype)).float() + bb
        lse = torch.logsumexp(logits, dim=-1)
        return lse, logits.gather(1, t[:, None].long())[:, 0]

    if cot is not None:
        return backward_ms(run, leaves, cot)
    with torch.no_grad():
        return cuda_ms(run, KERNEL_REPS)


def head_kernel_phase(dev, rows: int, vocab: int) -> dict:
    """Kernels 5 and 6 against their twins at training C's head shape."""
    from fewshot_torch.ops import head_ce
    gen = torch.Generator().manual_seed(1)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        h2 = torch.randn((rows, HEAD_D), generator=gen).to(dev, dtype)
        # the tied head: w [D, V] is the embedding table [V, D] transposed
        table = torch.randn((vocab, HEAD_D), generator=gen) * HEAD_D ** -0.5
        w = table.to(dev).T
        b = (torch.randn(vocab, generator=gen) * 0.5).to(dev)
        t = torch.randint(0, vocab, (rows,), generator=gen)
        t[0], t[-1] = 0, vocab - 1
        t = t.to(dev)
        products = 2.0 * rows * HEAD_D * vocab
        records[("head_fwd", dtype)] = check_kernel(
            "head_ce_fwd", head_ce.head_ce_fwd, head_ce.head_lse_tgt_plain,
            (h2, w, b, t), [HEAD_FWD_TOL[dtype]] * 2, False, products, dtype,
            lambda: head_library_ms(h2, w, b, t))
        with torch.no_grad():
            lse, _ = head_ce.head_lse_tgt_plain(h2, w, b, t)
        dlse = torch.rand((rows,), generator=gen).to(dev)
        dtl = -torch.rand((rows,), generator=gen).to(dev)
        # the function's least work: the logits once, dh2 and dw (the
        # kernels recompute the logits in each of their two passes)
        bargs = (h2, w, b, t, lse, dlse, dtl)
        records[("head_bwd", dtype)] = check_kernel(
            "head_ce_bwd", head_ce.head_ce_bwd,
            head_ce.head_lse_tgt_bwd_plain, bargs,
            [HEAD_BWD_TOL[dtype]] * 3, True, 3 * products, dtype,
            lambda: head_library_ms(h2, w, b, t, (dlse, dtl)))
        # two launches on the same inputs: the same bits
        with torch.no_grad():
            same = all(torch.equal(x, y) for x, y in zip(
                head_ce.head_ce_bwd(*bargs), head_ce.head_ce_bwd(*bargs)))
        records[("head_bwd", dtype)]["deterministic"] = same
        log(f"  head_ce_bwd {dtype}: two launches bit-identical: {same}")
        if not same:
            raise RuntimeError(f"head_ce_bwd {dtype} is not deterministic")
    return records


def attn_library_ms(q, k, v, kmask, pk, pv, pmask, nh, g=None):
    """F.scaled_dot_product_attention over each song's keys [its episode's
    prefix, repeated per song, ++ itself] under a boolean mask (key mask,
    causal on the self part); with g, (its autograd backward alone, forward
    and backward): the yardstick only, never called by the port."""
    import torch.nn.functional as F
    from fewshot_torch.ops.prefix_attention import _heads
    s_, t, e = q.shape
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    allow = (kmask[:, None, None, :] > 0) & causal             # [S,1,T,T]
    keys, vals = _heads(k, nh), _heads(v, nh)
    if pk is not None:
        rep = s_ // pk.shape[0]
        pre = (pmask > 0).repeat_interleave(rep, 0)[:, None, None, :]
        allow = torch.cat([pre.expand(-1, 1, t, -1), allow], dim=-1)
        keys = torch.cat([_heads(pk, nh).repeat_interleave(rep, 0), keys], 2)
        vals = torch.cat([_heads(pv, nh).repeat_interleave(rep, 0), vals], 2)
    leaves = [x.to(q.dtype).detach().requires_grad_(g is not None)
              for x in (_heads(q, nh), keys, vals)]

    def run():
        return (F.scaled_dot_product_attention(*leaves, attn_mask=allow),)

    if g is not None:
        return backward_ms(run, leaves, (_heads(g, nh).to(q.dtype),))
    with torch.no_grad():
        return cuda_ms(run, KERNEL_REPS)


def attn_inputs(gen, dev, dtype, b, q_, t, p):
    """Random streams and ragged masks at one attention shape: S = b q_
    songs of t rows with key masks t' < len (len >= 2, so every row has a
    real key), and (p > 0) an episode prefix of 5 support songs of p / 5
    slots each, every song at least 1 token long."""
    s_, e = b * q_, 2 * ATTN_HD
    rnd = lambda *sh: torch.randn(sh, generator=gen).to(dev, dtype)  # noqa
    lens = torch.randint(2, t + 2, (s_,), generator=gen)
    kmask = (torch.arange(t)[None] < lens[:, None] - 1).float().to(dev)
    if not p:
        return (rnd(s_, t, e), rnd(s_, t, e), rnd(s_, t, e), kmask, None,
                None, None, 2)
    slot = p // 5
    slens = torch.randint(1, slot + 1, (b, 5), generator=gen)
    pmask = (torch.arange(slot)[None, None] < slens[..., None]).reshape(
        b, p).float().to(dev)
    return (rnd(s_, t, e), rnd(s_, t, e), rnd(s_, t, e), kmask,
            rnd(b, p, e), rnd(b, p, e), pmask, 2)


def attn_pairs(kmask, pmask, rep) -> float:
    """(query row, real key) pairs the function needs: each row's real
    prefix keys and its real own keys up to the diagonal."""
    t = kmask.shape[1]
    causal = torch.ones((t, t), device=kmask.device).tril()
    pairs = float((kmask[:, None, :] * causal).sum())
    if pmask is not None:
        pairs += float(pmask.sum()) * rep * t
    return pairs


def attn_kernel_phase(dev, shapes) -> dict:
    """The three prefix-attention kernels against their twins at the
    training path's shapes: shapes = {label: (B, Q, T, P)}.  Bound: the
    inputs read once and the outputs written once against the products the
    function needs over its real (row, key) pairs: 2 in the forward (q k^T,
    p v), 3 for dq (q k^T, g v^T, ds k), 4 for dk/dv (q k^T, g v^T, p^T g,
    ds^T q), each 2 hd operations a pair and head."""
    from fewshot_torch.ops import prefix_attention as pa
    gen = torch.Generator().manual_seed(2)
    records = {}
    for label, (b, q_, t, p) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = attn_inputs(gen, dev, dtype, b, q_, t, p)
            q, k, v, kmask, pk, pv, pmask, nh = args
            pair_ops = 2.0 * ATTN_HD * nh * attn_pairs(kmask, pmask, q_)
            records[(f"attn_fwd_{label}", dtype)] = check_kernel(
                "prefix_attn_fwd", pa.prefix_attn_fwd,
                pa.prefix_attn_fwd_plain, args,
                [ATTN_FWD_TOL[dtype], ATTN_LSE_TOL], False, 2 * pair_ops,
                dtype, lambda: attn_library_ms(*args))
            with torch.no_grad():
                out, lse = pa.prefix_attn_fwd_plain(*args)
            g = torch.randn(q.shape, generator=gen).to(dev)
            delta = pa._delta(g, out, nh)
            bargs = args[:7] + (g.to(dtype), lse, delta, nh)
            records[(f"attn_dq_{label}", dtype)] = check_kernel(
                "prefix_attn_bwd_dq", lambda *a: (pa.prefix_attn_bwd_dq(*a),),
                lambda *a: (pa.prefix_attn_bwd_dq_plain(*a),), bargs,
                [ATTN_BWD_TOL[dtype]], True, 3 * pair_ops, dtype,
                lambda: attn_library_ms(*args, g=g))
            records[(f"attn_dkv_{label}", dtype)] = check_kernel(
                "prefix_attn_bwd_dkv", pa.prefix_attn_bwd_dkv,
                pa.prefix_attn_bwd_dkv_plain, bargs,
                [ATTN_BWD_TOL[dtype]] * (2 if pk is None else 4), True,
                4 * pair_ops, dtype, lambda: attn_library_ms(*args, g=g))
            for key in ("fwd", "dq", "dkv"):
                records[(f"attn_{key}_{label}", dtype)]["shape"] = \
                    [b, q_, t, p, nh, ATTN_HD]
    return records


# ---------------------------------------------------------------------------
# phases 4-5: serving over HTTP
# ---------------------------------------------------------------------------

def bench_corpus(tmp: Path):
    from fewshot_torch.data.corpus import build_lyrics_corpus
    from fewshot_torch.data.synthetic import generate_lyrics_csv
    csv = tmp / "lyrics.csv"
    generate_lyrics_csv(csv, num_artists=24, songs_per_artist=16, seed=0)
    return build_lyrics_corpus(csv, tmp / "bench_lyrics", vocab_size=5000,
                               max_len=0, seed=0)


def scale_corpus(tmp: Path):
    """The V=5000 synthetic lyrics corpus of scripts/scale_test.py:33-67
    (2000 artists x 50 songs, 6000 extra words), uncut."""
    from fewshot_torch.data.corpus import build_lyrics_corpus
    from fewshot_torch.data.synthetic import generate_lyrics_csv
    csv = tmp / "scale.csv"
    generate_lyrics_csv(csv, num_artists=2000, songs_per_artist=50,
                        extra_vocab=6000, seed=0)
    return build_lyrics_corpus(csv, tmp / "scale_lyrics", vocab_size=5000,
                               max_len=0, seed=0)


def post(url: str, payload: dict) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0


def serving_phase(label, cfg, corpus, dev, counter) -> dict:
    from fewshot_torch.models import lm
    from fewshot_torch.serve import Generator, serve

    params = lm.init_lm(cfg, len(corpus.vocab),
                        torch.Generator().manual_seed(cfg.seed), dev)
    kernel_counters = reset_counts()
    gen = Generator(cfg, corpus, params, batch_size=cfg.batch_size,
                    device=dev)
    srv = serve(gen, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("device") != str(dev):
            raise RuntimeError(f"{label}: bad /healthz {health}")
        name = corpus.artist_names[5]
        payloads = []
        for rnd in range(ROUNDS):
            payloads += [{"num": 4, "split": "train",
                          "episode_seed": 10 * rnd + i, "temperature": t}
                         for i, t in enumerate((0.7, 1.0, 1.2, 0.9))]
            payloads += [{"num": 2, "artist": name, "temperature": 0.8,
                          "episode_seed": rnd},
                         {"num": cfg.batch_size, "split": "test",
                          "episode_seed": 99 + rnd},
                         {"num": 1, "split": "val", "episode_seed": 5 + rnd,
                          "temperature": 0.5}]
        t0 = time.perf_counter()
        results = []
        for rnd in range(ROUNDS):          # 4 concurrent, then 3 in turn
            batch = payloads[7 * rnd:7 * rnd + 7]
            with futures.ThreadPoolExecutor(max_workers=4) as ex:
                results += list(ex.map(lambda p: post(url, p), batch[:4]))
            results += [post(url, p) for p in batch[4:]]
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    launches = {n: fn.launches for n, fn in kernel_counters.items()}

    tokens = 0
    for payload, (status, body, _) in zip(payloads, results):
        outs = body.get("continuations", [])
        if status != 200 or len(outs) != payload["num"]:
            raise RuntimeError(f"{label}: bad reply {status} {body}")
        for rec in outs:
            if not isinstance(rec.get("text"), str) or \
                    not 0 <= rec["tokens"] <= cfg.sample_tokens:
                raise RuntimeError(f"{label}: malformed continuation {rec}")
            if "artist" in payload and rec["artist"] != payload["artist"]:
                raise RuntimeError(f"{label}: wrong artist {rec}")
            tokens += rec["tokens"]
    if launches[counter] == 0:
        raise RuntimeError(f"{label}: {counter} never launched: {launches}")

    # the served support pass through the kernels against the plain route,
    # on one batch of training-split episodes: the LSTM's support state
    # (absolute), the transformer's prefilled KV cache (relative to its
    # largest entry)
    from fewshot_torch import sampling
    from fewshot_torch.data import episodes as eps
    ep = eps.sample_episode_for_artists(
        [sampling.row_generator(s, 0) for s in range(cfg.batch_size)],
        gen.data, torch.as_tensor(np.resize(corpus.splits["train"],
                                            cfg.batch_size)),
        k=cfg.support_size, q=cfg.query_size)

    def support(c=cfg):
        with torch.inference_mode():
            if c.model == "transformer":
                cache, _ = sampling.prefix_cache(gen.params, ep.support,
                                                 ep.support_len, c, 0)
                return [cache["k"], cache["v"]]
            return [x for hc in lm.support_state(
                gen.params, ep.support, ep.support_len, c, eval_mode=True)
                for x in hc]

    errs = [max_rel(a, b) for a, b in zip(support(), support(plain_route(
        cfg)))]
    if cfg.model == "transformer":
        state_err, tol = max(e[1] for e in errs), KV_TOL
    else:
        state_err, tol = max(e[0] for e in errs), STATE_TOL
    if not state_err <= tol:
        raise RuntimeError(f"{label}: support pass off by {state_err}")

    # where a batch's time goes: the support pass (kernels) against the
    # whole generate() call (support pass + token-by-token decode)

    def generate():
        sampling.generate(gen.params, ep.support, ep.support_len,
                          [sampling.row_generator(s, 1, dev)
                           for s in range(cfg.batch_size)], cfg)

    support_ms, generate_ms = host_ms(support), host_ms(generate)
    busy_ms = device_busy_ms(generate)
    kernel_counters = reset_counts()
    generate()
    per_batch = {n: fn.launches for n, fn in kernel_counters.items()}
    gen.close()
    lat = sorted(r[2] for r in results)
    rec = {"phase": label, "support_mode": cfg.support_mode,
           "serve_batch": cfg.batch_size, "requests": len(results),
           "p50_latency_s": statistics.median(lat),
           "max_latency_s": lat[-1], "generated_tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "warmup_s": gen.warm_s, "launches": launches,
           "launches_per_batch": per_batch,
           "support_pass_err_vs_plain": state_err,
           "batch_support_ms": support_ms, "batch_generate_ms": generate_ms,
           "batch_device_busy_ms": busy_ms,
           "batch_device_idle_share": (None if busy_ms is None
                                       else 1.0 - busy_ms / generate_ms)}
    log(f"{label}: {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 6-7: training
# ---------------------------------------------------------------------------

def counters() -> dict:
    """Every kernel wrapper by name; each counts its launches."""
    from fewshot_torch.ops import (head_ce, lstm_layer, lstm_stack,
                                   prefix_attention)
    return {"lstm_layer_fwd": lstm_layer.lstm_layer_fwd,
            "lstm_layer_bwd": lstm_layer.lstm_layer_bwd,
            "lstm_stack_fwd": lstm_stack.lstm_stack_fwd,
            "lstm_stack_bwd": lstm_stack.lstm_stack_bwd,
            "head_ce_fwd": head_ce.head_ce_fwd,
            "head_ce_bwd": head_ce.head_ce_bwd,
            "prefix_attn_fwd": prefix_attention.prefix_attn_fwd,
            "prefix_attn_bwd_dq": prefix_attention.prefix_attn_bwd_dq,
            "prefix_attn_bwd_dkv": prefix_attention.prefix_attn_bwd_dkv}


def reset_counts() -> dict:
    kernel_counters = counters()
    for fn in kernel_counters.values():
        fn.launches = 0
    return kernel_counters


def plain_route(cfg):
    """The same model without the kernels: the LSTM's step loop and the
    dense head (cell="scan"), the transformer's einsum attention
    (prefix_flash and flash off)."""
    return dataclasses.replace(cfg, cell="scan", prefix_flash=False,
                               flash=False)


def grad_check(cfg, params, ep) -> dict:
    """One step's grads through the kernels against the plain route on the
    same episode and parameters: max |diff| / max |plain| per leaf."""
    from fewshot_torch.models import lm

    def grads(c):
        for p in params.parameters():
            p.grad = None
        total, _ = lm.episodic_nll_stats(params, ep, c)
        total.backward()
        out = {k: p.grad.float().clone()
               for k, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return out

    fast = grads(cfg)
    slow = grads(plain_route(cfg))
    return {k: max_rel(fast[k], slow[k])[1] for k in slow}


def eval_phase(label, cfg, params, data, corpus, dev) -> dict:
    """The validation NLL (EVAL_EPISODES episodes of the val split, the
    same episodes every call) through training.evaluate, with the launches
    it made and its host time."""
    from fewshot_torch import training
    val = torch.as_tensor(np.asarray(corpus.splits["val"]),
                          dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    kernel_counters = reset_counts()
    t0 = time.perf_counter()
    nll = training.evaluate(cfg, params, data, val,
                            torch.Generator(device=dev).manual_seed(7),
                            num_episodes=EVAL_EPISODES)
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    if not np.isfinite(nll):
        raise RuntimeError(f"{label}: val NLL not finite: {nll}")
    return {"nll": nll, "wall_s": wall, "launches": launches,
            "batches": EVAL_EPISODES // cfg.batch_size}


def training_phase(label, cfg, corpus, dev, must_rise, evaluate=False,
                   per_step=None, per_eval_batch=None) -> dict:
    """The train step at cfg, dispatched steps_per_call steps per call as
    bench.py does: 2 warm-up calls, then 4 timed calls.  evaluate: also the
    val NLL before and after training (it must fall; the head+CE forward
    must launch and no backward kernel may) and the unigram floor.
    per_step / per_eval_batch: {kernel: launches} the counters must show
    exactly."""
    from fewshot_torch import training
    from fewshot_torch.data import episodes as eps

    data = eps.put_corpus(corpus, dev)
    split = torch.as_tensor(np.asarray(corpus.splits["train"]),
                            dtype=torch.int64, device=dev)
    state = training.init_train_state(cfg, len(corpus.vocab), device=dev)
    if evaluate:
        val_init = eval_phase(label, cfg, state.params, data, corpus, dev)
    one_step = training.make_train_step(cfg, data, split)
    step = training.make_multi_step(one_step, cfg.steps_per_call)
    # the first warm-up call runs as its single steps (the same trajectory,
    # make_multi_step's contract) to read the untrained first step's loss
    for i in range(cfg.steps_per_call):
        state, m = one_step(state)
        if i == 0:
            first_step = float(m["loss"])
    losses = [float(m["loss"])]
    for _ in range(TRAIN_WARMUP - 1):
        state, m = step(state)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    kernel_counters = reset_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_CALLS):
        state, m = step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    losses.append(float(m["loss"]))
    steps = TRAIN_CALLS * cfg.steps_per_call
    if not np.isfinite(losses + [first_step]).all() \
            or not losses[-1] < first_step:
        raise RuntimeError(f"{label}: loss not finite and falling: "
                           f"{first_step} then {losses}")
    for n in must_rise:
        if launches[n] == 0:
            raise RuntimeError(f"{label}: {n} never launched: {launches}")
    for n, want in (per_step or {}).items():
        if launches[n] != want * steps:
            raise RuntimeError(f"{label}: {n} launched {launches[n]} times "
                               f"in {steps} steps, not {want} per step")

    # where one step's time goes: host wall (synchronized) and device busy
    def one():
        nonlocal state
        state, _ = one_step(state)

    step_ms = host_ms(one)
    busy_ms, top = device_busy_ms(one, top=12)

    ep = eps.sample_episode(torch.Generator(device=dev).manual_seed(123),
                            data, split, cfg.batch_size,
                            k=cfg.support_size, q=cfg.query_size)
    grad_err = grad_check(cfg, state.params, ep)
    worst = max(grad_err.values())
    if not worst <= GRAD_TOL:
        raise RuntimeError(f"{label}: grads off the plain route: {grad_err}")
    rec = {"phase": label, "support_mode": cfg.support_mode,
           "batch": cfg.batch_size, "steps_per_call": cfg.steps_per_call,
           "vocab": len(corpus.vocab), "max_len": corpus.max_len,
           "timed_steps": steps, "wall_s": wall,
           "episodes_per_s": steps * cfg.batch_size / wall,
           "step_ms": step_ms, "step_device_busy_ms": busy_ms,
           "step_device_idle_share": (None if busy_ms is None
                                      else 1.0 - busy_ms / step_ms),
           "step_device_top_kernels": top,
           "loss_first_step": first_step, "loss_first_call": losses[0],
           "loss_last_call": losses[-1],
           "launches": launches,
           "launches_per_step": {n: v / steps for n, v in launches.items()},
           "grad_rel_err_vs_plain": grad_err, "grad_tol": GRAD_TOL}
    if evaluate:
        from fewshot_torch.models import unigram
        val_end = eval_phase(label, cfg, state.params, data, corpus, dev)
        fwd = val_end["launches"]["head_ce_fwd"]
        bwd = sum(v for n, v in val_end["launches"].items() if "bwd" in n)
        exact = all(val_end["launches"][n] == want * val_end["batches"]
                    for n, want in (per_eval_batch or {}).items())
        if not val_end["nll"] < val_init["nll"] or fwd == 0 or bwd != 0 \
                or not exact:
            raise RuntimeError(f"{label}: evaluation failed its gates: "
                               f"{val_init} then {val_end}")
        val = torch.as_tensor(np.asarray(corpus.splits["val"]),
                              dtype=torch.int64, device=dev)
        floor = unigram.evaluate_unigram(
            cfg, corpus, data, val, torch.Generator(device=dev).manual_seed(7),
            num_episodes=EVAL_EPISODES)
        rec.update({"val_nll_init": val_init["nll"],
                    "val_nll_trained": val_end["nll"],
                    "val_unigram_floor": floor,
                    "eval_episodes": EVAL_EPISODES,
                    "eval_wall_s": val_end["wall_s"],
                    "eval_launches": val_end["launches"],
                    "launches_per_eval_batch": {
                        n: v / val_end["batches"]
                        for n, v in val_end["launches"].items()}})
    log(f"{label}: {json.dumps(rec)}")
    return rec


def flash_phase(dev) -> dict:
    """Row 10: the cfg.flash route (the no-prefix kernel) of
    ops.attention.causal_attention against its einsum route, at the
    prefix stream's shape (32 x 480, nh=2, hd=128, bf16), at the real query
    positions: pad query rows see the real keys before them on both routes
    (JAX's TPU flash kernel gives them only pad keys, by design)."""
    from fewshot_torch.ops import attention, prefix_attention as pa
    gen = torch.Generator().manual_seed(3)
    q, k, v, kmask, *_ = attn_inputs(gen, dev, torch.bfloat16, 32, 1, 480, 0)

    def heads(x):
        return x.view(32, 480, 2, ATTN_HD)
    mask = kmask > 0
    before = pa.prefix_attn_fwd.launches
    with torch.no_grad():
        got = attention.causal_attention(heads(q), heads(k), heads(v), mask,
                                         use_flash=True)
        want = attention.causal_attention(heads(q), heads(k), heads(v), mask,
                                          use_flash=False)
        torch.cuda.synchronize()
    launched = pa.prefix_attn_fwd.launches - before
    err = float((got.float() - want)[mask].abs().max())
    rec = {"shape": [32, 480, 2, ATTN_HD], "dtype": str(got.dtype),
           "max_abs_err_real_rows": err, "tolerance": ATTN_FWD_TOL[
               torch.bfloat16], "kernel_launches": launched}
    log(f"flash route (row 10): {json.dumps(rec)}")
    if launched != 1 or not err <= ATTN_FWD_TOL[torch.bfloat16] \
            or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"cfg.flash route failed: {rec}")
    return rec


# the kernels whose bf16 route runs on tensor cores, by wrapper: (library,
# the CUDA kernel's name in it)
TENSOR_CORE = {"head_ce_bwd": ("head_ce", "head_ce_bwd_tc"),
               "prefix_attn_fwd": ("prefix_attn", "fwd_tc_kernel")}


def sass_hmma(lib: Path) -> dict:
    """{kernel function: HMMA (tensor-core) instructions in its SASS} of a
    built library, by cuobjdump; {} where cuobjdump is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


def build_all() -> dict:
    """Build every kernel source in parallel (one nvcc each), then load;
    returns, per tensor-core wrapper, the HMMA instructions in its
    kernels' SASS (None where cuobjdump is missing)."""
    from fewshot_torch.ops import _ext
    t0 = time.perf_counter()
    with futures.ThreadPoolExecutor(len(_ext.SIGNATURES)) as ex:
        list(ex.map(_ext.build, _ext.SIGNATURES))
    for name in _ext.SIGNATURES:
        _ext.load(name)
    log(f"build: {', '.join(_ext.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _ext.SIGNATURES:
        for line in _ext.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    hmma = {}
    for wrapper, (lib, kernel) in TENSOR_CORE.items():
        counts = sass_hmma(_ext.library_path(lib))
        hits = {fn: n for fn, n in counts.items() if kernel in fn}
        hmma[wrapper] = sum(hits.values()) if counts else None
        log(f"  sass {lib}: {kernel} HMMA instructions {hits or 'not read'}")
        if counts and not (hits and all(hits.values())):
            raise RuntimeError(f"{kernel}: no tensor-core instruction in "
                               f"its SASS: {hits}")
    return hmma


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from fewshot_torch.config import Config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    hmma = build_all()

    log("kernels vs plain twins (full width):")
    records = kernel_phase(dev)

    with tempfile.TemporaryDirectory() as tmp:
        corpus = bench_corpus(Path(tmp))
    log(f"bench corpus: {corpus.songs.shape[0]} songs, max_len "
        f"{corpus.max_len}, vocab {len(corpus.vocab)}")
    base = Config(vocab_size=5000, max_len=corpus.max_len, embed_dim=E,
                  hidden_dim=H, num_layers=LAYERS, support_size=5,
                  query_size=5, cell="pallas", compute_dtype="bfloat16",
                  sample_tokens=128, top_k=40, seed=0)
    bench = dataclasses.replace(base, support_mode="mean_state",
                                batch_size=32)
    shipped = dataclasses.replace(base, support_mode="state", batch_size=16)
    serve_a = serving_phase("serving_A", bench, corpus, dev, "lstm_layer_fwd")
    serve_b = serving_phase("serving_B", shipped, corpus, dev,
                            "lstm_stack_fwd")
    train_a = training_phase(
        "training_A", dataclasses.replace(bench, steps_per_call=10), corpus,
        dev, ("lstm_layer_fwd", "lstm_layer_bwd"))
    train_b = training_phase(
        "training_B", dataclasses.replace(shipped, steps_per_call=10),
        corpus, dev, ("lstm_stack_fwd", "lstm_stack_bwd"))

    # the V=5000 path, after the bench-corpus phases: its 100,000-song
    # corpus build and the head+CE phase do not precede their host timings
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scale = scale_corpus(Path(tmp))
        scale_s = time.perf_counter() - t0
    log(f"scale corpus: {scale.songs.shape[0]} songs, max_len "
        f"{scale.max_len}, vocab {len(scale.vocab)}, built in {scale_s:.1f} s")
    # training C's head: B*Q query songs of max_len - 1 positions
    head_rows = 32 * 5 * (scale.max_len - 1)
    log(f"head+CE kernels vs plain twins ({head_rows} x {HEAD_D} x "
        f"{len(scale.vocab)}):")
    records.update(head_kernel_phase(dev, head_rows, len(scale.vocab)))
    # scripts/scale_quality.py:58-70, 205-206, 274 (plain_cache_full_floor)
    cache = dataclasses.replace(
        bench, vocab_size=len(scale.vocab), max_len=scale.max_len,
        steps_per_call=10, support_cache=True, cache_backoff="global",
        cache_calib=True, cache_dynamic=True, cache_resp_floor=0.25)
    train_c = training_phase(
        "training_C", cache, scale, dev,
        ("lstm_layer_fwd", "lstm_layer_bwd", "head_ce_fwd", "head_ce_bwd"),
        evaluate=True, per_step={"head_ce_fwd": 1, "head_ce_bwd": 1})

    # the episodic transformer: its attention shapes (query stream: B=32
    # episodes x Q=5 songs x L-1 rows against a K*L prefix; prefix stream:
    # 32 x K*L, no prefix), training D on the V=5000 corpus, serving C on
    # the bench corpus, and the cfg.flash route
    attn_shapes = {"query": (32, 5, scale.max_len - 1, 5 * scale.max_len),
                   "prefix": (32, 1, 5 * scale.max_len, 0)}
    log(f"prefix-attention kernels vs plain twins {attn_shapes}:")
    records.update(attn_kernel_phase(dev, attn_shapes))
    # scripts/scale_quality.py:58-70, 205-206, 234 (tfm_cache_full)
    tfm_d = dataclasses.replace(
        cache, model="transformer", num_heads=2, cache_resp_floor=0.0)
    attn_step = {"prefix_attn_fwd": 2 * LAYERS - 1,   # no dead prefix tail
                 "prefix_attn_bwd_dq": 2 * LAYERS - 1,
                 "prefix_attn_bwd_dkv": 2 * LAYERS - 1}
    train_d = training_phase(
        "training_D", tfm_d, scale, dev,
        ("prefix_attn_fwd", "prefix_attn_bwd_dq", "prefix_attn_bwd_dkv",
         "head_ce_fwd", "head_ce_bwd"), evaluate=True,
        per_step={**attn_step, "head_ce_fwd": 1, "head_ce_bwd": 1},
        per_eval_batch={"prefix_attn_fwd": 2 * LAYERS - 1, "head_ce_fwd": 1})
    # configs/model/transformer.yaml + configs/task/episodic.yaml
    serve_c = serving_phase(
        "serving_C", dataclasses.replace(shipped, model="transformer",
                                         num_layers=4, num_heads=2),
        corpus, dev, "prefix_attn_fwd")
    flash = flash_phase(dev)

    meta = {  # key, csrc source, TPU kernel, the slice's path, serving path
        "lstm_layer_fwd": ("layer", "lstm_fwd.cu",
                           "fewshot/ops/lstm_pallas.py:122", train_a,
                           serve_a),
        "lstm_layer_bwd": ("layer_bwd", "lstm_bwd.cu",
                           "fewshot/ops/lstm_pallas.py:239", train_a, None),
        "lstm_stack_fwd": ("stack", "lstm_fwd.cu",
                           "fewshot/ops/lstm_fused.py:88", train_b, serve_b),
        "lstm_stack_bwd": ("stack_bwd", "lstm_bwd.cu",
                           "fewshot/ops/lstm_fused.py:200", train_b, None),
        "head_ce_fwd": ("head_fwd", "head_ce.cu",
                        "fewshot/ops/head_ce.py:142", train_c, None),
        "head_ce_bwd": ("head_bwd", "head_ce.cu",
                        "fewshot/ops/head_ce.py:153", train_c, None),
        # kernel 9 (token-major resident plan) is what the TPU runs at these
        # shapes; the same kernels replace 7, 8 and (no prefix) 10
        "prefix_attn_fwd": ("attn_fwd_query", "prefix_attn.cu",
                            "fewshot/ops/prefix_attention.py:727", train_d,
                            serve_c),
        "prefix_attn_bwd_dq": ("attn_dq_query", "prefix_attn.cu",
                               "fewshot/ops/prefix_attention.py:757",
                               train_d, None),
        "prefix_attn_bwd_dkv": ("attn_dkv_query", "prefix_attn.cu",
                                "fewshot/ops/prefix_attention.py:757",
                                train_d, None),
    }
    kernels = []
    for name, (key, src, replaces, phase, serve) in meta.items():
        r = records[(key, torch.bfloat16)]
        f = records[(key, torch.float32)]
        rec = {
            "name": name, "route": "cuda",
            "source": f"fewshot_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": phase["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "bfloat16", "shape": r["shape"],
            "parity": r["parity"] and f["parity"],
            "launches_per_train_step": phase["launches_per_step"][name],
            "fp32": {k: f[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_fwd_bwd_ms") if k in f}}
        if "library_fwd_bwd_ms" in r:    # library_ms is the backward alone
            rec["library_fwd_bwd_ms"] = r["library_fwd_bwd_ms"]
        if name in TENSOR_CORE:
            rec["bf16_route"] = "tensor cores (mma.sync bf16)"
            rec["sass_hmma"] = hmma[name]
        if "deterministic" in r:
            rec["deterministic"] = r["deterministic"] and f["deterministic"]
        if serve is not None:
            rec["launches_serving"] = serve["launches"][name]
            rec["launches_per_serving_batch"] = \
                serve["launches_per_batch"][name]
        if "gates_max_abs_err" in r:
            rec["gates_max_abs_err"] = [r["gates_max_abs_err"],
                                        f["gates_max_abs_err"]]
        if "launches_per_eval_batch" in phase:
            rec["launches_per_eval_batch"] = \
                phase["launches_per_eval_batch"][name]
        if key.endswith("_query"):       # the prefix stream's shape
            rec["prefix_stream"] = {
                dt: {k: records[(key.replace("_query", "_prefix"),
                                 d)][k]
                     for k in ("shape", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "library_fwd_bwd_ms")
                     if k in records[(key.replace("_query", "_prefix"), d)]}
                for dt, d in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32))}
        kernels.append(rec)
    kernels[-3]["flash_route"] = flash
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
