#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card.

Run from the repository root:  python3 chip_smoke.py
(python3 chip_smoke.py --lstm-split: only the one-off measurement of
kernels 1-2 and 3-4 (both routes each) launched eagerly against a CUDA
graph, beside cuDNN; one JSON line.)

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from fewshot_torch/ops/csrc (one nvcc per
     source, all started together; sm_90a), and count the tensor-core
     (HMMA) instructions in the SASS of the nine bf16 tensor-core kernels
     (the persistent LSTM forward and backward, per layer and for the
     stack, the head+CE forward and backward, the prefix-attention
     forward, dq and dk/dv); a tensor-core kernel with none, or any kernel
     instance that spills registers (ptxas -v), fails the run;
  3. each recurrence kernel against its plain PyTorch twin at full width
     (E=256, H=512, 2 layers; bf16 and fp32; ragged masks): the two
     forward kernels (and their train-mode gate activations) and the two
     backward kernels, with each kernel's time (CUDA events), its bound,
     the twin's time and torch.nn.LSTM (cuDNN, its weights compacted,
     three timings) at the same shape as a yardstick only: its forward for
     the forward kernels, its backward alone (the forward outside the
     timed window; forward and backward as a second figure) for the
     backward kernels; for the per-layer pair in bf16 (the persistent
     kernels) also the int8-gates mode (codes within one step of the
     twin's), the same state in both gates modes, the same bits from a
     second launch, the step kernels (v1) timed on the same inputs, and
     the clusters the card runs at once; for the stack pair in bf16 (the
     persistent layer wavefront) the same at both of training B's shapes
     (16 rows x 480 steps and 80 x 95, two launches a call), with the
     row tiles a launch holds;
  4. serving phase A, the bench config (support_mode=mean_state, batch 32,
     the per-layer kernel): an HTTP server answers concurrent /generate
     requests; the per-layer kernel's launch count must rise, all on its
     persistent route;
  5. serving phase B, the shipped config (support_mode=state, batch 16,
     the fused-stack kernel); the fused kernel's launch count must rise,
     all on its persistent route;
  6. training phase A, the bench config as bench.py trains it (B=32, 10
     steps per call, 2 warm-up calls, 4 timed calls): episodes/s, the
     loss of the first step and of the first and last calls (finite; the
     last call's below the first step's), one step's device idle share,
     one step's grads against the plain route; the per-layer forward and
     backward kernels must launch 4 times a step each, on their
     persistent route; then training A-int8, the same with the int8-gates
     branch (FEWSHOT_LSTM_GATES_INT8) for 3 calls;
  7. training phase B, the shipped config (support_mode=state, B=16): the
     fused-stack forward and backward kernels must launch 2 times a step
     each (the support pass and the query pass), on their persistent
     route;
  8. the V=5000 synthetic lyrics corpus, then the fused head+CE forward
     and backward kernels against their twins at training C's head shape
     (R = B*Q*(L-1) rows, D=256, V=5000, neither a multiple of the 64-wide
     tiles; targets at 0 and V-1), with torch.logsumexp of the dense
     logits (its autograd backward alone for the backward) as the
     yardstick, and each kernel's two launches on the same inputs
     bit-identical; the bf16 forward's time at each vocab split 1-8 beside
     the split it takes; then both kernels, both dtypes, against their
     twins at head widths D = 1024 and 2048 (300 rows, V=5000: the
     D-chunked bf16 kernels and the sliced fp32 backward), timed; after
     4-7, so that those phases run in a process like the one before the
     V=5000 path existed;
  9. training phase C, the V=5000 neural-cache stack
     (scripts/scale_quality.py's plain_cache_full_floor leg: mean_state,
     B=32, global backoff, calibration, dynamic cache, responsibility floor
     0.25) on that corpus, as A: the per-layer kernels (4 a step each and
     4 forwards per evaluation batch, on the persistent route) and the
     fused head+CE kernels' counts must rise; one step's grads, the cache
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
     dk/dv) as the yardstick, and dq and dk/dv bit-identical on a second
     launch;
 11. training phase D, the episodic transformer with the full cache stack
     (scripts/scale_quality.py's tfm_cache_full leg: 2 layers, E=256,
     nh=2, mean_state, B=32) on the V=5000 corpus, as C: the attention
     kernels' counters must show 3 launches each per step (the query
     stream's 2 layers, the prefix stream's first: the last layer's prefix
     tail is dead) and the head+CE kernels' one; one step's grads against
     the plain route (einsum attention, dense head); the validation NLL
     before and after, and the floor; the trained model's val NLL on the
     same episodes through the bf16 plain route and the fp32 plain route
     (the referee), recorded;
 12. serving phase C, the shipped transformer
     (configs/model/transformer.yaml: 4 layers, support_mode=state, batch
     16) on the bench corpus: the KV cache prefilled through the forward
     kernel (its count must rise) within tolerance of the einsum route;
 13. the cfg.flash route (row 10: ops.attention.causal_attention with
     use_flash) through the no-prefix kernel against the einsum route;
 13b. the training options of slice 12: training A and C with dropout
     0.1 on the kernel route (the loss finite, every kernel launched per
     step as without dropout, the persistent routes only, the trained
     weights' val NLL the same bits under dropout 0.1 and 0); training D
     with remat (one episode's grads against remat off, leaf by leaf:
     the same bits where three runs without remat give the same bits,
     else within REMAT_SPREAD times their largest difference; a train step
     each way: the attention forward launched twice as often under remat,
     the backward as often, the peak memory recorded); the finetune
     variant at full width (the LSTM cache recipe, B=16, two inner SGD
     steps at lr 0.05, cell=scan: 20 FOMAML steps with the loss falling,
     one eval batch, a checkpoint saved, restored bit-identical and served
     one batch of 16 rows; the kernel route refused; no kernel launched);
     and one short leg of ``python -m fewshot_torch.quality`` (60 steps,
     evals every 20 on 32 episodes) on the V=5000 corpus, its JSON checked
     (the cut recorded, the verdict withheld, the best-val parameters
     scored on JAX's 512 test episodes);
 14. the width repairs: kernels 1-2 on their step route in train mode at
     160 rows x 96 steps and H past the former shared-memory limits (fp32
     768 and 2048, bf16 1536 and 2560), and kernels 7-9 at the query
     stream's shape with head widths 24 (padded to 32), 192 and 256 (the
     column-window kernels), both dtypes: each against its twin with the
     tolerances of the narrower cases, timed beside its bound and its
     library call (cuDNN, SDPA), bit-identical on a second launch;
 15. the flagship cache recipe through the train CLI
     (``fewshot_torch.cli train --data configs/data/lyrics.yaml --model
     configs/model/lstm_pallas.yaml --task
     configs/task/episodic_cache.yaml``) on the V=5000 corpus: 500 steps
     in this process (kernels 3-4 on their persistent route, 2 backward
     launches a step; kernel 6 once a step), the parameters its checkpoint
     restores bit-identical to those saved, then ``python -m
     fewshot_torch.cli`` resumes to 1000 steps (cut from the recipe's
     2000; "restored checkpoint at step 500"); the loss falls, val NLL
     every 200 steps, the final val NLL beside the unigram floor; then
     served from the checkpoint (14 requests, serve batch 16) with the
     dynamic cache head:
     the first decode step's mixed log-probs against the plain route, each
     row's mixture normalised, the carried counts those of the emitted
     tokens; the same for configs/model/transformer.yaml (cell=pallas),
     200 steps (kernels 7-9 and 6 every step), its prefill on kernel 7;
     each trained checkpoint's support pass (the LSTM's state, the
     transformer's KV cache) through the bf16 kernel route, the same route
     on the kernels' plain twins and the bf16 plain route against the fp32
     plain route, layer by layer: the kernel route at most REFEREE_F times
     as far from it as the twins, and the LSTM's state within
     TRAINED_STATE_TOL of the plain route;
 15b. the last modules of the JAX package, on the V=5000 corpus: training
     C on the host episode pipeline (``data/host_pipeline.py``, one fed
     batch a step) beside the device sampler, 30 timed steps each after 3
     untimed: the loss falling, kernels 1-2 and 5-6 launched as in
     training C, the step time, episodes/s and (torch.profiler) the
     device's busy time and idle share, and the episode copies seen as
     pinned host-to-device copies on a stream no kernel of the port runs
     on; ``pipeline: host`` through the train CLI on the flagship recipe
     (150 steps with a val-pipeline eval and a checkpoint every 50, then
     resumed in a new process to 200; kernels 3-4 on their persistent
     route); the same leg to 50 steps as an NCCL world of one (the
     FEWSHOT_* variables, in this process): torch.distributed on nccl,
     one all-reduce a step and one an eval, the parameters at step 50 the
     same bits as the leg's; serving with rows sharded over [cuda:0,
     cuda:0] (the leg's checkpoint, and serving C's transformer; the two
     chunks share the card, so they run in turn): every continuation
     the single-device Generator's at the same chunk size (kernels 3 and
     7 launched), the share equal to a single batch of twice the rows
     recorded (gated for the LSTM); the native data tier built by g++
     here, and a 12,800-song synthetic lyrics corpus packed with
     native=True and native=False into the same corpus.npz, vocab.json
     and meta.json bytes;
 16. the MIDI path (scripts/midi_scale.py's plain_cache_floor leg at its
     published widths, 60 artists): synthetic .mid files (60-100 notes a
     song), packed by ``cli prepare --midi_root`` into the event corpus
     (V=204, L=400) and a 300-merge BPE corpus (two processes at once);
     kernels 1-2 (bf16) at 160 rows x 400 and 399 steps and kernels 5-6 at
     the two MIDI heads' shapes against their twins, timed beside cuDNN
     and logsumexp, bit-identical on a second launch; then through the CLI
     on configs/data/midi.yaml + configs/model/lstm.yaml +
     episodic_cache.yaml (mean_state, cell=pallas, bf16, B=32, floor
     0.25): 300 steps in this process (kernels 1-2 on their persistent
     route only, 4 backward launches a step, the checkpoint restoring the
     saved bits), ``make-eval-set`` on val, ``evaluate --eval_set
     --also_split_eval --per_artist`` and ``--baseline unigram``,
     ``sample --num 8`` (every .mid parsed back, notes counted), then
     served (8 requests, batch 16) under the grammar masks (every
     continuation whole SHIFT->PITCH->DUR->VEL groups) with the referee
     gate of 15 at T=400; the BPE corpus 100 steps, evaluated per base
     token, sampled into .mid files that parse;
 17. the card line, a {"kernels": [...]} line, then the {"ok": true, ...}
     line.

Weights are random from a seed; the corpora (the bench corpus, the
V=5000 scale corpus of scripts/scale_test.py and the MIDI corpora) are
synthetic, built offline in temporary directories, through the native
data tier.  fp32 matmuls run in full fp32
(TF32 off for both matmul and cuDNN).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
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
# int8-coded gates (FEWSHOT_LSTM_GATES_INT8) against the twin's codes: one
# code step, where an activation that differs in its last bits rounds to
# the neighbouring code
GATES_INT8_TOL = 1.0
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
# a trained checkpoint's support pass (F written in PERF.md before the first
# run that read it): against an fp32 referee (the plain route in fp32), the
# bf16 kernel route may be at most REFEREE_F times as far as the same route
# on the kernels' plain twins, in every layer (the transformer's K and V,
# the LSTM's h and c, each relative to the referee's largest entry in the
# layer; referee_check); and the trained LSTM's state, kernel route against
# the bf16 plain route, within TRAINED_STATE_TOL of each layer's largest
# |h| and |c|
REFEREE_F = 2.0
TRAINED_STATE_TOL = 2e-2
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
WIDE_HEAD_D = (1024, 2048)   # head widths past the resident tiles
WIDE_HEAD_ROWS = 300         # rows of the wide-head check (ragged tiles)
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
YARD_TIMINGS = 3         # timings of each cuDNN yardstick (their spread)
ROUNDS = 3              # rounds of 7 requests per serving phase
TRAIN_WARMUP, TRAIN_CALLS = 2, 4    # calls of steps_per_call steps


T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


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


def cudnn_lstm(wh, b, in_dim, layers, dtype):
    """torch.nn.LSTM (cuDNN) holding the kernels' Wh and bias, built on the
    card in dtype: the yardstick only.

    Gates permuted from (i, j, f, o) to PyTorch's (i, f, g, o), forget bias
    folded into bias_ih.  It also projects its input (the kernels take that
    projection precomputed) and has no mask.  Its weights are compacted into
    cuDNN's one buffer after the copies: flatten_parameters() skips that in
    bf16 (torch.backends.cudnn.is_acceptable admits fp16/32/64 only), and
    an uncompacted module copies its weights into a new buffer at every
    call (PyTorch warns so), which moved the bf16 timings up to 1.6x."""
    import torch.backends.cudnn.rnn as cudnn_rnn
    hid = wh.shape[-2]
    lstm = torch.nn.LSTM(in_dim, hid, num_layers=layers, device=wh.device,
                         dtype=dtype)
    perm = torch.cat([torch.arange(0, hid), torch.arange(2 * hid, 3 * hid),
                      torch.arange(hid, 2 * hid),
                      torch.arange(3 * hid, 4 * hid)])
    bias = b.float().clone()
    bias[..., 2 * hid:3 * hid] += 1.0
    with torch.no_grad():
        for l in range(layers):
            w = wh[l] if wh.dim() == 3 else wh
            bl = bias[l] if bias.dim() == 2 else bias
            getattr(lstm, f"weight_hh_l{l}").copy_(w[:, perm].T)
            getattr(lstm, f"bias_ih_l{l}").copy_(bl[perm])
            getattr(lstm, f"bias_hh_l{l}").zero_()
        torch._cudnn_rnn_flatten_weight(
            lstm._flat_weights, 4, in_dim, cudnn_rnn.get_cudnn_mode("LSTM"),
            hid, 0, layers, False, False)
    return lstm


def cudnn_lstm_ms(wh, b, steps, rows, in_dim, layers, dtype,
                  backward=False) -> dict:
    """torch.nn.LSTM (cuDNN) at the kernels' shape, timed YARD_TIMINGS
    times after a warm-up: {"ms": the median, "runs": every timing,
    "busy_ms": the median of YARD_TIMINGS profiles of one call's kernel
    time, which no gap between its kernels enters (the calls are
    host-bound: their launches take longer than their kernels), its
    "busy_runs", "top_kernels": its largest kernels, and the host's wall
    time of one call}; with backward, "ms" is its backward alone (the
    input and weight grads of a forward run once outside the timed window)
    and "fwd_bwd_ms" the median of forward and backward together.  Fails if
    PyTorch warns that the weights are not compacted."""
    import warnings
    lstm = cudnn_lstm(wh, b, in_dim, layers, dtype)
    x = torch.randn(steps, rows, in_dim, device=wh.device, dtype=dtype,
                    requires_grad=backward)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if backward:
            leaves = [x, *lstm.parameters()]
            runs = [backward_ms(lambda: (lstm(x)[0],), leaves)
                    for _ in range(YARD_TIMINGS)]
            outs = (lstm(x)[0],)
            cot = (torch.ones_like(outs[0]),)
            busy = [device_busy_ms(
                lambda: torch.autograd.grad(outs, leaves, cot,
                                            retain_graph=True), top=4)
                for _ in range(YARD_TIMINGS)]
            out = {"ms": statistics.median(r[0] for r in runs),
                   "fwd_bwd_ms": statistics.median(r[1] for r in runs),
                   "runs": runs}
        else:
            with torch.no_grad():
                runs = [cuda_ms(lambda: lstm(x), KERNEL_REPS)
                        for _ in range(YARD_TIMINGS)]
                busy = [device_busy_ms(lambda: lstm(x), top=4)
                        for _ in range(YARD_TIMINGS)]
                out = {"ms": statistics.median(runs), "runs": runs,
                       "host_ms": host_ms(lambda: lstm(x))}
        out.update(busy_ms=statistics.median(b[0] or 0.0 for b in busy),
                   busy_runs=[b[0] for b in busy], top_kernels=busy[-1][1])
    compacted = [str(w.message) for w in caught
                 if "contiguous chunk" in str(w.message)]
    if compacted:
        raise RuntimeError(f"cuDNN yardstick {dtype}: weights not "
                           f"compacted: {compacted[0]}")
    return out


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
    # ms; a backward's (alone, fwd + bwd); or cudnn_lstm_ms's dict
    lib = library()
    lib_runs = lib.get("runs") if isinstance(lib, dict) else None
    if isinstance(lib, dict):
        lib_ms, lib_both = lib["ms"], lib.get("fwd_bwd_ms")
    else:
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
    if lib_runs is not None:
        rec["library_runs"] = lib_runs
        rec["library_busy_ms"] = lib["busy_ms"]
        rec["library_busy_runs"] = lib["busy_runs"]
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


def same_bits(fn) -> bool:
    """Two calls of fn() on the same inputs give the same bits."""
    with torch.no_grad():
        first, second = fn(), fn()
        torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(first, second))


def layer_persist_checks(args, bargs, ops, dtype, lead) -> dict:
    """Kernels 1-2 on their persistent route (bf16 at training A's shape),
    beyond check_kernel: the int8 gates mode, timed and held against the
    twin's codes (GATES_INT8_TOL) and, in the backward, against the twin on
    the same codes; the same state in both gates modes; the same bits from
    a second launch; the step kernels (v1) on the same inputs, timed beside
    it; and how many clusters the card runs at once (into `lead`, the
    forward's record).  Returns records keyed as kernel_phase's."""
    from functools import partial
    from fewshot_torch.ops import _ext, lstm_layer as ll
    none = lambda: None                                          # noqa
    coded_kw = {"save_gates": True, "gates_dtype": torch.int8}
    recs = {("layer_int8", dtype): check_kernel(
        "lstm_layer_fwd", ll.lstm_layer_fwd, ll.lstm_layer_fwd_plain, args,
        FWD_TOL[dtype] + [GATES_INT8_TOL], False, ops, dtype, none,
        kw=coded_kw)}
    with torch.no_grad():
        coded = ll.lstm_layer_fwd(*args, **coded_kw)
        stream_gates = ll.lstm_layer_fwd(*args, save_gates=True)
    bargs8 = (coded[4], bargs[1], bargs[2], coded[1]) + bargs[4:]
    recs[("layer_bwd_int8", dtype)] = check_kernel(
        "lstm_layer_bwd", ll.lstm_layer_bwd, ll.lstm_layer_bwd_plain, bargs8,
        [BWD_TOL[dtype]] * 4, True, ops, dtype, none)
    checks = {
        "state_same_in_both_gates_modes": all(
            torch.equal(x, y) for x, y in zip(coded[:4], stream_gates[:4])),
        "fwd_deterministic": same_bits(
            lambda: ll.lstm_layer_fwd(*args, save_gates=True)),
        "fwd_int8_deterministic": same_bits(
            lambda: ll.lstm_layer_fwd(*args, **coded_kw)),
        "bwd_deterministic": same_bits(lambda: ll.lstm_layer_bwd(*bargs)),
        "bwd_int8_deterministic": same_bits(
            lambda: ll.lstm_layer_bwd(*bargs8))}
    log(f"  persistent route {dtype}: {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"persistent LSTM kernels {dtype}: {checks}")
    recs[("layer_v1", dtype)] = check_kernel(
        "lstm_layer_fwd (step kernels)",
        partial(ll.lstm_layer_fwd, route="step"), ll.lstm_layer_fwd_plain,
        args, FWD_TOL[dtype], False, ops, dtype, none)
    recs[("layer_bwd_v1", dtype)] = check_kernel(
        "lstm_layer_bwd (step kernels)",
        partial(ll.lstm_layer_bwd, route="step"), ll.lstm_layer_bwd_plain,
        bargs, [BWD_TOL[dtype]] * 4, True, ops, dtype, none)
    clusters = {"fwd": _ext.load("lstm_fwd").lstm_fwd_persist_clusters(H),
                "bwd": _ext.load("lstm_bwd").lstm_bwd_persist_clusters(H)}
    log(f"  persistent route: clusters of {H // 32} blocks the card runs at "
        f"once {clusters}")
    lead.update(checks, max_active_clusters=clusters)
    return recs


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
        route = "persistent" if lstm_layer.persistent_route(
            rows, H, dtype) else "step"
        for key in ("layer", "layer_bwd"):
            records[(key, dtype)]["route"] = route
        if route == "persistent":
            records.update(layer_persist_checks(
                args, bargs, 2.0 * live * H * 4 * H, dtype,
                records[("layer", dtype)]))
        # kernels 3 and 4: state support pass, 16 episodes x 5 songs x L=96,
        # and (bf16, the persistent route) the query pass, 16 x 5 songs x
        # L-1 = 95 steps
        shapes = (("stack", 480, 16, 5), ("stack_query", 95, 80, 1))
        for key, t_, rows, songs in shapes[:1 if dtype == torch.float32
                                           else 2]:
            records.update(stack_checks(key, t_, rows, songs, dtype, rand,
                                        unif, gen, dev))
    return records


def stack_checks(key, t_, rows, songs, dtype, rand, unif, gen, dev) -> dict:
    """Kernels 3 and 4 at one of training B's shapes against their twins,
    with cuDNN's yardstick; on their persistent route (bf16) also the same
    bits from a second launch, the step kernels (v1) timed on the same
    inputs, and how many row tiles a launch holds (one launch per
    stack_row_splits range).  Returns records keyed as kernel_phase's."""
    from functools import partial
    from fewshot_torch.ops import lstm_stack
    mask = ragged_mask(gen, t_, rows, songs).to(dev)
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
    fwd = check_kernel("lstm_stack_fwd", lstm_stack.lstm_stack_fwd,
                       lstm_stack.lstm_stack_fwd_plain, args, FWD_TOL[dtype],
                       False, ops, dtype, yard)
    fwd["gates_max_abs_err"] = gates_err(
        "lstm_stack_fwd", lstm_stack.lstm_stack_fwd,
        lstm_stack.lstm_stack_fwd_plain, args, dtype)
    with torch.no_grad():
        _, cs, _, _, gates = lstm_stack.lstm_stack_fwd(*args, save_gates=True)
    bargs = (gates, args[1], args[2], mask, cs, args[6],
             rand(t_, rows, H).to(dtype), rand(LAYERS, rows, H),
             rand(LAYERS, rows, H))
    bwd = check_kernel(
        "lstm_stack_bwd", lstm_stack.lstm_stack_bwd,
        lstm_stack.lstm_stack_bwd_plain, bargs, [BWD_TOL[dtype]] * 4, True,
        ops, dtype, lambda: cudnn_lstm_ms(args[2], args[3], t_, rows, E,
                                          LAYERS, dtype, backward=True))
    recs = {(key, dtype): fwd, (key.replace("stack", "stack_bwd"), dtype): bwd}
    route = "persistent" if lstm_stack.stack_persistent_route(
        rows, H, LAYERS, dtype) else "step"
    fwd["route"] = bwd["route"] = route
    if route == "step":
        return recs
    none = lambda: None                                          # noqa
    checks = {
        "fwd_deterministic": same_bits(
            lambda: lstm_stack.lstm_stack_fwd(*args, save_gates=True)),
        "bwd_deterministic": same_bits(
            lambda: lstm_stack.lstm_stack_bwd(*bargs))}
    log(f"  persistent stack {rows} x {t_} {dtype}: {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"persistent stack kernels {dtype}: {checks}")
    fwd["v1"] = check_kernel(
        "lstm_stack_fwd (step kernels)",
        partial(lstm_stack.lstm_stack_fwd, route="step"),
        lstm_stack.lstm_stack_fwd_plain, args, FWD_TOL[dtype], False, ops,
        dtype, none)
    bwd["v1"] = check_kernel(
        "lstm_stack_bwd (step kernels)",
        partial(lstm_stack.lstm_stack_bwd, route="step"),
        lstm_stack.lstm_stack_bwd_plain, bargs, [BWD_TOL[dtype]] * 4, True,
        ops, dtype, none)
    calls = {"fwd": lambda: lstm_stack.lstm_stack_fwd(*args,
                                                      save_gates=True),
             "bwd": lambda: lstm_stack.lstm_stack_bwd(*bargs)}
    for rec, kernel, name in ((fwd, "lstm_fwd", "fwd"),
                              (bwd, "lstm_bwd", "bwd")):
        tiles = lstm_stack.launch_tiles(kernel, H, LAYERS, dev)
        rec.update(checks, tiles_per_launch=tiles,
                   launches_per_call=len(lstm_stack.stack_row_splits(
                       rows, tiles)))
        log(f"  persistent stack {name}: {tiles} row tiles a launch, "
            f"{rec['launches_per_call']} launch(es) a call at {rows} rows")
        if rec["launches_per_call"] > 1:
            rec["oversize_launch_refused"] = oversize_refused(
                calls[name], lambda *a, n=tiles: n + 1)
    return recs


def oversize_refused(call, tiles) -> bool:
    """A persistent stack launch of more row tiles than the card holds at
    once (launch_tiles replaced by `tiles` for one call) is refused by the
    cooperative launch, the wrapper raises, and the next call runs."""
    from fewshot_torch.ops import lstm_stack
    real = lstm_stack.launch_tiles
    lstm_stack.launch_tiles = tiles
    try:
        with torch.no_grad():
            call()
        refused = False
    except RuntimeError as e:
        refused = "CUDA error 720" in str(e)
    finally:
        lstm_stack.launch_tiles = real
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    log(f"  a launch past co-residency refused: {refused}")
    if not refused:
        raise RuntimeError("an oversize persistent stack launch ran")
    return refused


def graph_ms(fn, reps: int) -> float:
    """Device time of one replay of a CUDA graph that holds the launches of
    one fn() call, by cuda_ms (fn runs once before the capture)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps)


def lstm_launch_split(dev) -> dict:
    """Kernels 1-2 at training A's shape (160 rows x 96 steps, H=512,
    bf16, ragged mask) on each route: launched eagerly and replayed from a
    CUDA graph, both by cuda_ms, so that the difference is what the
    launches themselves cost on the card; the host's wall time of one call
    (host_ms); and cuDNN's yardstick, three timings each.  A one-off
    measurement (--lstm-split), not a phase of the default run."""
    from fewshot_torch.ops import lstm_layer
    gen = torch.Generator().manual_seed(0)
    dtype, t_, rows = torch.bfloat16, 96, 160
    lim = (6.0 / (5 * H)) ** 0.5
    mask = ragged_mask(gen, t_, rows, 1).to(dev)
    zx = (torch.randn((t_, rows, 4 * H), generator=gen) * 0.6).to(dev, dtype)
    wh = ((torch.rand((H, 4 * H), generator=gen) * 2 - 1) * lim).to(dev,
                                                                   dtype)
    b = (torch.randn(4 * H, generator=gen) * 0.1).to(dev)
    h0, c0 = ((torch.randn((rows, H), generator=gen) * 0.5).to(dev)
              for _ in range(2))
    dys = torch.randn((t_, rows, H), generator=gen).to(dev, dtype)
    dhT, dcT = (torch.randn((rows, H), generator=gen).to(dev)
                for _ in range(2))
    out = {"shape": [t_, rows, H], "dtype": "bfloat16"}
    with torch.no_grad():
        for route in lstm_layer.ROUTES:
            def fwd(r=route):
                return lstm_layer.lstm_layer_fwd(zx, wh, b, mask, h0, c0,
                                                 save_gates=True, route=r)
            _, cs, _, _, gates = fwd()

            def bwd(r=route, g=gates, c=cs):
                return lstm_layer.lstm_layer_bwd(g, wh, mask, c, c0, dys,
                                                 dhT, dcT, route=r)
            rec = {}
            for name, fn, launches in (("fwd", fwd, t_), ("bwd", bwd,
                                                          t_ + 1)):
                eager, graph = cuda_ms(fn, KERNEL_REPS), graph_ms(fn,
                                                                  KERNEL_REPS)
                rec[name] = {"eager_ms": eager, "graph_ms": graph,
                             "host_ms": host_ms(fn)}
                if route == "step":
                    rec[name]["step_launches"] = launches
                    rec[name]["launch_share_us_per_launch"] = \
                        (eager - graph) * 1e3 / launches
            out[route] = rec
    out["cudnn"] = {
        "fwd": cudnn_lstm_ms(wh, b, t_, rows, H, 1, dtype),
        "bwd": cudnn_lstm_ms(wh, b, t_, rows, H, 1, dtype, backward=True)}
    out["stack"] = stack_launch_split(dev, gen)
    return out


def stack_launch_split(dev, gen) -> dict:
    """Kernels 3-4 at training B's shape (16 rows x 480 steps, 2 layers,
    H=512, bf16) on each route, as lstm_launch_split: eagerly and from a
    CUDA graph, the host's wall time, and cuDNN's yardstick (2 layers,
    input width E); and one layer's recurrence alone on kernels 1-2's
    persistent route at the same shape."""
    from fewshot_torch.ops import lstm_layer, lstm_stack
    dtype, t_, rows = torch.bfloat16, 480, 16
    lim = (6.0 / (5 * H)) ** 0.5
    mask = ragged_mask(gen, t_, rows, 5).to(dev)

    def unif(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * lim).to(dev,
                                                                    dtype)
    zx = (torch.randn((t_, rows, 4 * H), generator=gen) * 0.6).to(dev, dtype)
    wx, wh = unif(LAYERS - 1, H, 4 * H), unif(LAYERS, H, 4 * H)
    b = (torch.randn((LAYERS, 4 * H), generator=gen) * 0.1).to(dev)
    h0, c0, dhT, dcT = ((torch.randn((LAYERS, rows, H), generator=gen)
                         * 0.5).to(dev) for _ in range(4))
    dys = torch.randn((t_, rows, H), generator=gen).to(dev, dtype)
    out = {"shape": [LAYERS, t_, rows, H], "dtype": "bfloat16"}
    with torch.no_grad():
        for route in lstm_stack.ROUTES:
            def fwd(r=route):
                return lstm_stack.lstm_stack_fwd(zx, wx, wh, b, mask, h0, c0,
                                                 save_gates=True, route=r)
            _, cs, _, _, gates = fwd()

            def bwd(r=route, g=gates, c=cs):
                return lstm_stack.lstm_stack_bwd(g, wx, wh, mask, c, c0, dys,
                                                 dhT, dcT, route=r)
            rec = {}
            for name, fn, launches in (("fwd", fwd, LAYERS * t_),
                                       ("bwd", bwd, LAYERS * (t_ + 1))):
                eager, graph = cuda_ms(fn, KERNEL_REPS), graph_ms(fn,
                                                                  KERNEL_REPS)
                rec[name] = {"eager_ms": eager, "graph_ms": graph,
                             "host_ms": host_ms(fn)}
                if route == "step":
                    rec[name]["step_launches"] = launches
                    rec[name]["launch_share_us_per_launch"] = \
                        (eager - graph) * 1e3 / launches
            out[route] = rec
        # one recurrence alone: layer 0 through kernels 1-2's persistent
        # route at the same shape, what the wavefront costs at best
        _, cs0, _, _, g0 = lstm_layer.lstm_layer_fwd(
            zx, wh[0], b[0], mask, h0[0], c0[0], save_gates=True)
        out["one_layer_persistent"] = {
            "fwd_ms": cuda_ms(lambda: lstm_layer.lstm_layer_fwd(
                zx, wh[0], b[0], mask, h0[0], c0[0], save_gates=True),
                KERNEL_REPS),
            "bwd_ms": cuda_ms(lambda: lstm_layer.lstm_layer_bwd(
                g0, wh[0], mask, cs0, c0[0], dys, dhT[0], dcT[0]),
                KERNEL_REPS)}
    out["cudnn"] = {
        "fwd": cudnn_lstm_ms(wh, b, t_, rows, E, LAYERS, dtype),
        "bwd": cudnn_lstm_ms(wh, b, t_, rows, E, LAYERS, dtype,
                             backward=True)}
    return out


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


def head_inputs(gen, dev, dtype, rows: int, d: int, vocab: int):
    """h2 [rows, d], the tied head w [d, vocab] (a transposed view of a
    [vocab, d] table), b, targets (0 and vocab - 1 among them), dlse, dtl."""
    h2 = torch.randn((rows, d), generator=gen).to(dev, dtype)
    table = torch.randn((vocab, d), generator=gen) * d ** -0.5
    w = table.to(dev).T
    b = (torch.randn(vocab, generator=gen) * 0.5).to(dev)
    t = torch.randint(0, vocab, (rows,), generator=gen)
    t[0], t[-1] = 0, vocab - 1
    dlse = torch.rand((rows,), generator=gen).to(dev)
    dtl = -torch.rand((rows,), generator=gen).to(dev)
    return h2, w, b, t.to(dev), dlse, dtl


def head_checks(h2, w, b, t, dlse, dtl, dtype, records, key) -> None:
    """Kernels 5 and 6 against their twins on these inputs, each with its
    second launch's bits, into records[(key_fwd / key_bwd, dtype)]."""
    from fewshot_torch.ops import head_ce
    rows, d = h2.shape
    products = 2.0 * rows * d * w.shape[1]
    fwd = check_kernel(
        "head_ce_fwd", head_ce.head_ce_fwd, head_ce.head_lse_tgt_plain,
        (h2, w, b, t), [HEAD_FWD_TOL[dtype]] * 2, False, products, dtype,
        lambda: head_library_ms(h2, w, b, t))
    with torch.no_grad():
        lse, _ = head_ce.head_lse_tgt_plain(h2, w, b, t)
    # the function's least work: the logits once, dh2 and dw (the
    # kernels recompute the logits in each of their two passes)
    bargs = (h2, w, b, t, lse, dlse, dtl)
    bwd = check_kernel(
        "head_ce_bwd", head_ce.head_ce_bwd, head_ce.head_lse_tgt_bwd_plain,
        bargs, [HEAD_BWD_TOL[dtype]] * 3, True, 3 * products, dtype,
        lambda: head_library_ms(h2, w, b, t, (dlse, dtl)))
    # two launches on the same inputs: the same bits
    for name, rec, fn in (
            ("head_ce_fwd", fwd, lambda: head_ce.head_ce_fwd(h2, w, b, t)),
            ("head_ce_bwd", bwd, lambda: head_ce.head_ce_bwd(*bargs))):
        same = same_bits(fn)
        rec["deterministic"] = same
        log(f"  {name} {dtype} D={d}: two launches bit-identical: {same}")
        if not same:
            raise RuntimeError(f"{name} {dtype} D={d} is not deterministic")
    records[(key + "_fwd", dtype)] = fwd
    records[(key + "_bwd", dtype)] = bwd


def head_kernel_phase(dev, rows: int, vocab: int) -> dict:
    """Kernels 5 and 6 against their twins at training C's head shape, the
    bf16 forward's time at each vocab split, and both kernels at the wide
    head widths."""
    from fewshot_torch.ops import head_ce
    gen = torch.Generator().manual_seed(1)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        ins = head_inputs(gen, dev, dtype, rows, HEAD_D, vocab)
        head_checks(*ins, dtype, records, "head")
        if dtype == torch.bfloat16:   # the split at this and a few rows
            fwd = records[("head_fwd", dtype)]
            for n, h2 in ((rows, ins[0]), (WIDE_HEAD_ROWS,
                                           ins[0][:WIDE_HEAD_ROWS])):
                t = ins[3][:n]
                split = head_ce.fwd_splits(n, vocab, HEAD_D)
                with torch.no_grad():
                    ms = {s: cuda_ms(lambda: head_ce.head_ce_fwd(
                        h2, ins[1], ins[2], t, splits=s), KERNEL_REPS)
                        for s in range(1, 9)}
                fwd.setdefault("split", {})[n] = {"splits": split,
                                                  "ms_by_split": ms}
                log(f"  head_ce_fwd bf16 at {n} rows: split {split}; ms by "
                    f"split {ms}")
    for d in WIDE_HEAD_D:
        log(f"  wide head: {WIDE_HEAD_ROWS} x {d} x {vocab}")
        for dtype in (torch.bfloat16, torch.float32):
            ins = head_inputs(gen, dev, dtype, WIDE_HEAD_ROWS, d, vocab)
            head_checks(*ins, dtype, records, f"head_d{d}")
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


def attn_inputs(gen, dev, dtype, b, q_, t, p, hd=ATTN_HD):
    """Random streams and ragged masks at one attention shape (nh = 2
    heads of hd): S = b q_ songs of t rows with key masks t' < len (len >=
    2, so every row has a real key), and (p > 0) an episode prefix of 5
    support songs of p / 5 slots each, every song at least 1 token long."""
    s_, e = b * q_, 2 * hd
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


def attn_kernel_phase(dev, shapes, hd=ATTN_HD, seed=2) -> dict:
    """The three prefix-attention kernels against their twins at the
    training path's shapes: shapes = {label: (B, Q, T, P)}, nh = 2 heads of
    hd.  Bound: the inputs read once and the outputs written once against
    the products the function needs over its real (row, key) pairs: 2 in
    the forward (q k^T, p v), 3 for dq (q k^T, g v^T, ds k), 4 for dk/dv
    (q k^T, g v^T, p^T g, ds^T q), each 2 hd operations a pair and head.
    Each kernel gives the same bits on a second launch."""
    from fewshot_torch.ops import prefix_attention as pa
    gen = torch.Generator().manual_seed(seed)
    records = {}
    for label, (b, q_, t, p) in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            args = attn_inputs(gen, dev, dtype, b, q_, t, p, hd)
            q, k, v, kmask, pk, pv, pmask, nh = args
            pair_ops = 2.0 * hd * nh * attn_pairs(kmask, pmask, q_)
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
            # two launches on the same inputs: the same bits
            for key, fn in (("fwd", lambda: pa.prefix_attn_fwd(*args)),
                            ("dq", lambda: (pa.prefix_attn_bwd_dq(*bargs),)),
                            ("dkv", lambda: pa.prefix_attn_bwd_dkv(*bargs))):
                same = same_bits(fn)
                records[(f"attn_{key}_{label}", dtype)]["deterministic"] = \
                    same
                log(f"  prefix_attn {key} {label} {dtype}: two launches "
                    f"bit-identical: {same}")
                if not same:
                    raise RuntimeError(f"prefix_attn {key} {label} "
                                       f"{dtype} is not deterministic")
            for key in ("fwd", "dq", "dkv"):
                records[(f"attn_{key}_{label}", dtype)]["shape"] = \
                    [b, q_, t, p, nh, hd]
    return records


# ---------------------------------------------------------------------------
# the width repairs: kernels 1-2 past their former shared-memory limits,
# kernels 7-9 at any head width
# ---------------------------------------------------------------------------

WIDE_LSTM = ((torch.float32, 768), (torch.float32, 2048),
             (torch.bfloat16, 1536), (torch.bfloat16, 2560))
WIDE_HD = (24, 192, 256)     # padded to 32; column windows past 128


def wide_lstm_phase(dev) -> dict:
    """Kernels 1-2 on their step route in train mode (the forward saving
    its gates, then the backward) at 160 rows x 96 steps and hidden widths
    the whole-row stage refused, against their twins with the tolerances
    of H = 512; timed beside their bound and cuDNN; two launches give the
    same bits."""
    from fewshot_torch.ops import lstm_layer
    gen = torch.Generator().manual_seed(4)
    t_, rows = 96, 160
    records = {}
    for dtype, hid in WIDE_LSTM:
        lim = (6.0 / (5 * hid)) ** 0.5

        def rand(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).to(dev)
        mask = ragged_mask(gen, t_, rows, 1).to(dev)
        live = float(mask.sum())
        wh = ((torch.rand((hid, 4 * hid), generator=gen) * 2 - 1)
              * lim).to(dev, dtype)
        args = (rand(t_, rows, 4 * hid, scale=0.6).to(dtype), wh,
                rand(4 * hid, scale=0.1), mask, rand(rows, hid, scale=0.5),
                rand(rows, hid, scale=0.5))
        ops = 2.0 * live * hid * 4 * hid

        def fwd(*a):
            return lstm_layer.lstm_layer_fwd(*a, save_gates=True,
                                             route="step")

        def fwd_plain(*a):
            return lstm_layer.lstm_layer_fwd_plain(*a, save_gates=True)
        key = f"layer_h{hid}"
        records[(key, dtype)] = check_kernel(
            f"lstm_layer_fwd H={hid}", fwd, fwd_plain, args,
            FWD_TOL[dtype] + [GATES_TOL[dtype]], False, ops, dtype,
            lambda: cudnn_lstm_ms(wh, args[2], t_, rows, hid, 1, dtype))
        with torch.no_grad():
            _, cs, _, _, gates = fwd(*args)
        bargs = (gates, wh, mask, cs, args[5], rand(t_, rows, hid).to(dtype),
                 rand(rows, hid), rand(rows, hid))
        records[(key + "_bwd", dtype)] = check_kernel(
            f"lstm_layer_bwd H={hid}",
            lambda *a: lstm_layer.lstm_layer_bwd(*a, route="step"),
            lstm_layer.lstm_layer_bwd_plain, bargs, [BWD_TOL[dtype]] * 4,
            True, ops, dtype,
            lambda: cudnn_lstm_ms(wh, args[2], t_, rows, hid, 1, dtype,
                                  backward=True))
        for k, fn in ((key, lambda: fwd(*args)),
                      (key + "_bwd", lambda: lstm_layer.lstm_layer_bwd(
                          *bargs, route="step"))):
            same = same_bits(fn)
            records[(k, dtype)]["deterministic"] = same
            log(f"  {k} {dtype}: two launches bit-identical: {same}")
            if not same:
                raise RuntimeError(f"{k} {dtype} is not deterministic")
    return records


def wide_records(records, keys, dtypes=(torch.bfloat16, torch.float32)):
    """{key: {dtype: the record's numbers}} for the kernels line."""
    fields = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms", "library_fwd_bwd_ms",
              "deterministic")
    return {key: {str(dt).replace("torch.", ""): {
        f: records[(key, dt)][f] for f in fields if f in records[(key, dt)]}
        for dt in dtypes if (key, dt) in records} for key in keys}


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


def support_layers(params, ep, cfg) -> list:
    """The served support pass, by layer: [K, V] of the transformer's
    prefilled cache, or [h, c] of the LSTM's support state."""
    from fewshot_torch import sampling
    from fewshot_torch.models import lm
    with torch.inference_mode():
        if cfg.model == "transformer":
            cache, _ = sampling.prefix_cache(params, ep.support,
                                             ep.support_len, cfg, 0)
            return [[cache["k"][l], cache["v"][l]]
                    for l in range(cfg.num_layers)]
        return [[h, c] for h, c in lm.support_state(
            params, ep.support, ep.support_len, cfg, eval_mode=True)]


def layer_rel_errs(got, want) -> list:
    """Per layer: the largest error of its tensors, each relative to the
    largest entry of want's."""
    return [max(max_rel(g, w)[1] for g, w in zip(gl, wl))
            for gl, wl in zip(got, want)]


@contextlib.contextmanager
def kernel_twins():
    """The support pass's kernel wrappers replaced by their plain twins:
    the kernel route's rounding points (the bf16 streams of the LSTM
    kernels, p rounded in the attention) without its kernels."""
    from fewshot_torch.ops import lstm_layer, lstm_stack, prefix_attention
    swaps = [(lstm_layer, "lstm_layer_fwd", lstm_layer.lstm_layer_fwd_plain),
             (lstm_stack, "lstm_stack_fwd", lstm_stack.lstm_stack_fwd_plain),
             (prefix_attention, "prefix_attn_fwd",
              prefix_attention.prefix_attn_fwd_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def referee_check(label, cfg, params, ep) -> dict:
    """A trained checkpoint's support pass against the fp32 plain route
    (the referee), per layer, through three bf16 routes: the kernels, the
    same route on the kernels' plain twins (their rounding points), and
    the plain route (scan / einsum).  The kernel route may be at most
    REFEREE_F times as far from the referee as its twins are, in every
    layer; the plain route's distance is recorded beside them.  (The
    twins, not the plain route, are the yardstick: the LSTM kernels take
    layer 0's input projection as a bf16 stream, as JAX's Pallas route
    does, fewshot/ops/lstm_fused.py:419, a rounding the scan route does
    not make, which put the kernel route up to 2.02x the scan route's
    distance while it matched its twins' to five digits.)"""
    ref = support_layers(params, ep, dataclasses.replace(
        plain_route(cfg), compute_dtype="float32"))
    kern = layer_rel_errs(support_layers(params, ep, cfg), ref)
    plain = layer_rel_errs(support_layers(params, ep, plain_route(cfg)), ref)
    with kernel_twins():
        twin = layer_rel_errs(support_layers(params, ep, cfg), ref)

    def ratios(num, den):
        return [n / d if d > 0 else (0.0 if n == 0 else float("inf"))
                for n, d in zip(num, den)]
    rec = {"kernel_rel_err_vs_fp32": kern, "twin_rel_err_vs_fp32": twin,
           "plain_rel_err_vs_fp32": plain, "ratio": ratios(kern, twin),
           "ratio_vs_plain": ratios(kern, plain), "factor": REFEREE_F}
    rec["ok"] = all(r <= REFEREE_F for r in rec["ratio"])
    log(f"  {label} fp32 referee, by layer: {json.dumps(rec)}")
    if not rec["ok"]:
        raise RuntimeError(f"{label}: the kernel route's support pass is "
                           f"more than {REFEREE_F}x as far from the fp32 "
                           f"referee as its twins': {rec}")
    return rec


def check_reply(label, cfg, payload, status, body) -> int:
    """One /generate reply's continuations well formed (MIDI: whole note
    groups in SHIFT->PITCH->DUR->VEL order, each decoded into a note);
    returns the tokens they hold."""
    outs = body.get("continuations", [])
    if status != 200 or len(outs) != payload["num"]:
        raise RuntimeError(f"{label}: bad reply {status} {body}")
    tokens = 0
    for rec in outs:
        if not 0 <= rec["tokens"] <= cfg.sample_tokens:
            raise RuntimeError(f"{label}: malformed continuation {rec}")
        if cfg.dataset == "midi":
            kinds = [e.split("_")[0] for e in rec.get("events", [])]
            groups = len(kinds) // 4
            if len(kinds) % 4 or rec.get("notes") != groups or kinds != \
                    ["SHIFT", "PITCH", "DUR", "VEL"] * groups:
                raise RuntimeError(f"{label}: events off the grammar {rec}")
        elif not isinstance(rec.get("text"), str):
            raise RuntimeError(f"{label}: malformed continuation {rec}")
        if "artist" in payload and rec["artist"] != payload["artist"]:
            raise RuntimeError(f"{label}: wrong artist {rec}")
        tokens += rec["tokens"]
    return tokens


def serving_phase(label, cfg, corpus, dev, counter, persistent=(),
                  params=None, requests=7 * ROUNDS) -> dict:
    """POST /generate requests to a live server of cfg (random weights from
    cfg.seed unless params are given: a trained checkpoint's), 4 at once
    then 3 in turn, in rounds of 7."""
    from fewshot_torch.models import lm
    from fewshot_torch.serve import Generator, serve

    trained = params is not None
    if not trained:
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
        for rnd in range(-(-requests // 7)):
            payloads += [{"num": 4, "split": "train",
                          "episode_seed": 10 * rnd + i, "temperature": t}
                         for i, t in enumerate((0.7, 1.0, 1.2, 0.9))]
            payloads += [{"num": 2, "artist": name, "temperature": 0.8,
                          "episode_seed": rnd},
                         {"num": cfg.batch_size, "split": "test",
                          "episode_seed": 99 + rnd},
                         {"num": 1, "split": "val", "episode_seed": 5 + rnd,
                          "temperature": 0.5}]
        payloads = payloads[:requests]
        t0 = time.perf_counter()
        results = []
        for rnd in range(-(-requests // 7)):   # 4 concurrent, 3 in turn
            batch = payloads[7 * rnd:7 * rnd + 7]
            with futures.ThreadPoolExecutor(max_workers=4) as ex:
                results += list(ex.map(lambda p: post(url, p), batch[:4]))
            results += [post(url, p) for p in batch[4:]]
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    routes = route_counts(kernel_counters, persistent, label)

    tokens = sum(check_reply(label, cfg, payload, status, body)
                 for payload, (status, body, _) in zip(payloads, results))
    if launches[counter] == 0:
        raise RuntimeError(f"{label}: {counter} never launched: {launches}")

    # the served support pass through the kernels against the plain route,
    # on one batch of training-split episodes: random weights, the LSTM's
    # support state (absolute), the transformer's prefilled KV cache
    # (relative to its largest entry); trained weights, the routes against
    # the fp32 referee (referee_check, REFEREE_F) and the LSTM's state
    # relative to each layer's largest |h|, |c| (TRAINED_STATE_TOL)
    from fewshot_torch import sampling
    from fewshot_torch.data import episodes as eps
    ep = eps.sample_episode_for_artists(
        [sampling.row_generator(s, 0) for s in range(cfg.batch_size)],
        gen.data, torch.as_tensor(np.resize(corpus.splits["train"],
                                            cfg.batch_size)),
        k=cfg.support_size, q=cfg.query_size)

    def support(c=cfg):     # the cache's K and V whole, or h, c by layer
        layers = support_layers(gen.params, ep, c)
        if c.model == "transformer":
            return [torch.stack([kv[i] for kv in layers]) for i in (0, 1)]
        return [x for hc in layers for x in hc]

    want = support(plain_route(cfg))
    errs = [max_rel(a, b) for a, b in zip(support(), want)]
    if cfg.model == "transformer":
        state_err, tol = max(e[1] for e in errs), KV_TOL
    else:
        state_err, tol = max(e[0] for e in errs), STATE_TOL
    log(f"  {label} support pass vs plain route: max abs "
        f"{max(e[0] for e in errs):.4g}, max rel {max(e[1] for e in errs):.4g}"
        f", largest entry {max(float(w.abs().max()) for w in want):.4g}")
    referee = None
    if not trained:
        if not state_err <= tol:
            raise RuntimeError(f"{label}: support pass off by {state_err}")
    else:
        referee = referee_check(label, cfg, gen.params, ep)
        if cfg.model == "lstm":
            trained_err = max(e[1] for e in errs)
            if not trained_err <= TRAINED_STATE_TOL:
                raise RuntimeError(f"{label}: trained support state off the "
                                   f"plain route by {trained_err} of its "
                                   f"largest entry")

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
           "route_launches": routes, "launches_per_batch": per_batch,
           "support_pass_err_vs_plain": state_err,
           "support_pass_rel_err_vs_plain": max(e[1] for e in errs),
           "support_pass_largest_entry": max(float(w.abs().max())
                                             for w in want),
           "support_pass_referee": referee,
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
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    return kernel_counters


def route_counts(kernel_counters, persistent=(), label="") -> dict:
    """{wrapper: {route: launches}} of the wrappers that have two routes;
    every wrapper named in `persistent` must have launched its persistent
    kernel, and only that."""
    routes = {n: dict(fn.route_launches) for n, fn in kernel_counters.items()
              if hasattr(fn, "route_launches")}
    for n in persistent:
        if routes[n]["step"] or not routes[n]["persistent"]:
            raise RuntimeError(f"{label}: {n} did not run the persistent "
                               f"kernel only: {routes[n]}")
    return routes


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


def eval_phase(label, cfg, params, data, corpus, dev, persistent=()) -> dict:
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
    routes = route_counts(kernel_counters, persistent, label)
    if not np.isfinite(nll):
        raise RuntimeError(f"{label}: val NLL not finite: {nll}")
    return {"nll": nll, "wall_s": wall, "launches": launches,
            "route_launches": routes,
            "batches": EVAL_EPISODES // cfg.batch_size}


def training_phase(label, cfg, corpus, dev, must_rise, evaluate=False,
                   per_step=None, per_eval_batch=None, persistent=(),
                   warmup=TRAIN_WARMUP, calls=TRAIN_CALLS,
                   referee=False) -> dict:
    """The train step at cfg, dispatched steps_per_call steps per call as
    bench.py does: `warmup` warm-up calls, then `calls` timed calls.
    evaluate: also the val NLL before and after training (it must fall; the
    head+CE forward must launch and no backward kernel may) and the unigram
    floor.  per_step / per_eval_batch: {kernel: launches} the counters must
    show exactly; persistent: wrappers that must launch their persistent
    kernel only (in training and evaluation); referee: also the trained
    model's val NLL on the same episodes through the bf16 plain route and
    the fp32 plain route (the referee), recorded beside the kernels'."""
    from fewshot_torch import training
    from fewshot_torch.data import episodes as eps

    data = eps.put_corpus(corpus, dev)
    split = torch.as_tensor(np.asarray(corpus.splits["train"]),
                            dtype=torch.int64, device=dev)
    state = training.init_train_state(cfg, len(corpus.vocab), device=dev)
    eval_persistent = [n for n in persistent if not n.endswith("_bwd")]
    if evaluate:
        val_init = eval_phase(label, cfg, state.params, data, corpus, dev,
                              eval_persistent)
    one_step = training.make_train_step(cfg, data, split)
    step = training.make_multi_step(one_step, cfg.steps_per_call)
    # the first warm-up call runs as its single steps (the same trajectory,
    # make_multi_step's contract) to read the untrained first step's loss
    for i in range(cfg.steps_per_call):
        state, m = one_step(state)
        if i == 0:
            first_step = float(m["loss"])
    losses = [float(m["loss"])]
    for _ in range(warmup - 1):
        state, m = step(state)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    kernel_counters = reset_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        state, m = step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    routes = route_counts(kernel_counters, persistent, label)
    losses.append(float(m["loss"]))
    steps = calls * cfg.steps_per_call
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
           "launches": launches, "route_launches": routes,
           "launches_per_step": {n: v / steps for n, v in launches.items()},
           "grad_rel_err_vs_plain": grad_err, "grad_tol": GRAD_TOL}
    if evaluate:
        from fewshot_torch.models import unigram
        val_end = eval_phase(label, cfg, state.params, data, corpus, dev,
                             eval_persistent)
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
                    "eval_route_launches": val_end["route_launches"],
                    "launches_per_eval_batch": {
                        n: v / val_end["batches"]
                        for n, v in val_end["launches"].items()}})
        if referee:
            plain = plain_route(cfg)
            nlls = {"kernels_bf16": val_end["nll"], "plain_bf16": eval_phase(
                label, plain, state.params, data, corpus, dev)["nll"],
                    "plain_fp32": eval_phase(
                label, dataclasses.replace(plain, compute_dtype="float32"),
                state.params, data, corpus, dev)["nll"]}
            rec["val_nll_referee"] = {
                **nlls, "kernels_minus_fp32": nlls["kernels_bf16"]
                - nlls["plain_fp32"], "plain_minus_fp32": nlls["plain_bf16"]
                - nlls["plain_fp32"]}
    log(f"{label}: {json.dumps(rec)}")
    return rec


def int8_phase(cfg, corpus, dev, layer_pair, layer_step) -> dict:
    """Training A with the int8-gates branch (FEWSHOT_LSTM_GATES_INT8=1,
    which ops/lstm_layer.py reads at import; set here on the module for
    this phase only): 3 calls of cfg.steps_per_call steps (the first as
    single steps), the loss falling, the grads within GRAD_TOL of the plain
    route, the per-layer pair on its persistent kernels at 4 launches a
    step each.  The rule must code the gates of both passes (160 rows x 96
    and x 95 steps)."""
    from fewshot_torch.ops import lstm_layer
    rows = cfg.batch_size * cfg.support_size
    lstm_layer.GATES_INT8 = True
    try:
        coded = {t: lstm_layer.saved_gates_dtype(rows, t, H, torch.bfloat16)
                 for t in (cfg.max_len, cfg.max_len - 1)}
        if set(coded.values()) != {torch.int8}:
            raise RuntimeError(f"training_A_int8: gates not coded: {coded}")
        rec = training_phase("training_A_int8", cfg, corpus, dev, layer_pair,
                             per_step=layer_step, persistent=layer_pair,
                             warmup=1, calls=2)
    finally:
        lstm_layer.GATES_INT8 = False
    rec["gates_dtype"] = "int8"
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


# ---------------------------------------------------------------------------
# the training options of slice 12: dropout, remat, finetune; the harness
# ---------------------------------------------------------------------------

DROPOUT = 0.1
FT_STEPS = 20           # FOMAML steps of the finetune phase
REMAT_SPREAD = 10       # remat vs no remat, for a leaf whose bits differ
                        # between runs without remat: at most this many
                        # times the largest such difference


def dropout_phase(label, cfg, corpus, dev, per_step, persistent=()) -> dict:
    """cfg with dropout DROPOUT on the kernel route: a warm-up call and 2
    timed calls of steps_per_call steps, the loss finite, the kernels
    launched per step exactly as without dropout (per_step), the
    persistent routes only; then the trained weights' val NLL under
    DROPOUT and under 0, which must be the same bits (evaluation draws no
    mask)."""
    from fewshot_torch import training
    from fewshot_torch.data import episodes as eps
    drop = dataclasses.replace(cfg, dropout=DROPOUT)
    data = eps.put_corpus(corpus, dev)
    split = torch.as_tensor(np.asarray(corpus.splits["train"]),
                            dtype=torch.int64, device=dev)
    state = training.init_train_state(drop, len(corpus.vocab), device=dev)
    step = training.make_multi_step(
        training.make_train_step(drop, data, split), drop.steps_per_call)
    state, m = step(state)
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    kernel_counters = reset_counts()
    t0 = time.perf_counter()
    for _ in range(2):
        state, m = step(state)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = 2 * drop.steps_per_call
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    routes = route_counts(kernel_counters, persistent, label)
    nll = {d: eval_phase(label, dataclasses.replace(cfg, dropout=d),
                         state.params, data, corpus, dev)["nll"]
           for d in (DROPOUT, 0.0)}
    rec = {"phase": label, "dropout": DROPOUT, "timed_steps": steps,
           "wall_s": wall, "episodes_per_s": steps * cfg.batch_size / wall,
           "losses_per_call": losses, "launches": launches,
           "route_launches": routes,
           "launches_per_step": {n: v / steps for n, v in launches.items()},
           "val_nll_dropout": nll[DROPOUT], "val_nll_no_dropout": nll[0.0]}
    log(f"{label}: {json.dumps(rec)}")
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{label}: loss not finite: {losses}")
    for n, want in per_step.items():
        if launches[n] != want * steps:
            raise RuntimeError(f"{label}: {n} launched {launches[n]} times "
                               f"in {steps} steps, not {want} per step")
    if nll[DROPOUT] != nll[0.0]:
        raise RuntimeError(f"{label}: evaluation moved with dropout: {nll}")
    return rec


def remat_phase(cfg, corpus, dev) -> dict:
    """Training D with remat=True against remat=False: one episode's grads
    from the same weights, three times without remat and once with, leaf
    by leaf: the same bits as the first run without remat where the other
    two give its bits, else within REMAT_SPREAD times their largest
    difference (of the leaf's largest); one train step of each (after a
    warm-up step), its attention launches (the forward twice under remat:
    the backward recomputes each block) and its peak memory."""
    from fewshot_torch import training
    from fewshot_torch.data import episodes as eps
    from fewshot_torch.models import lm
    data = eps.put_corpus(corpus, dev)
    split = torch.as_tensor(np.asarray(corpus.splits["train"]),
                            dtype=torch.int64, device=dev)
    ep = eps.sample_episode(torch.Generator(device=dev).manual_seed(123),
                            data, split, cfg.batch_size,
                            k=cfg.support_size, q=cfg.query_size)
    params = lm.init_lm(cfg, len(corpus.vocab),
                        torch.Generator().manual_seed(cfg.seed), dev)

    def grads(remat):
        for p in params.parameters():
            p.grad = None
        total, _ = lm.episodic_nll_stats(
            params, ep, dataclasses.replace(cfg, remat=remat))
        total.backward()
        return {k: p.grad.clone() for k, p in params.named_parameters()}

    base, again, remat = grads(False), [grads(False), grads(False)], \
        grads(True)

    def diff(a, b):
        return {k: float((a[k].float() - b[k].float()).abs().max()
                         / a[k].float().abs().max().clamp_min(1e-30))
                for k in a}
    spread = {k: max(diff(base, a)[k] for a in again) for k in base}
    steps = {}
    for flag in (False, True):
        c = dataclasses.replace(cfg, remat=flag)
        state = training.init_train_state(c, len(corpus.vocab), device=dev)
        step = training.make_train_step(c, data, split)
        state, _ = step(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        kernel_counters = reset_counts()
        state, m = step(state)
        torch.cuda.synchronize()
        steps[flag] = {
            "loss": float(m["loss"]),
            "launches": {n: fn.launches for n, fn in kernel_counters.items()},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(
                dev),
            "peak_above_held_bytes": torch.cuda.max_memory_allocated(dev)
            - held, "step_ms": host_ms(lambda: step(state), reps=3)}
    rec = {"phase": "training_D_remat",
           "grads_bits_equal": all(torch.equal(base[k], remat[k])
                                   for k in base),
           "grads_bits_equal_no_remat_thrice": all(
               torch.equal(base[k], a[k]) for a in again for k in base),
           "grads_rel_diff_remat": diff(base, remat),
           "grads_rel_diff_no_remat_thrice": spread,
           "no_remat": steps[False], "remat": steps[True]}
    log(f"training_D_remat: {json.dumps(rec)}")
    fwd = [steps[f]["launches"]["prefix_attn_fwd"] for f in (False, True)]
    bwd = [steps[f]["launches"]["prefix_attn_bwd_dq"] for f in (False, True)]
    held = all(torch.equal(base[k], remat[k]) if spread[k] == 0 else
               rec["grads_rel_diff_remat"][k] <= REMAT_SPREAD * spread[k]
               for k in base)
    if not (np.isfinite([steps[f]["loss"] for f in steps]).all()
            and fwd[1] == 2 * fwd[0] > 0 and bwd[0] == bwd[1] > 0
            and held):
        raise RuntimeError(f"training_D_remat failed its gates: {rec}")
    return rec


def finetune_phase(cfg, corpus, dev, ckpt_dir: Path) -> dict:
    """The finetune variant at full width (cfg: the LSTM cache recipe at
    B=16 with the leg's inner loop, cell='scan': the kernel route is
    refused, as JAX's outer grad fails there): FT_STEPS FOMAML steps (the
    loss and grad norm finite, the last loss below the first step's), one
    eval batch, then the weights saved as a checkpoint, restored (the same
    bits) and served one request batch of B rows.  Nothing of it launches
    a kernel."""
    from fewshot_torch import training
    from fewshot_torch.data import episodes as eps
    from fewshot_torch.models import lm
    from fewshot_torch.serve import Generator
    from fewshot_torch.utils import ckpt
    try:
        lm.check_supported(dataclasses.replace(cfg, cell="pallas"))
        raise RuntimeError("finetune on the kernel route was not refused")
    except ValueError:
        pass
    data = eps.put_corpus(corpus, dev)
    split = {s: torch.as_tensor(np.asarray(corpus.splits[s]),
                                dtype=torch.int64, device=dev)
             for s in ("train", "val")}
    state = training.init_train_state(cfg, len(corpus.vocab), device=dev)
    step = training.make_train_step(cfg, data, split["train"])
    kernel_counters = reset_counts()
    losses, norms = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FT_STEPS):
        state, m = step(state)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    wall = time.perf_counter() - t0
    eval_step = training.make_eval_step(cfg, data, split["val"])
    t0 = time.perf_counter()
    total, count = eval_step(state.params,
                             torch.Generator(device=dev).manual_seed(7))
    nll = float(total) / max(float(count), 1.0)
    eval_s = time.perf_counter() - t0
    busy_ms, top = device_busy_ms(lambda: step(state), top=6)
    vocab_hash = corpus.vocab.content_hash()
    ckpt.save_checkpoint(ckpt_dir, state, vocab_hash,
                         hparams=ckpt.hparams_of(cfg))
    params = ckpt.restore_params(ckpt_dir, dev, vocab_hash,
                                 ckpt.hparams_of(cfg))
    same = all(torch.equal(p, dict(params.named_parameters())[k])
               for k, p in state.params.named_parameters())
    gen = Generator(cfg, corpus, params, batch_size=cfg.batch_size,
                    device=dev)
    try:
        t0 = time.perf_counter()
        outs = gen.generate(num=cfg.batch_size, split="test",
                            episode_seed=99)
        serve_s = time.perf_counter() - t0
    finally:
        gen.close()
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    rec = {"phase": "finetune", "batch": cfg.batch_size,
           "inner_steps": cfg.inner_steps, "inner_lr": cfg.inner_lr,
           "first_order": cfg.first_order, "cell": cfg.cell,
           "steps": FT_STEPS, "wall_s": wall, "step_ms": 1e3 * wall
           / FT_STEPS, "episodes_per_s": FT_STEPS * cfg.batch_size / wall,
           "step_device_busy_ms": busy_ms, "step_device_top_kernels": top,
           "losses": losses, "grad_norms": norms,
           "eval_batch_nll": nll, "eval_batch_s": eval_s,
           "restored_bits_equal": same, "served_rows": len(outs),
           "served_tokens": [o["tokens"] for o in outs],
           "serve_batch_s": serve_s, "launches": launches}
    log(f"finetune: {json.dumps(rec)}")
    if not (np.isfinite(losses + norms + [nll]).all()
            and losses[-1] < losses[0] and same
            and len(outs) == cfg.batch_size
            and all(o["tokens"] > 0 for o in outs)
            and not any(launches.values())):
        raise RuntimeError(f"finetune phase failed its gates: {rec}")
    return rec


def harness_phase(corpus_dir: Path, tmp: Path) -> dict:
    """One short leg of ``python -m fewshot_torch.quality`` (the flagship
    cache recipe, 60 steps, evals every 20 on 32 episodes) in a new
    process, on the V=5000 corpus already built; its JSON must hold the
    leg with its floors, curve, test NLL and card line, the cut recorded
    and so no verdict, and the best-val parameters' NLL on JAX's test
    episodes."""
    root = tmp / "quality"
    (root / "lyrics").mkdir(parents=True)
    (root / "lyrics" / "plain").symlink_to(corpus_dir)
    out, tag = tmp / "quality.json", "plain_cache_full_floor"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fewshot_torch.quality", "--legs", tag,
         "--root", str(root), "--out", str(out), "--max_steps", "60",
         "--eval_every", "20", "--eval_episodes", "32"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"harness: failed:\n{proc.stderr[-3000:]}")
    result = json.loads(out.read_text())
    leg = result[tag]
    rec = {"phase": "harness", "wall_s": wall, "card": result["cards"][tag],
           "verdict": result["verdicts"][tag], "cut": result["cuts"][tag],
           "jax_episodes": result["jax_episodes"][tag],
           **{k: leg[k] for k in ("steps_trained", "best_step", "test_nll",
                                  "unigram_floor_test",
                                  "episodes_per_sec_train_only")},
           "curve": leg["curve"]}
    log(f"harness: {json.dumps(rec)}")
    if not (leg["steps_trained"] == 60
            and [c["step"] for c in leg["curve"]] == [30, 50, 60]
            and np.isfinite([leg["test_nll"], leg["unigram_floor_test"]]
                            ).all() and rec["card"]
            and rec["cut"] == {"max_steps": 60, "eval_every": 20,
                               "eval_episodes": 32}
            and "inside_band" not in rec["verdict"]
            and rec["jax_episodes"]["episodes"] == 512
            and np.isfinite(rec["jax_episodes"]["test_nll"])
            and (root / "best" / f"{tag}.pt").exists()):
        raise RuntimeError(f"harness: bad leg record {rec}")
    return rec


# ---------------------------------------------------------------------------
# the flagship cache recipe through the train CLI, then served
# ---------------------------------------------------------------------------

DATA_YAML = "configs/data/lyrics.yaml"
TASK_YAML = "configs/task/episodic_cache.yaml"
LSTM_YAML = "configs/model/lstm_pallas.yaml"
TFM_YAML = "configs/model/transformer.yaml"
MIXED_TOL = 2e-2        # first decode step's mixed log-probs vs the plain
                        # route (the support pass rounds as STATE_TOL's)
LSE_TOL = 1e-4          # each row's logsumexp of the mixture, about 0


# what a CLI leg's record holds beside its JSON: the config, the trained
# parameters and the parameters each checkpoint was handed, by step
LEG_OBJECTS = ("cfg", "params", "saved")


def cli_args(model_yaml, corpus_dir, ckpt_dir, sets,
             data_yaml=DATA_YAML) -> list:
    return ["train", "--data", data_yaml, "--model", model_yaml,
            "--task", TASK_YAML, "--checkpt_dir", str(ckpt_dir), "--set",
            f"corpus_dir={corpus_dir}", *sets]


def leg_metrics(ckpt_dir: Path) -> tuple[list, list]:
    """(loss records, val_nll records) of metrics.jsonl."""
    recs = [json.loads(x) for x in
            (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    return ([r for r in recs if "loss" in r],
            [r for r in recs if "val_nll" in r])


def cli_leg(label, model_yaml, corpus, corpus_dir, ckpt_dir, sets, steps,
            exact, dev, persistent=(), resume_steps=None,
            data_yaml=DATA_YAML, loss_before=None) -> dict:
    """Train through ``fewshot_torch.cli train`` in this process (so that
    the kernels' counts can be read): `steps` steps from scratch; then, with
    resume_steps, the same command with max_steps=resume_steps in a new
    process (``python -m fewshot_torch.cli``), which must restore the
    checkpoint at `steps` and finish.  exact: {wrapper: launches a step}
    that the run must show exactly (backward kernels; the forwards also
    run in evaluation).  The loss must fall and val NLL be logged every
    eval_interval steps; the parameters that the checkpoint restores are
    bit-identical to those saved at `steps`."""
    from fewshot_torch import cli, training
    from fewshot_torch.config import load_config, parse_overrides
    from fewshot_torch.utils import ckpt
    args = cli_args(model_yaml, corpus_dir, ckpt_dir,
                    [*sets, f"max_steps={steps}"], data_yaml=data_yaml)
    cfg = load_config(data_yaml, model_yaml, TASK_YAML, parse_overrides(
        args[args.index("--set") + 1:]))
    saved = {}
    save = cli.save_checkpoint

    def record(d, state, *a, **k):       # what each save was handed
        saved[int(state.step)] = {n: p.detach().clone() for n, p
                                  in state.params.named_parameters()}
        return save(d, state, *a, **k)
    kernel_counters = reset_counts()
    cli.save_checkpoint = record
    t0 = time.perf_counter()
    try:
        cli.main(args)
        torch.cuda.synchronize()
    finally:
        cli.save_checkpoint = save
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    routes = route_counts(kernel_counters, persistent, label)
    for n, per in exact.items():
        if launches[n] != per * steps:
            raise RuntimeError(f"{label}: {n} launched {launches[n]} times "
                               f"in {steps} steps, not {per} a step")
    for n in ("lstm_stack_fwd", "head_ce_fwd", "prefix_attn_fwd"):
        bwd = n.replace("_fwd", "_bwd") if n != "prefix_attn_fwd" \
            else "prefix_attn_bwd_dq"
        if bwd in exact and launches[n] < exact[bwd] * steps:
            raise RuntimeError(f"{label}: {n} launched {launches[n]} times")
    vocab_hash = corpus.vocab.content_hash()
    init = training.init_train_state(cfg, len(corpus.vocab), device=dev)
    state, restored = ckpt.recover_or_init(ckpt_dir, init, vocab_hash,
                                           ckpt.hparams_of(cfg))
    bits = restored and state.step == steps and all(
        torch.equal(p, saved[steps][n])
        for n, p in state.params.named_parameters())
    if not bits:
        raise RuntimeError(f"{label}: the checkpoint at {steps} does not "
                           f"restore the saved parameters bit for bit")
    rec = {"phase": label, "steps": steps, "wall_s": wall,
           "launches": launches, "route_launches": routes,
           "launches_per_step": {n: launches[n] / steps for n in launches},
           "restored_bit_identical": bits}
    if resume_steps:
        cmd = [sys.executable, "-m", "fewshot_torch.cli",
               *cli_args(model_yaml, corpus_dir, ckpt_dir,
                         [*sets, f"max_steps={resume_steps}"])]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        rec["resume_wall_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: the resumed run failed:\n"
                               f"{proc.stderr[-3000:]}")
        if f"restored checkpoint at step {steps}" not in proc.stdout:
            raise RuntimeError(f"{label}: the resumed run did not restore "
                               f"step {steps}:\n{proc.stdout[-2000:]}")
        state, _ = ckpt.recover_or_init(ckpt_dir, init, vocab_hash)
        if state.step != resume_steps:
            raise RuntimeError(f"{label}: resumed run ended at {state.step}")
    losses, vals = leg_metrics(ckpt_dir)
    last = resume_steps or steps
    want_vals = list(range(cfg.eval_interval, last + 1, cfg.eval_interval))
    if [r["step"] for r in vals] != want_vals or \
            [r["step"] for r in losses][-1] != last:
        raise RuntimeError(f"{label}: logged steps {[r['step'] for r in vals]}"
                           f" (val), {[r['step'] for r in losses][-3:]}")
    # the loss falls from the first one logged, or from the untrained
    # model's (loss_before), where the first log lands on a plateau
    first = losses[0]["loss"] if loss_before is None else loss_before
    final = losses[-1]["loss"]
    if not (np.isfinite(final) and final < first):
        raise RuntimeError(f"{label}: loss did not fall: {first} -> {final}")
    rec.update(cfg=cfg, params=state.params, saved=saved, loss_first=first,
               loss_last=final, val_nll=[(r["step"], r["val_nll"])
                                         for r in vals],
               episodes_per_sec=[r["episodes_per_sec"] for r in losses])
    log(f"{label}: {json.dumps({k: v for k, v in rec.items() if k not in (*LEG_OBJECTS, 'episodes_per_sec')})}")
    return rec


def leg_floor(label, leg, corpus, dev) -> dict:
    """The trained model's val NLL (LEG_EVAL_EPISODES episodes) beside the
    episodic-unigram floor on the same split."""
    from fewshot_torch.data import episodes as eps
    from fewshot_torch.models import unigram
    cfg = leg["cfg"]
    data = eps.put_corpus(corpus, dev)
    ev = eval_phase(label, cfg, leg["params"], data, corpus, dev)
    val = torch.as_tensor(np.asarray(corpus.splits["val"]),
                          dtype=torch.int64, device=dev)
    floor = unigram.evaluate_unigram(
        cfg, corpus, data, val, torch.Generator(device=dev).manual_seed(7),
        num_episodes=EVAL_EPISODES)
    log(f"{label}: final val NLL {ev['nll']:.6f} (unigram floor "
        f"{floor:.6f})")
    return {"val_nll": ev["nll"], "unigram_floor": floor}


def cache_decode_check(label, cfg, params, corpus, dev) -> dict:
    """The served decode loop with the cache head on one batch: the first
    step's mixed log-probs against the plain route (MIXED_TOL absolute),
    every step's rows normalised (logsumexp within LSE_TOL of 0), and each
    row's carried counts those of the non-PAD tokens it emitted."""
    from fewshot_torch import sampling
    from fewshot_torch.data import episodes as eps
    from fewshot_torch.data.vocab import PAD
    b, vocab = cfg.batch_size, len(corpus.vocab)
    data = eps.put_corpus(corpus, dev)
    ep = eps.sample_episode_for_artists(
        [sampling.row_generator(s, 0) for s in range(b)], data,
        torch.as_tensor(np.resize(corpus.splits["train"], b)),
        k=cfg.support_size, q=cfg.query_size)
    sample, count = sampling.filtered_sample, sampling._count_emitted

    def run(c):
        seen, carried = [], []

        def watch_sample(noise, logits, *a, **k):
            seen.append(logits.float())
            return sample(noise, logits, *a, **k)

        def watch_count(c_pre, n_pre, nxt):
            carried[:] = [count(c_pre, n_pre, nxt)]
            return carried[0]
        sampling.filtered_sample, sampling._count_emitted = \
            watch_sample, watch_count
        try:
            toks = sampling.generate(
                params, ep.support, ep.support_len,
                [sampling.row_generator(s, 1, dev) for s in range(b)], c)
        finally:
            sampling.filtered_sample, sampling._count_emitted = sample, count
        return toks, seen, carried
    toks, seen, carried = run(cfg)
    _, plain_seen, _ = run(plain_route(cfg))
    first_err = float((seen[0] - plain_seen[0]).abs().max())
    lse_err = max(float(torch.logsumexp(x, -1).abs().max()) for x in seen)
    emitted = toks != PAD
    counts_ok = True
    if cfg.cache_dynamic:
        c_pre, n_pre = carried[0]
        want = torch.zeros((b, vocab), device=dev).scatter_add_(
            1, toks.clamp(0, vocab - 1), emitted.float())
        counts_ok = (torch.equal(n_pre[:, 0], emitted.sum(1).float())
                     and torch.equal(c_pre, want))
    rec = {"first_step_mixed_err_vs_plain": first_err,
           "max_abs_logsumexp": lse_err, "carried_counts_ok": counts_ok,
           "steps": len(seen)}
    log(f"  {label} cache head: {rec}")
    if not (first_err <= MIXED_TOL and lse_err <= LSE_TOL and counts_ok):
        raise RuntimeError(f"{label}: the cache head's decode is off: {rec}")
    return rec


# ---------------------------------------------------------------------------
# slice 13: the host episode pipeline, the native tier, data parallelism
# over torch.distributed and row-sharded serving
# ---------------------------------------------------------------------------

HOST_STEPS = 30         # train steps a pipeline in the host-pipeline phase
HOST_WARMUP = 3         # untimed steps before them
HOST_WINDOW = 5         # steps in the profiled window
HOST_CLI_STEPS, HOST_CLI_RESUME = 150, 200
NCCL_STEPS = 50         # the NCCL world of one: steps, = the checkpoint step
HOST_EVAL_EVERY = 50    # eval and checkpoint interval of the host CLI legs
PINNED_COPY = "Memcpy HtoD (Pinned -> Device)"


def profiled_window(fn, steps: int) -> dict:
    """Host ms of `steps` calls of fn (ending in a synchronize) under
    torch.profiler, the device busy ms in the window (device-side events
    of key_averages) and its chrome trace events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA) / 1e3
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return {"wall_ms": wall_ms, "busy_ms": busy if busy > 0 else None,
            "events": events}


def copy_streams(events) -> dict:
    """The streams of the pinned host-to-device copies and of the port's
    kernels (LSTM, head+CE) in a chrome trace."""
    def streams(pick):
        return sorted({e.get("args", {}).get("stream") for e in events
                       if pick(e)} - {None})
    return {"pinned_copies": sum(1 for e in events
                                 if e.get("name") == PINNED_COPY),
            "copy_streams": streams(lambda e: e.get("name") == PINNED_COPY),
            "kernel_streams": streams(
                lambda e: e.get("cat") == "kernel"
                and ("lstm" in e.get("name", "")
                     or "head_ce" in e.get("name", "")))}


def host_pipeline_phase(cfg, corpus, dev, per_step, persistent) -> dict:
    """Training C on the host pipeline (make_fed_train_step, one episode
    batch a call) beside the same config on the device sampler:
    HOST_WARMUP untimed steps, then HOST_STEPS timed steps each from the
    same init, the loss falling, the kernels' counts
    per_step exactly (persistent routes only); a profiled window of
    HOST_WINDOW steps each for the device busy time and idle share; on the
    host pipeline the episode copies must be pinned host-to-device copies
    on a stream that none of the port's kernels runs on."""
    from fewshot_torch import training
    from fewshot_torch.data import episodes as eps
    from fewshot_torch.data.host_pipeline import HostEpisodePipeline

    data = eps.put_corpus(corpus, dev)
    split = torch.as_tensor(np.asarray(corpus.splits["train"]),
                            dtype=torch.int64, device=dev)
    rec = {"phase": "host_pipeline_C", "batch": cfg.batch_size,
           "steps": HOST_STEPS, "window_steps": HOST_WINDOW}
    for name in ("device", "host"):
        state = training.init_train_state(cfg, len(corpus.vocab), device=dev)
        pipe = None
        if name == "host":
            pipe = HostEpisodePipeline(corpus, "train", cfg.batch_size,
                                       cfg.support_size, cfg.query_size,
                                       seed=cfg.seed, device=dev)
            fed = training.make_fed_train_step(cfg)

            def step(s):
                return fed(s, next(pipe))
        else:
            step = training.make_train_step(cfg, data, split)
        try:
            for _ in range(HOST_WARMUP):
                state, _ = step(state)
            torch.cuda.synchronize()
            kernel_counters = reset_counts()
            losses = []
            t0 = time.perf_counter()
            for _ in range(HOST_STEPS):
                state, m = step(state)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in kernel_counters.items()}
            routes = route_counts(kernel_counters, persistent,
                                  f"host_pipeline_C/{name}")
            losses = [float(x) for x in losses]

            def one():
                nonlocal state
                state, _ = step(state)
            win = profiled_window(one, HOST_WINDOW)
        finally:
            if pipe is not None:
                pipe.close()
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"host_pipeline_C/{name}: loss not finite "
                               f"and falling: {losses}")
        for n, want in per_step.items():
            if launches[n] != want * HOST_STEPS:
                raise RuntimeError(
                    f"host_pipeline_C/{name}: {n} launched {launches[n]} "
                    f"times in {HOST_STEPS} steps, not {want} a step")
        step_ms = win["wall_ms"] / HOST_WINDOW
        busy = (None if win["busy_ms"] is None
                else win["busy_ms"] / HOST_WINDOW)
        rec[name] = {
            "wall_s": wall, "episodes_per_s": HOST_STEPS * cfg.batch_size
            / wall, "step_ms_loop": wall * 1e3 / HOST_STEPS,
            "step_ms_window": step_ms, "step_device_busy_ms": busy,
            "step_device_idle_share": (None if busy is None
                                       else 1.0 - busy / step_ms),
            "loss_first": losses[0], "loss_last": losses[-1],
            "launches": launches, "route_launches": routes,
            **copy_streams(win["events"])}
    host = rec["host"]
    # the producer runs ahead of the steps, so the window holds the copies
    # issued while it was open: at least one, none on a kernel's stream
    if not host["pinned_copies"] or not host["kernel_streams"] \
            or set(host["copy_streams"]) & set(host["kernel_streams"]):
        raise RuntimeError(f"host_pipeline_C: the episode copies are not "
                           f"pinned copies on a side stream: "
                           f"{ {k: host[k] for k in ('pinned_copies', 'copy_streams', 'kernel_streams')} }")
    log(f"host_pipeline_C: {json.dumps(rec)}")
    return rec


def nccl_world_phase(corpus, corpus_dir, ckpt_dir, sets, want) -> dict:
    """The host-pipeline CLI leg for NCCL_STEPS steps under the FEWSHOT_*
    variables of a world of one (127.0.0.1, a free port): torch.distributed
    initialised with nccl, one all-reduce a train step and one an eval
    (the val pipeline's (ce_sum, count) pair), and the parameters
    of the checkpoint at NCCL_STEPS the same bits as `want` (the same steps
    without the variables)."""
    import os
    import socket
    import torch.distributed as dist
    from fewshot_torch import bridge, cli
    from fewshot_torch.parallel import mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"FEWSHOT_COORDINATOR": f"127.0.0.1:{port}",
           "FEWSHOT_NUM_PROCESSES": "1", "FEWSHOT_PROCESS_ID": "0"}
    os.environ.update(env)
    calls = mesh.all_reduce_sum.calls
    kernel_counters = reset_counts()
    t0 = time.perf_counter()
    try:
        cli.main(cli_args(LSTM_YAML, corpus_dir, ckpt_dir,
                          [*sets, f"max_steps={NCCL_STEPS}"]))
        torch.cuda.synchronize()
        backend = dist.get_backend()
        world = dist.get_world_size()
    finally:
        for k in env:
            os.environ.pop(k)
        if dist.is_initialized():
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    reduces = mesh.all_reduce_sum.calls - calls
    launches = {n: fn.launches for n, fn in kernel_counters.items()}
    got = bridge.load_params(Path(ckpt_dir) / str(NCCL_STEPS) /
                             "params.npz", "cuda")
    same = all(torch.equal(p, want[n])
               for n, p in got.named_parameters())
    rec = {"phase": "nccl_world_of_one", "steps": NCCL_STEPS,
           "evals": NCCL_STEPS // HOST_EVAL_EVERY,
           "backend": backend, "world": world, "all_reduce_calls": reduces,
           "params_same_bits_as_without": same, "wall_s": wall,
           "launches": launches}
    log(f"nccl_world_of_one: {json.dumps(rec)}")
    evals = NCCL_STEPS // HOST_EVAL_EVERY
    if backend != "nccl" or world != 1 or not same or \
            reduces != NCCL_STEPS + evals:
        raise RuntimeError(f"nccl_world_of_one failed its gates: {rec}")
    return rec


def sharded_serving_phase(label, cfg, corpus, params, dev, counter,
                          gate_whole_batch=False) -> dict:
    """Generator(devices=[cuda:0, cuda:0]) at batch 2b (chunks of b rows)
    against Generator(device=cuda) at batch b on the same rows (one
    artist, seeds s..s+2b-1 in one request there and two here), two seeds:
    every continuation the same tokens, and the sharded calls must launch
    `counter`.  The single-device Generator at batch 2b on the same rows is
    recorded beside it (the share of equal continuations): cuBLAS picks
    its GEMMs by row count, so a chunk of b rows and a batch of 2b can
    round differently in bf16; gate_whole_batch requires it equal too."""
    from fewshot_torch.serve import Generator
    b = cfg.batch_size
    one = Generator(cfg, corpus, params, batch_size=b, device=dev)
    whole = Generator(cfg, corpus, params, batch_size=2 * b, device=dev)
    two = Generator(cfg, corpus, params, batch_size=2 * b,
                    devices=[dev, dev])
    artist = corpus.artist_names[int(corpus.splits["train"][0])]

    def rows(reply):
        return [(r["artist"], r["text"]) for r in reply]
    try:
        launches = dict.fromkeys(counters(), 0)
        same, whole_same, n = True, 0, 0
        for seed in (3, 11):
            a = rows(one.generate(num=b, artist=artist, episode_seed=seed)
                     + one.generate(num=b, artist=artist,
                                    episode_seed=seed + b))
            w = rows(whole.generate(num=2 * b, artist=artist,
                                    episode_seed=seed))
            kernel_counters = reset_counts()
            t0 = time.perf_counter()
            got = rows(two.generate(num=2 * b, artist=artist,
                                    episode_seed=seed))
            wall = time.perf_counter() - t0
            for k, fn in kernel_counters.items():
                launches[k] += fn.launches
            same &= got == a
            whole_same += sum(x == y for x, y in zip(got, w))
            n += len(got)
    finally:
        for g in (one, whole, two):
            g.close()
    rec = {"phase": label, "devices": [str(dev)] * 2, "rows": n,
           "batch": two.batch, "chunk_rows": b, "same_tokens": same,
           "whole_batch_equal_share": whole_same / n, "counter": counter,
           "launches": launches, "last_sharded_wall_s": wall}
    log(f"{label}: {json.dumps(rec)}")
    if not same or launches[counter] == 0 or (
            gate_whole_batch and whole_same != n):
        raise RuntimeError(f"{label}: sharded serving failed: {rec}")
    return rec


def native_phase(tmp: Path, build_s: float) -> dict:
    """The native library (built by g++ here in build_s seconds, before
    the corpora), the corpus pass alone (tokenize, count, vocab, encode)
    with native=True and native=False, and a synthetic lyrics corpus (800
    artists x 16 songs, V=5000) packed both ways: the same corpus.npz,
    vocab.json and meta.json bytes."""
    from fewshot_torch.data import lyrics
    from fewshot_torch.data.corpus import build_lyrics_corpus
    from fewshot_torch.data.synthetic import generate_lyrics_csv
    rec = {"phase": "native_tier", "build_s": build_s}
    csv = tmp / "native.csv"
    generate_lyrics_csv(csv, num_artists=800, songs_per_artist=16,
                        extra_vocab=6000, seed=1)
    rows = lyrics.read_lyrics_csv(csv)
    rec["rows"] = len(rows)
    passes = {}
    for on in (True, False):
        t0 = time.perf_counter()
        passes[on] = lyrics.tokenize_corpus(rows, 5000, native=on)
        rec["tokenize_s_native" if on else "tokenize_s_python"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        build_lyrics_corpus(csv, tmp / f"native_{on}", vocab_size=5000,
                            max_len=0, seed=1, native=on)
        rec["prepare_s_native" if on else "prepare_s_python"] = \
            time.perf_counter() - t0
    rec["identical"] = {
        "tokenize_corpus": (passes[True][0].tokens == passes[False][0].tokens
                            and passes[True][1] == passes[False][1]),
        **{name: (tmp / "native_True" / name).read_bytes()
           == (tmp / "native_False" / name).read_bytes()
           for name in ("corpus.npz", "vocab.json", "meta.json")}}
    log(f"native_tier: {json.dumps(rec)}")
    if not all(rec["identical"].values()):
        raise RuntimeError(f"native_tier: the packed files differ: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the MIDI path: the kernels at its shapes, then prepare, train, evaluate,
# sample and serve through the CLI
# ---------------------------------------------------------------------------

MIDI_DATA_YAML = "configs/data/midi.yaml"
MIDI_MODEL_YAML = "configs/model/lstm.yaml"
# scripts/midi_scale.py:36-39, 179-188 (its plain_cache_floor leg): 24
# songs an artist of 60-100 notes (~4 events a note), 300 BPE merges;
# LSTM 512x2 on the per-layer kernels in bf16, B=32, the full cache stack
# with the responsibility floor.  Cut: 60 artists, not 300 (the val and
# test splits keep 6 each), 300 steps (100 on the BPE corpus), not a
# converged run
MIDI_ARTISTS, MIDI_SONGS, MIDI_NOTES, MIDI_MERGES = 60, 24, (60, 100), 300
MIDI_STEPS, BPE_STEPS = 300, 100
MIDI_SETS = ["support_mode=mean_state", "cell=pallas",
             "compute_dtype=bfloat16", "batch_size=32",
             "cache_resp_floor=0.25", "cache_calib_freq=false"]
MIDI_SERVE_BATCH, MIDI_REQUESTS, MIDI_SAMPLES = 16, 8, 8


def cli_run(label, args, timeout=900) -> str:
    """``python -m fewshot_torch.cli <args>`` in a new process; its stdout.
    Fails the run if the command does."""
    proc = subprocess.run(
        [sys.executable, "-m", "fewshot_torch.cli", *map(str, args)],
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: {args[0]} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return proc.stdout


def printed(label, out: str, key: str) -> float:
    """The value of the line ``key=<number> ...`` a command printed."""
    m = re.search(rf"^{re.escape(key)}=(\S+)", out, re.M)
    if m is None or not np.isfinite(float(m.group(1))):
        raise RuntimeError(f"{label}: no finite {key} in:\n{out[-2000:]}")
    return float(m.group(1))


def midi_prepare(raw: Path, tmp: Path) -> dict:
    """The synthetic MIDI files, then the plain and the BPE corpus packed
    from them by ``cli prepare --midi_root`` (two processes at once)."""
    from fewshot_torch.data.corpus import PackedCorpus
    from fewshot_torch.data.synthetic import generate_midi_corpus
    t0 = time.perf_counter()
    generate_midi_corpus(raw, MIDI_ARTISTS, MIDI_SONGS, seed=0,
                         notes_range=MIDI_NOTES)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with futures.ThreadPoolExecutor(2) as ex:
        outs = list(ex.map(lambda a: cli_run("midi prepare", a), [
            ["prepare", "--midi_root", raw, "--out", tmp / "midi",
             "--max_len", 0],
            ["prepare", "--midi_root", raw, "--out", tmp / "midi_bpe",
             "--max_len", 0, "--bpe_merges", MIDI_MERGES]]))
    plain, bpe = (PackedCorpus.load(tmp / "midi"),
                  PackedCorpus.load(tmp / "midi_bpe"))
    rec = {"artists": MIDI_ARTISTS, "songs": MIDI_SONGS,
           "notes": list(MIDI_NOTES), "generate_s": gen_s,
           "pack_both_s": time.perf_counter() - t0,
           "files": sum(1 for _ in raw.rglob("*.mid")),
           "vocab": len(plain.vocab), "max_len": plain.max_len,
           "events": int(plain.song_len.sum()),
           "bpe_vocab": len(bpe.vocab), "bpe_max_len": bpe.max_len,
           "bpe_compression": float(bpe.song_len.sum())
           / float(plain.song_len.sum()),
           "splits": {k: len(v) for k, v in plain.splits.items()},
           "printed": [o.strip() for o in outs]}
    log(f"midi corpora: {json.dumps(rec)}")
    if min(rec["splits"].values()) < 6:
        raise RuntimeError(f"midi corpora: {rec}")
    return {"rec": rec, "plain": plain, "bpe": bpe}


def midi_kernel_phase(dev, t_: int, head_shapes) -> dict:
    """Kernels 1-2 (bf16, H=512) at the MIDI leg's support and query passes
    (160 rows x t_ and t_ - 1 steps: the persistent route) against their
    twins, with cuDNN's call; kernels 3-4 at serving's support pass (80
    rows x t_: at serve batch 16 the fused stack takes mean_state's
    forward-only pass, as in the JAX package); and kernels 5-6 (bf16,
    D=256) at the MIDI heads' (rows, vocab) shapes against theirs, with
    torch.logsumexp: each timed, each bit-identical on a second launch.
    (Neither MIDI head runs the fused kernels: V <= 1024 scores through
    dense logits, as in the JAX package.)"""
    from fewshot_torch.ops import lstm_layer as ll
    gen = torch.Generator().manual_seed(4)
    lim = (6.0 / (5 * H)) ** 0.5
    dtype, rows, records = torch.bfloat16, 160, {}

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def unif(*shape):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * lim).to(dev)
    # kernel 3 alone: serving runs the forward only (kernel 4 is not on the
    # MIDI path)
    from fewshot_torch.ops import lstm_stack
    srows = 5 * MIDI_SERVE_BATCH
    mask = ragged_mask(gen, t_, srows, 1).to(dev)
    sargs = (rand(t_, srows, 4 * H, scale=0.6).to(dtype),
             unif(LAYERS - 1, H, 4 * H).to(dtype),
             unif(LAYERS, H, 4 * H).to(dtype),
             rand(LAYERS, 4 * H, scale=0.1), mask,
             rand(LAYERS, srows, H, scale=0.5),
             rand(LAYERS, srows, H, scale=0.5))
    if not lstm_stack.stack_persistent_route(srows, H, LAYERS, dtype):
        raise RuntimeError(f"kernel 3 at {srows} x {t_}: not on the "
                           f"persistent route")
    fwd = check_kernel(
        "lstm_stack_fwd", lstm_stack.lstm_stack_fwd,
        lstm_stack.lstm_stack_fwd_plain, sargs, FWD_TOL[dtype], False,
        2.0 * float(mask.sum()) * H * 4 * H * (2 * LAYERS - 1), dtype,
        lambda: cudnn_lstm_ms(sargs[2], sargs[3], t_, srows, E, LAYERS,
                              dtype))
    fwd["deterministic"] = same_bits(lambda: lstm_stack.lstm_stack_fwd(
        *sargs))
    if not fwd["deterministic"]:
        raise RuntimeError(f"lstm_stack_fwd at T={t_} is not deterministic")
    records[(f"midi_stack_t{t_}", dtype)] = fwd
    for steps in (t_, t_ - 1):
        mask = ragged_mask(gen, steps, rows, 1).to(dev)
        live = float(mask.sum())
        args = ((torch.randn((steps, rows, 4 * H), generator=gen) * 0.6)
                .to(dev, dtype),
                ((torch.rand((H, 4 * H), generator=gen) * 2 - 1) * lim)
                .to(dev, dtype),
                (torch.randn(4 * H, generator=gen) * 0.1).to(dev), mask,
                (torch.randn((rows, H), generator=gen) * 0.5).to(dev),
                (torch.randn((rows, H), generator=gen) * 0.5).to(dev))
        if not ll.persistent_route(rows, H, dtype):
            raise RuntimeError(f"kernels 1-2 at {rows} x {steps}: not on "
                               f"the persistent route")
        ops = 2.0 * live * H * 4 * H
        fwd = check_kernel(
            "lstm_layer_fwd", ll.lstm_layer_fwd, ll.lstm_layer_fwd_plain,
            args, FWD_TOL[dtype], False, ops, dtype,
            lambda: cudnn_lstm_ms(args[1], args[2], steps, rows, H, 1,
                                  dtype))
        with torch.no_grad():
            _, cs, _, _, gates = ll.lstm_layer_fwd(*args, save_gates=True)
        bargs = (gates, args[1], mask, cs, args[5],
                 torch.randn((steps, rows, H), generator=gen).to(dev, dtype),
                 torch.randn((rows, H), generator=gen).to(dev),
                 torch.randn((rows, H), generator=gen).to(dev))
        bwd = check_kernel(
            "lstm_layer_bwd", ll.lstm_layer_bwd, ll.lstm_layer_bwd_plain,
            bargs, [BWD_TOL[dtype]] * 4, True, ops, dtype,
            lambda: cudnn_lstm_ms(args[1], args[2], steps, rows, H, 1, dtype,
                                  backward=True))
        for rec, fn in ((fwd, lambda: ll.lstm_layer_fwd(*args,
                                                        save_gates=True)),
                        (bwd, lambda: ll.lstm_layer_bwd(*bargs))):
            rec["deterministic"] = same_bits(fn)
            if not rec["deterministic"]:
                raise RuntimeError(f"{rec['name']} at T={steps} is not "
                                   f"deterministic")
        records[(f"midi_layer_t{steps}", dtype)] = fwd
        records[(f"midi_layer_bwd_t{steps}", dtype)] = bwd
    for head_rows, vocab in head_shapes:
        log(f"  head+CE kernels at {head_rows} x {HEAD_D} x {vocab}")
        head_checks(*head_inputs(gen, dev, dtype, head_rows, HEAD_D, vocab),
                    dtype, records, f"midi_head_v{vocab}")
    return records


def midi_outputs(label, out: str) -> dict:
    """The ``.mid`` files ``cli sample`` wrote, each parsed back by the
    port's SMF reader: {path: notes}.  Fails if one does not parse or none
    holds a note."""
    from fewshot_torch.data.midi import parse_midi
    paths = re.findall(r"^wrote (\S+\.mid)$", out, re.M)
    notes = {}
    for p in paths:
        try:
            notes[Path(p).name] = len(parse_midi(p))
        except Exception as e:                            # noqa: BLE001
            raise RuntimeError(f"{label}: {p} does not parse: {e}")
    if not paths or not sum(notes.values()):
        raise RuntimeError(f"{label}: no notes in {notes}:\n{out[-2000:]}")
    return notes


def midi_leg(label, corpus, corpus_dir: Path, tmp: Path, sets, steps, dev,
             samples: int, serve: bool) -> dict:
    """Train through the CLI (kernels 1-2 on their persistent route only, 4
    backward launches a step; the loss below the untrained model's val NLL)
    while ``make-eval-set`` freezes a val episode set, then, three processes
    at once, evaluate the checkpoint on that set and on random val episodes
    (per artist), the unigram floor, and sample `samples` ``.mid`` files,
    parsed back; with serve, serve the checkpoint under the grammar
    masks."""
    from fewshot_torch import training
    from fewshot_torch.config import load_config, parse_overrides
    from fewshot_torch.data import episodes as eps
    layer_pair = ("lstm_layer_fwd", "lstm_layer_bwd")
    ck = tmp / f"ck_{label}"
    sets = [*sets, f"max_len={corpus.max_len}",
            f"vocab_size={len(corpus.vocab)}"]
    cfg = load_config(MIDI_DATA_YAML, MIDI_MODEL_YAML, TASK_YAML,
                      parse_overrides([f"corpus_dir={corpus_dir}", *sets]))
    untrained = eval_phase(label, cfg, training.init_train_state(
        cfg, len(corpus.vocab), device=dev).params,
        eps.put_corpus(corpus, dev), corpus, dev)["nll"]
    eval_set = tmp / f"{label}_val.npz"

    def cmd(command, *extra):
        return [command, "--data", MIDI_DATA_YAML, "--model",
                MIDI_MODEL_YAML, "--task", TASK_YAML, "--checkpt_dir", ck,
                *extra, "--set", f"corpus_dir={corpus_dir}", *sets]
    with futures.ThreadPoolExecutor(3) as ex:
        frozen = ex.submit(cli_run, label, [
            "make-eval-set", "--corpus", corpus_dir, "--split", "val",
            "--episodes", EVAL_EPISODES // 2, "--k", 5, "--q", 5, "--out",
            eval_set])
        leg = cli_leg(label, MIDI_MODEL_YAML, corpus, corpus_dir, ck, sets,
                      steps, exact={"lstm_layer_bwd": 2 * LAYERS}, dev=dev,
                      persistent=layer_pair, data_yaml=MIDI_DATA_YAML,
                      loss_before=untrained)
        frozen.result()
        t0 = time.perf_counter()
        out, floor_out, sample_out = [f.result() for f in [ex.submit(
            cli_run, label, c) for c in (
            cmd("evaluate", "--split", "val", "--eval_set", eval_set,
                "--also_split_eval", "--per_artist"),
            cmd("evaluate", "--split", "val", "--baseline", "unigram"),
            cmd("sample", "--split", "val", "--num", samples, "--out",
                tmp / f"{label}_mid"))]]
    artists = re.findall(r"^  artist (\S+): nll=(\S+)$", out, re.M)
    rec = {"val_nll_untrained": untrained,
           "eval_set_nll": printed(label, out, "eval_set_nll_per_token"),
           "val_nll_random_episodes": printed(label, out,
                                              "val_nll_per_token"),
           "val_unigram_floor": printed(label, floor_out,
                                        "val_nll_per_token"),
           "per_artist_nll": {a: float(v) for a, v in artists},
           "samples_notes": midi_outputs(label, sample_out),
           "evaluate_sample_wall_s": time.perf_counter() - t0}
    if corpus.merges:
        rec["eval_set_nll_per_base_token"] = printed(
            label, out, "eval_set_nll_per_base_token")
        rec["val_nll_per_base_token"] = printed(label, out,
                                                "val_nll_per_base_token")
    if len(artists) != len(corpus.splits["val"]) or \
            not rec["val_nll_random_episodes"] < untrained:
        raise RuntimeError(f"{label}: evaluate: {rec}")
    log(f"{label} evaluate / sample: {json.dumps(rec)}")
    leg.update(rec)
    if serve:
        from fewshot_torch.ops import lstm_stack
        cfg = dataclasses.replace(leg["cfg"], batch_size=MIDI_SERVE_BATCH)
        # the served support pass is forward only: at this batch's rows
        # the fused stack takes it (kernel 3), as in the JAX package
        counter = "lstm_stack_fwd" if lstm_stack.stack_fused_supported(
            leg["params"].lstm, torch.bfloat16,
            batch_rows=cfg.batch_size * cfg.support_size,
            eval_mode=True) else "lstm_layer_fwd"
        srv = serving_phase(f"serving_{label}", cfg, corpus, dev, counter,
                            persistent=(counter,), params=leg["params"],
                            requests=MIDI_REQUESTS)
        srv["cache_head"] = cache_decode_check(f"serving_{label}", cfg,
                                               leg["params"], corpus, dev)
        leg["serving"] = srv
    return leg


# the kernels whose bf16 route runs on tensor cores, by wrapper: (library,
# the CUDA kernel's name in it)
TENSOR_CORE = {"lstm_layer_fwd": ("lstm_fwd", "lstm_fwd_persist_kernel"),
               "lstm_layer_bwd": ("lstm_bwd", "lstm_bwd_persist_kernel"),
               "lstm_stack_fwd": ("lstm_fwd",
                                  "lstm_fwd_stack_persist_kernel"),
               "lstm_stack_bwd": ("lstm_bwd",
                                  "lstm_bwd_stack_persist_kernel"),
               "head_ce_fwd": ("head_ce", "head_ce_fwd_tc"),
               "head_ce_bwd": ("head_ce", "head_ce_bwd_tc"),
               "prefix_attn_fwd": ("prefix_attn", "fwd_tc_kernel"),
               "prefix_attn_bwd_dq": ("prefix_attn", "dq_tc_kernel"),
               "prefix_attn_bwd_dkv": ("prefix_attn", "dkv_tc_kernel")}


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


def ptxas_report(build_log: str) -> dict:
    """{entry function: [registers, spill store bytes, spill load bytes]}
    from nvcc's -Xptxas=-v output."""
    import re
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return out


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
        # [registers, spill stores, spill loads] of each instantiation
        regs = {fn: v for fn, v in ptxas_report(
            _ext.build_log.get(lib, "")).items() if kernel in fn}
        log(f"  ptxas {kernel}: {sorted(v for v in regs.values()) or 'not read'}")
        if any(v[1] or v[2] for v in regs.values()):
            raise RuntimeError(f"{kernel} spills registers: {regs}")
    # every other instance too: the SIMT step kernels of 1-4 and the v1
    # attention kernels, fp32 and (heads past 128) bf16
    for lib in _ext.SIGNATURES:
        spills = {fn: v for fn, v in ptxas_report(
            _ext.build_log.get(lib, "")).items() if v[1] or v[2]}
        if spills:
            raise RuntimeError(f"{lib}: kernels spill registers: {spills}")
    return hmma


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from fewshot_torch.config import Config
    from fewshot_torch.models import lm as lm_mod
    from fewshot_torch.quality import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    if card is None:
        raise RuntimeError("nvidia-smi did not report the card")
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    if "--lstm-split" in sys.argv[1:]:
        print(json.dumps({"card": card, "lstm_launch_split":
                          lstm_launch_split(dev)}), flush=True)
        return 0
    hmma = build_all()
    from fewshot_torch.data import native
    t0 = time.perf_counter()
    native.load()                       # g++, before the corpora use it
    native_build_s = time.perf_counter() - t0
    log(f"native data tier built by g++ in {native_build_s:.2f} s")

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
    layer_pair = ("lstm_layer_fwd", "lstm_layer_bwd")
    layer_step = {"lstm_layer_fwd": 2 * LAYERS, "lstm_layer_bwd": 2 * LAYERS}
    serve_a = serving_phase("serving_A", bench, corpus, dev, "lstm_layer_fwd",
                            persistent=("lstm_layer_fwd",))
    serve_b = serving_phase("serving_B", shipped, corpus, dev,
                            "lstm_stack_fwd", persistent=("lstm_stack_fwd",))
    # the support and query passes run each layer's kernel pair once a step
    train_a = training_phase(
        "training_A", dataclasses.replace(bench, steps_per_call=10), corpus,
        dev, layer_pair, per_step=layer_step, persistent=layer_pair)
    train_a8 = int8_phase(dataclasses.replace(bench, steps_per_call=10),
                          corpus, dev, layer_pair, layer_step)
    stack_pair = ("lstm_stack_fwd", "lstm_stack_bwd")
    train_b = training_phase(
        "training_B", dataclasses.replace(shipped, steps_per_call=10),
        corpus, dev, stack_pair, per_step=dict.fromkeys(stack_pair, 2),
        persistent=stack_pair)

    # the V=5000 path, after the bench-corpus phases: its 100,000-song
    # corpus build and the head+CE phase do not precede their host timings
    # the V=5000 corpus stays on disk for the train CLI's legs below
    scale_tmp = tempfile.TemporaryDirectory()
    tmp = Path(scale_tmp.name)
    t0 = time.perf_counter()
    scale = scale_corpus(tmp)
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
        "training_C", cache, scale, dev, layer_pair + ("head_ce_fwd",
                                                       "head_ce_bwd"),
        evaluate=True,
        per_step={**layer_step, "head_ce_fwd": 1, "head_ce_bwd": 1},
        per_eval_batch={"lstm_layer_fwd": 2 * LAYERS, "head_ce_fwd": 1},
        persistent=layer_pair)

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
        per_eval_batch={"prefix_attn_fwd": 2 * LAYERS - 1, "head_ce_fwd": 1},
        referee=True)
    # configs/model/transformer.yaml + configs/task/episodic.yaml
    serve_c_cfg = dataclasses.replace(shipped, model="transformer",
                                      num_layers=4, num_heads=2)
    serve_c = serving_phase("serving_C", serve_c_cfg, corpus, dev,
                            "prefix_attn_fwd")
    flash = flash_phase(dev)

    # the training options of slice 12: dropout on A and C (the kernel
    # route), remat on D, finetune at full width on the V=5000 corpus
    # (scripts/scale_quality.py's plain_ft_cache_full: B=16, 2 inner steps
    # at lr 0.05, cell=scan), and one short leg of the quality harness
    drop_a = dropout_phase(
        "training_A_dropout", dataclasses.replace(bench, steps_per_call=10),
        corpus, dev, layer_step, persistent=layer_pair)
    drop_c = dropout_phase(
        "training_C_dropout", cache, scale, dev,
        {**layer_step, "head_ce_fwd": 1, "head_ce_bwd": 1},
        persistent=layer_pair)
    remat_d = remat_phase(tfm_d, scale, dev)
    finetune = finetune_phase(
        dataclasses.replace(cache, support_mode="finetune", cell="scan",
                            batch_size=16, inner_steps=2, inner_lr=0.05,
                            cache_resp_floor=0.0), scale, dev, tmp / "ck_ft")
    harness = harness_phase(tmp / "scale_lyrics", tmp)

    # the width repairs: kernels 1-2 past their former limits, kernels 7-9
    # at head widths 24, 192, 256 (E = 2 hd) at the query stream's shape
    log("kernels 1-2 at wide hidden sizes (step route, train mode):")
    records.update(wide_lstm_phase(dev))
    for hd in WIDE_HD:
        log(f"prefix-attention kernels at hd = {hd}:")
        records.update(attn_kernel_phase(
            dev, {f"hd{hd}": attn_shapes["query"]}, hd=hd, seed=hd))

    # the flagship cache recipe (configs/task/episodic_cache.yaml) through
    # the train CLI: the shipped LSTM 500 steps, then resumed in a new
    # process to 1000 (cut from the recipe's 2000 to make room for the MIDI
    # path in the script's time); the shipped transformer 200 steps
    # (cell=pallas, as scripts/scale_quality.py:58 sets for every leg);
    # each served from its checkpoint with the dynamic cache head
    corpus_dir = tmp / "scale_lyrics"
    sets = [f"max_len={scale.max_len}"]
    lstm_leg = cli_leg(
        "cli_lstm_leg", LSTM_YAML, scale, corpus_dir, tmp / "ck_lstm", sets,
        500, exact={"lstm_stack_bwd": 2, "head_ce_bwd": 1}, dev=dev,
        persistent=stack_pair, resume_steps=1000)
    lstm_leg.update(leg_floor("cli_lstm_leg", lstm_leg, scale, dev))
    serve_lstm = serving_phase(
        "serving_cli_lstm", lstm_leg["cfg"], scale, dev, "lstm_stack_fwd",
        persistent=("lstm_stack_fwd",), params=lstm_leg["params"],
        requests=14)
    serve_lstm["cache_head"] = cache_decode_check(
        "serving_cli_lstm", lstm_leg["cfg"], lstm_leg["params"], scale, dev)
    tfm_layers = 4                  # configs/model/transformer.yaml
    tfm_leg = cli_leg(
        "cli_transformer_leg", TFM_YAML, scale, corpus_dir, tmp / "ck_tfm",
        sets + ["cell=pallas"], 200,
        exact={"prefix_attn_bwd_dq": 2 * tfm_layers - 1,
               "prefix_attn_bwd_dkv": 2 * tfm_layers - 1, "head_ce_bwd": 1},
        dev=dev)
    tfm_leg.update(leg_floor("cli_transformer_leg", tfm_leg, scale, dev))
    serve_tfm = serving_phase(
        "serving_cli_transformer", tfm_leg["cfg"], scale, dev,
        "prefix_attn_fwd", params=tfm_leg["params"], requests=14)
    serve_tfm["cache_head"] = cache_decode_check(
        "serving_cli_transformer", tfm_leg["cfg"], tfm_leg["params"], scale,
        dev)

    # slice 13: training C on the host pipeline beside the device sampler;
    # pipeline: host through the CLI on the flagship recipe (checkpoints
    # every 50 steps, resumed in a new process); the same leg as an NCCL
    # world of one, which must end on the same bits at step 50; rows
    # sharded over [cuda:0, cuda:0] in serving; the native data tier
    host_c = host_pipeline_phase(
        cache, scale, dev, {**layer_step, "head_ce_fwd": 1, "head_ce_bwd": 1},
        layer_pair)
    host_sets = sets + ["pipeline=host", f"eval_interval={HOST_EVAL_EVERY}",
                        f"checkpoint_interval={HOST_EVAL_EVERY}"]
    host_leg = cli_leg(
        "cli_host_pipeline_leg", LSTM_YAML, scale, corpus_dir,
        tmp / "ck_host", host_sets, HOST_CLI_STEPS,
        exact={"lstm_stack_bwd": 2, "head_ce_bwd": 1}, dev=dev,
        persistent=stack_pair, resume_steps=HOST_CLI_RESUME)
    nccl = nccl_world_phase(scale, corpus_dir, tmp / "ck_nccl", host_sets,
                            host_leg["saved"][NCCL_STEPS])
    sharded = {
        "lstm": sharded_serving_phase(
            "sharded_serving_lstm", host_leg["cfg"], scale,
            host_leg["params"], dev, "lstm_stack_fwd",
            gate_whole_batch=True),
        "transformer": sharded_serving_phase(
            "sharded_serving_transformer", serve_c_cfg, corpus,
            lm_mod.init_lm(serve_c_cfg, len(corpus.vocab),
                           torch.Generator().manual_seed(serve_c_cfg.seed),
                           dev), dev, "prefix_attn_fwd")}
    native_rec = native_phase(tmp, native_build_s)
    scale_tmp.cleanup()
    legs = {}
    for name, leg, srv in (("lstm", lstm_leg, serve_lstm),
                           ("transformer", tfm_leg, serve_tfm)):
        legs[name] = {
            **{k: v for k, v in leg.items() if k not in LEG_OBJECTS},
            "serving": {k: srv[k] for k in (
                "requests", "p50_latency_s", "max_latency_s",
                "tokens_per_s", "generated_tokens", "batch_generate_ms",
                "batch_device_busy_ms", "batch_device_idle_share",
                "launches", "cache_head")}}
        log(f"leg {name}: {json.dumps(legs[name])}")
    legs["host_pipeline"] = {k: v for k, v in host_leg.items()
                             if k not in LEG_OBJECTS}
    log(f"slice 13: {json.dumps({'native_tier': native_rec, 'nccl_world_of_one': {k: v for k, v in nccl.items() if k != 'launches'}, 'sharded_serving': {k: v['same_tokens'] for k, v in sharded.items()}})}")

    # the MIDI path (scripts/midi_scale.py's plain_cache_floor leg, cut to
    # 60 artists and 300 steps): the corpora through cli prepare, the
    # kernels at its shapes, then the plain-event leg (trained, evaluated,
    # sampled, served under the grammar masks) and the BPE leg (trained,
    # evaluated per base token, sampled and expanded)
    with tempfile.TemporaryDirectory() as midi_tmp:
        tmp = Path(midi_tmp)
        corpora = midi_prepare(tmp / "midi_raw", tmp)
        midi, bpe = corpora["plain"], corpora["bpe"]
        heads = [(32 * 5 * (c.max_len - 1), len(c.vocab)) for c in (midi,
                                                                   bpe)]
        log(f"MIDI shapes: kernels 1-2 at 160 x {midi.max_len} and x "
            f"{midi.max_len - 1}; kernels 5-6 at {heads} (x {HEAD_D})")
        records.update(midi_kernel_phase(dev, midi.max_len, heads))
        midi_legs = {
            "midi": midi_leg("cli_midi_leg", midi, tmp / "midi", tmp,
                             MIDI_SETS, MIDI_STEPS, dev, MIDI_SAMPLES,
                             serve=True),
            "midi_bpe": midi_leg("cli_midi_bpe_leg", bpe, tmp / "midi_bpe",
                                 tmp, MIDI_SETS, BPE_STEPS, dev, 4,
                                 serve=False)}
    for name, leg in midi_legs.items():
        srv = leg.pop("serving", None)
        legs[name] = {k: v for k, v in leg.items()
                      if k not in LEG_OBJECTS}
        if srv is not None:
            legs[name]["serving"] = {k: srv[k] for k in (
                "requests", "p50_latency_s", "max_latency_s", "tokens_per_s",
                "generated_tokens", "batch_generate_ms",
                "batch_device_busy_ms", "batch_device_idle_share",
                "launches", "launches_per_batch", "support_pass_referee",
                "support_pass_rel_err_vs_plain", "cache_head")}
        log(f"leg {name}: {json.dumps(legs[name])}")
    legs["midi"]["corpora"] = corpora["rec"]

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
            rec["bf16_kernel"] = TENSOR_CORE[name][1]
            rec["sass_hmma"] = hmma[name]
        if "deterministic" in r:
            rec["deterministic"] = r["deterministic"] and f["deterministic"]
        if key.startswith("head_"):      # kernels 5-6 at the wide widths
            rec["wide_head"] = {
                f"D={d}": {dt: {k: records[(f"head_d{d}_{key[5:]}", x)][k]
                                for k in ("shape", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms",
                                          "library_ms", "deterministic")}
                           for dt, x in (("bfloat16", torch.bfloat16),
                                         ("float32", torch.float32))}
                for d in WIDE_HEAD_D}
        if "split" in r:                 # kernel 5's vocab split
            rec["split"] = r["split"]
        if "library_runs" in r:
            rec["library_runs"] = r["library_runs"]
            rec["library_busy_ms"] = r["library_busy_ms"]
            rec["library_busy_runs"] = r["library_busy_runs"]
        if (key + "_v1", torch.bfloat16) in records:   # kernels 1-2
            v1 = records[(key + "_v1", torch.bfloat16)]
            coded = records[(key + "_int8", torch.bfloat16)]
            lead = records[("layer", torch.bfloat16)]
            rec.update({
                "bf16_kernel": r["route"], "fp32_kernel": f["route"],
                "route_launches": phase["route_launches"][name],
                "v1_step_kernels": {k: v1[k] for k in (
                    "ms", "max_abs_err", "plain_ms")},
                "int8_gates": {k: coded[k] for k in (
                    "ms", "max_abs_err", "errors", "bound_ms", "bound_by")},
                "training_A_int8": {
                    "launches": train_a8["launches"][name],
                    "route_launches": train_a8["route_launches"][name]},
                "max_active_clusters": lead["max_active_clusters"]})
            rec.update({k: v for k, v in lead.items()
                        if k.endswith("deterministic") or k.startswith(
                            "state_same")})
        if key.startswith("stack") and r["route"] == "persistent":
            q = records[(key + "_query", torch.bfloat16)]
            rec.update({
                "bf16_kernel": r["route"], "fp32_kernel": f["route"],
                "route_launches": phase["route_launches"][name],
                "v1_step_kernels": {k: r["v1"][k] for k in (
                    "ms", "max_abs_err", "plain_ms")},
                "tiles_per_launch": r["tiles_per_launch"],
                "launches_per_call": r["launches_per_call"],
                "library_busy_ms": r["library_busy_ms"],
                "query_pass": {
                    **{k: q[k] for k in (
                        "shape", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms",
                        "library_busy_ms", "tiles_per_launch",
                        "launches_per_call")},
                    "v1_step_kernels_ms": q["v1"]["ms"]}})
            rec.update({k: v and q[k] for k, v in r.items()
                        if k.endswith("deterministic")})
            rec["oversize_launch_refused"] = q["oversize_launch_refused"]
        if name in ("lstm_layer_fwd", "lstm_layer_bwd"):
            suffix = "" if name.endswith("fwd") else "_bwd"
            rec["wide_hidden"] = wide_records(
                records, [f"layer_h{h}{suffix}" for _, h in WIDE_LSTM])
        if name.startswith("prefix_attn"):
            rec["head_widths"] = wide_records(
                records, [f"{key.split('_')[0]}_{key.split('_')[1]}_hd{hd}"
                          for hd in WIDE_HD])
        rec["launches_cli_legs"] = {
            leg: legs[leg]["launches"][name] for leg in legs}
        rec["launches_slice12"] = {     # per train step; finetune: total
            "training_A_dropout": drop_a["launches_per_step"][name],
            "training_C_dropout": drop_c["launches_per_step"][name],
            "training_D_no_remat": remat_d["no_remat"]["launches"][name],
            "training_D_remat": remat_d["remat"]["launches"][name],
            "finetune_phase": finetune["launches"][name]}
        rec["launches_slice13"] = {     # per phase, in total
            "host_pipeline_C": host_c["host"]["launches"][name],
            "device_pipeline_C": host_c["device"]["launches"][name],
            "nccl_world_of_one": nccl["launches"][name],
            "sharded_serving_lstm": sharded["lstm"]["launches"][name],
            "sharded_serving_transformer":
                sharded["transformer"]["launches"][name]}
        midi_keys = ([f"midi_layer{key[5:]}_t{t}" for t in (
            midi.max_len, midi.max_len - 1)] if key.startswith("layer")
            else [f"midi_stack_t{midi.max_len}"] if key == "stack"
            else [f"midi_head_v{v}_{key[5:]}" for v in (len(midi.vocab),
                                                        len(bpe.vocab))]
            if key.startswith("head_") else [])
        if midi_keys:        # kernels 1-3 and 5-6 at the MIDI shapes
            rec["midi_shapes"] = {
                k: {f: records[(k, torch.bfloat16)][f] for f in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "deterministic")
                    if f in records[(k, torch.bfloat16)]}
                for k in midi_keys}
        rec["launches_per_step_midi_legs"] = {
            leg: legs[leg]["launches_per_step"][name]
            for leg in ("midi", "midi_bpe")}
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
                               "library_fwd_bwd_ms", "deterministic")
                     if k in records[(key.replace("_query", "_prefix"), d)]}
                for dt, d in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32))}
        kernels.append(rec)
    kernels[-3]["flash_route"] = flash
    log(f"harness leg: {json.dumps(harness)}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
