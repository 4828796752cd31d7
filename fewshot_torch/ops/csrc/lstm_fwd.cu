// Forward LSTM recurrence kernels for Hopper (sm_90a), plain C interface.
//
// Replace the two TPU forward kernels of the JAX package:
//   * fewshot/ops/lstm_pallas.py `_fwd_kernel`  -> lstm_fwd_persist (bf16,
//     H = 128..512 in steps of 128: one launch a call) and lstm_fwd_layer
//     (fp32, and bf16 past that width: one launch per time step)
//   * fewshot/ops/lstm_fused.py  `_fwd_kernel`  -> lstm_fwd_stack_persist
//     (bf16, H = 128..512, L >= 2 within kStackMaxBlocks: one cooperative
//     launch of a layer wavefront) and lstm_fwd_stack (fp32 and every other
//     stack: one launch per layer and time step; layers >= 1 project their
//     input here)
//
// Per time step and layer they compute
//   z = zx[t] (layer 0) or x_t . Wx (layers >= 1)  +  h_{t-1} . Wh  +  b
// in fp32, apply the TF gates (i, j, f, o) with the +1 forget bias and the
// masked carry (a PAD step holds h and c), and write the fp32 state and the
// ys/cs streams.  In train mode (a non-null `gates`) they also write the gate
// activations (sigmoid i, tanh j, sigmoid(f + 1), sigmoid o) of every step,
// PAD steps included: the backward kernels (lstm_bwd.cu) read them instead
// of recomputing z.  The gates are stored in the stream dtype, or (the
// per-layer kernels, gates code 1: lstm_pallas.py's FEWSHOT_LSTM_GATES_INT8
// branch) affine-coded to int8, q = round(127 g') with round-half-even and
// g' = 2 s - 1 for the sigmoids, tanh j as it is.  Serving passes null and
// writes nothing more.  The product operands are rounded to the weight
// dtype first (bf16 or fp32) and the products are summed in fp32, as the
// TPU kernels do with preferred_element_type=float32.
//
// The step kernels (lstm_step_kernel).  An SM cannot hold Wh (2 MB at
// H=512 bf16), so a block owns a tile of ROWS batch rows and UNITS hidden
// units and computes all four gate columns of those units, which keeps the
// cell update local to the block.  Blocks of one step share nothing, so a
// step is one launch: the launch boundary is the grid-wide barrier between
// steps.  h ping-pongs between two fp32 buffers in device memory; c is
// updated in place (only its owning thread reads it).  A block walks the
// contraction in chunks (128 or 512 rows) through a two-slot cp.async
// ring (the next chunk's h rows and weight columns load while this one
// multiplies), so its shared memory does not grow with H and any H % 32 ==
// 0 runs; each thread sums its products in fp32 FMA.  Small batches (the
// state-mode support pass has 16 rows) use narrow unit tiles and split the
// contraction over KSPLIT thread groups.  The per-step L2 reads of Wh and
// the SIMT products bound it (~35 us a step at 160 rows, H=512, ~1 us of
// it the launch).
//
// The persistent kernel (lstm_fwd_persist_kernel, lstm_cluster.cuh).  Batch
// rows never interact, only the hidden units of one row do, so a row tile
// of 32 rows runs on one thread-block cluster of NB = H / 32 blocks for all
// T steps.  Block j keeps Wh[:, C_j] (its 32 units' 128 gate columns)
// resident in shared memory and the fp32 h and c of its units in
// registers.  Step t: z[rows, C_j] = zx + bf16(h_{t-1}) . Wh[:, C_j] + b on
// mma.sync m16n8k16 (8 warps: 4 unit octets x 2 halves of the contraction),
// the gates and the masked carry in the accumulators' own threads, then
// bf16(h_t)[rows, U_j] is all-gathered through L2 and a cluster barrier
// takes the place of the launch boundary (one a step).  Per-step latency
// bounds it: the barrier, the 32 KB read back into every SM, the products
// and the gates, one after the other, every step.
//
// The persistent stack (lstm_fwd_stack_persist_kernel).  A block cannot
// hold two [H, 128] weight slices at H = 512, and a cluster has at most 16
// blocks, so layer l >= 1 cannot run on one cluster: the stack runs as a
// wavefront of 2L - 1 clusters per row tile.  Recurrence stage l is the
// persistent body above with Wh_l resident; projection stage l >= 1 holds
// Wx_l[:, C_j] and turns layer l-1's bf16 ys stream into x . Wx for layer
// l, through a ring in L2.  The stages hand off through step flags
// (release / acquire at .gpu scope); the launch is cooperative, so all
// clusters are resident or the launch is refused.  In steady state a step
// costs the slowest stage's step, not L of them: the same chain as the
// per-layer kernel, now with the wait for the ring between the h exchange
// and the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "lstm_cluster.cuh"

namespace {

constexpr int kPad = 4;             // floats of padding per staged h row
constexpr int kStages = 2;          // chunks in flight
// shared memory a block may use
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the weight dtype W, returned as fp32
template <typename W>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<W>(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A saved gate activation in the gates dtype G: the stream dtype holds the
// activation, int8 its affine code round(127 g'), g' = 2 act - 1 for a
// sigmoid, act for tanh j (round half to even, as jnp.round).
template <typename G>
__device__ __forceinline__ G gate_out(float act, bool sig) {
  return from_float<G>(act);
}
template <>
__device__ __forceinline__ int8_t gate_out<int8_t>(float act, bool sig) {
  return static_cast<int8_t>(
      __float2int_rn((sig ? 2.0f * act - 1.0f : act) * 127.0f));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// Tile shape of a block: ROWS rows x UNITS hidden units (4 * UNITS gate
// columns), the contraction split over KSPLIT thread groups.  Each thread
// owns one unit, two rows (rp and rp + ROWS / 2) and one contraction slice
// of every chunk.  A ring slot holds one chunk: kChunk contraction rows of
// the [ROWS, H] fp32 operand (pitched) and of the block's [H, 4 * UNITS]
// weight columns, so shared memory does not grow with H.  Narrow tiles run
// one block an SM (H / 4 of them at H <= 512), so they take 512-row chunks
// and stage H <= 512 at once; wide tiles take 128 rows, which lets three
// blocks share an SM.
template <int ROWS, int UNITS, int KSPLIT>
struct Tile {
  static constexpr int kThreads = (ROWS / 2) * UNITS * KSPLIT;
  static constexpr int kChunk = ROWS <= 16 ? 512 : 128;
  static constexpr int kAPitch = kChunk + kPad;  // floats per staged row
  __host__ __device__ static constexpr size_t a_bytes() {
    return (size_t)ROWS * kAPitch * sizeof(float);
  }
  template <typename W>
  __host__ __device__ static constexpr size_t slot_bytes() {
    return a_bytes() + (size_t)kChunk * 4 * UNITS * sizeof(W);
  }
  template <typename W>
  static constexpr size_t smem_bytes() {
    const size_t ring = kStages * slot_bytes<W>();
    const size_t reduce = (size_t)KSPLIT * ROWS * UNITS * 4 * sizeof(float);
    return ring > reduce ? ring : reduce;
  }
};

// Stage contraction rows [k0, k0 + kc) of a [rows, H] fp32 operand block
// (rows past `rows` zero-filled) and of the block's [H, 4 * UNITS] weight
// columns into one ring slot, by cp.async (the caller commits the group).
template <typename W, int ROWS, int UNITS, int THREADS>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ a,
                                            const W* __restrict__ w, int rows,
                                            int hidden, int row0, int u0,
                                            int k0, int kc, float* hs, W* ws) {
  constexpr int kAPitch = Tile<ROWS, UNITS, 1>::kAPitch;
  const int tid = threadIdx.x;
  const int quads = kc / 4;                 // 16-byte pieces per row
  for (int e = tid; e < ROWS * quads; e += THREADS) {
    const int r = e / quads, c = e % quads;
    const int row = row0 + r;
    const bool ok = row < rows;
    mma::cp_async16(hs + (size_t)r * kAPitch + 4 * c,
                    a + (size_t)(ok ? row : 0) * hidden + k0 + 4 * c,
                    ok ? 16 : 0);
  }
  // per (k, gate): UNITS contiguous weights, moved in 8-byte pieces
  constexpr int kPieces = UNITS * (int)sizeof(W) / 8;
  const size_t four_h = 4 * (size_t)hidden;
  for (int e = tid; e < kc * 4 * kPieces; e += THREADS) {
    const int k = e / (4 * kPieces), rem = e % (4 * kPieces);
    const int g = rem / kPieces, p = rem % kPieces;
    const char* src =
        reinterpret_cast<const char*>(w + (size_t)(k0 + k) * four_h +
                                      (size_t)g * hidden + u0) +
        8 * p;
    char* dst = reinterpret_cast<char*>(ws + ((size_t)k * 4 + g) * UNITS) +
                8 * p;
    cp_async8(dst, src);
  }
}

// acc[i][g] += sum over this thread's slice of the chunk's kc rows of
// round_W(a[row_i, k]) * w[k, g * H + u]
template <typename W, int ROWS, int UNITS, int KSPLIT>
__device__ __forceinline__ void contract(const float* hs, const W* ws, int kc,
                                         int j, int rp, int ks,
                                         float (&acc)[2][4]) {
  constexpr int kAPitch = Tile<ROWS, UNITS, KSPLIT>::kAPitch;
  const int kper = kc / KSPLIT;
  const int kbeg = ks * kper;
  const float* a0 = hs + (size_t)rp * kAPitch;
  const float* a1 = hs + (size_t)(rp + ROWS / 2) * kAPitch;
#pragma unroll 4
  for (int k = kbeg; k < kbeg + kper; ++k) {
    const float x0 = round_to<W>(a0[k]);
    const float x1 = round_to<W>(a1[k]);
    const W* wk = ws + (size_t)k * 4 * UNITS + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float wv = to_float(wk[g * UNITS]);
      acc[0][g] = fmaf(x0, wv, acc[0][g]);
      acc[1][g] = fmaf(x1, wv, acc[1][g]);
    }
  }
}

// One time step of one layer.  zx [B, 4H] (layer 0) or x [B, H] with wx
// [H, 4H] (in-kernel projection, layers >= 1); exactly one of the two is
// given.  wh [H, 4H]; bias [4H]; mask [B]; h_prev/h_next/c [B, H] fp32;
// ys/cs [B, H] in the stream dtype S; (optional) gates [B, 4H] in G.  The
// contraction (x . Wx, then h . Wh) runs as a walk over kChunk-row chunks
// through a kStages-slot cp.async ring: the next chunk loads while this
// one multiplies, and any H that is a multiple of 32 fits.
// (Three blocks an SM, the occupancy of the whole-row stage at H = 512:
// with only the block size given, ptxas spilled the fp32 narrow tile to 64
// registers to fit a fourth.)
template <typename W, typename S, typename G, int ROWS, int UNITS,
          int KSPLIT>
__global__ void __launch_bounds__(Tile<ROWS, UNITS, KSPLIT>::kThreads, 3)
    lstm_step_kernel(const S* __restrict__ zx, const float* __restrict__ x,
                     const W* __restrict__ wx, const W* __restrict__ wh,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ h_prev,
                     float* __restrict__ h_next, float* __restrict__ c,
                     S* __restrict__ ys, S* __restrict__ cs,
                     G* __restrict__ gates, int rows, int hidden) {
  using T = Tile<ROWS, UNITS, KSPLIT>;
  constexpr int kThreads = T::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int u0 = blockIdx.x * UNITS;
  const int row0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int j = tid % UNITS;
  const int rp = (tid / UNITS) % (ROWS / 2);
  const int ks = tid / (UNITS * (ROWS / 2));

  // chunks [0, n_x) contract x . Wx, the rest h_prev . Wh
  constexpr int kChunk = T::kChunk;
  const int per = (hidden + kChunk - 1) / kChunk;
  const int n_x = x != nullptr ? per : 0, n_all = n_x + per;
  auto slot_a = [&](int ch) {
    return reinterpret_cast<float*>(smem + (ch % kStages) *
                                               T::template slot_bytes<W>());
  };
  auto slot_w = [&](int ch) {
    return reinterpret_cast<W*>(reinterpret_cast<unsigned char*>(slot_a(ch)) +
                                T::a_bytes());
  };
  auto k_first = [&](int ch) { return (ch < n_x ? ch : ch - n_x) * kChunk; };
  auto width = [&](int ch) {
    const int k0 = k_first(ch);
    return hidden - k0 < kChunk ? hidden - k0 : kChunk;
  };
  auto issue = [&](int ch) {
    const bool from_x = ch < n_x;
    stage_chunk<W, ROWS, UNITS, kThreads>(
        from_x ? x : h_prev, from_x ? wx : wh, rows, hidden, row0, u0,
        k_first(ch), width(ch), slot_a(ch), slot_w(ch));
    mma::cp_async_commit();
  };

  float acc[2][4] = {};
  issue(0);
#pragma unroll 1
  for (int ch = 0; ch < n_all; ++ch) {
    if (ch + 1 < n_all) {
      issue(ch + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch landed
    contract<W, ROWS, UNITS, KSPLIT>(slot_a(ch), slot_w(ch), width(ch), j, rp,
                                     ks, acc);
    __syncthreads();  // its slot is free for chunk ch + kStages
  }

  if (KSPLIT > 1) {  // sum the contraction slices in slice order
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rp + i * (ROWS / 2);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        red[(((size_t)ks * ROWS + r) * UNITS + j) * 4 + g] = acc[i][g];
    }
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rp + i * (ROWS / 2);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = red[((size_t)r * UNITS + j) * 4 + g];
        for (int q = 1; q < KSPLIT; ++q)
          s += red[(((size_t)q * ROWS + r) * UNITS + j) * 4 + g];
        acc[i][g] = s;
      }
    }
  }

  const int u = u0 + j;
  const size_t four_h = 4 * (size_t)hidden;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + rp + i * (ROWS / 2);
    if (row >= rows) continue;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float v = acc[i][g];
      if (zx != nullptr)
        v += to_float(zx[(size_t)row * four_h + (size_t)g * hidden + u]);
      z[g] = v + bias[g * hidden + u];
    }
    const float si = sigmoid(z[0]);
    const float tj = tanhf(z[1]);
    const float sf = sigmoid(z[2] + 1.0f);  // in-cell forget bias
    const float so = sigmoid(z[3]);
    if (gates != nullptr) {
      G* g = gates + (size_t)row * four_h + u;
      g[0] = gate_out<G>(si, true);
      g[hidden] = gate_out<G>(tj, false);
      g[2 * (size_t)hidden] = gate_out<G>(sf, true);
      g[3 * (size_t)hidden] = gate_out<G>(so, true);
    }
    const size_t idx = (size_t)row * hidden + u;
    const float c_old = c[idx];
    const float h_old = h_prev[idx];
    const float c_new = sf * c_old + si * tj;
    const float h_new = so * tanhf(c_new);
    const bool live = mask[row] > 0.0f;
    const float hv = live ? h_new : h_old;
    const float cv = live ? c_new : c_old;
    h_next[idx] = hv;
    c[idx] = cv;
    ys[idx] = from_float<S>(hv);
    cs[idx] = from_float<S>(cv);
  }
}

// One step launch with a fixed tile shape.
template <typename W, typename S, typename G, int ROWS, int UNITS,
          int KSPLIT>
struct StepLauncher {
  using T = Tile<ROWS, UNITS, KSPLIT>;
  size_t smem = 0;

  cudaError_t prepare(int) {
    smem = T::template smem_bytes<W>();
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(
        lstm_step_kernel<W, S, G, ROWS, UNITS, KSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }

  cudaError_t launch(const S* zx, const float* x, const W* wx, const W* wh,
                     const float* bias, const float* mask,
                     const float* h_prev, float* h_next, float* c, S* ys,
                     S* cs, G* gates, int rows, int hidden,
                     cudaStream_t stream) const {
    const dim3 grid(hidden / UNITS, (rows + ROWS - 1) / ROWS);
    lstm_step_kernel<W, S, G, ROWS, UNITS, KSPLIT>
        <<<grid, T::kThreads, smem, stream>>>(zx, x, wx, wh, bias, mask,
                                              h_prev, h_next, c, ys, cs,
                                              gates, rows, hidden);
    return cudaGetLastError();
  }
};

template <typename W, typename S, typename G, typename L>
cudaError_t run_layer_with(L& launcher, const void* zx_v, const void* wh_v,
                           const float* bias, const float* mask,
                           float* h_buf, float* c, void* ys_v, void* cs_v,
                           void* gates_v, int steps, int rows, int hidden,
                           cudaStream_t stream) {
  cudaError_t err = launcher.prepare(hidden);
  if (err != cudaSuccess) return err;
  const S* zx = static_cast<const S*>(zx_v);
  const W* wh = static_cast<const W*>(wh_v);
  S* ys = static_cast<S*>(ys_v);
  S* cs = static_cast<S*>(cs_v);
  G* gates = static_cast<G*>(gates_v);
  const size_t bh = (size_t)rows * hidden;
  for (int t = 0; t < steps; ++t) {
    err = launcher.launch(zx + (size_t)t * 4 * bh, nullptr, nullptr, wh,
                          bias, mask + (size_t)t * rows,
                          h_buf + (t & 1) * bh, h_buf + ((t + 1) & 1) * bh,
                          c, ys + t * bh, cs + t * bh,
                          gates ? gates + (size_t)t * 4 * bh : nullptr, rows,
                          hidden, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename W, typename S, typename L>
cudaError_t run_stack_with(L& launcher, const void* zx_v, const void* wx_v,
                           const void* wh_v, const float* bias,
                           const float* mask, float* h_buf, float* c,
                           void* ys_v, void* cs_v, void* gates_v, int steps,
                           int rows, int hidden, int layers,
                           cudaStream_t stream) {
  cudaError_t err = launcher.prepare(hidden);
  if (err != cudaSuccess) return err;
  const S* zx = static_cast<const S*>(zx_v);
  const W* wx = static_cast<const W*>(wx_v);
  const W* wh = static_cast<const W*>(wh_v);
  S* ys = static_cast<S*>(ys_v);
  S* cs = static_cast<S*>(cs_v);
  S* gates = static_cast<S*>(gates_v);
  const size_t bh = (size_t)rows * hidden;
  const size_t whh = (size_t)hidden * 4 * hidden;
  for (int t = 0; t < steps; ++t) {
    float* h_cur = h_buf + (size_t)(t & 1) * layers * bh;
    float* h_new = h_buf + (size_t)((t + 1) & 1) * layers * bh;
    for (int l = 0; l < layers; ++l) {
      // layer l >= 1 reads layer l-1's masked fp32 h of this same step
      err = launcher.launch(
          l == 0 ? zx + (size_t)t * 4 * bh : nullptr,
          l == 0 ? nullptr : h_new + (l - 1) * bh,
          l == 0 ? nullptr : wx + (l - 1) * whh, wh + l * whh,
          bias + (size_t)l * 4 * hidden, mask + (size_t)t * rows,
          h_cur + l * bh, h_new + l * bh, c + l * bh,
          ys + ((size_t)l * steps + t) * bh,
          cs + ((size_t)l * steps + t) * bh,
          gates ? gates + ((size_t)l * steps + t) * 4 * bh : nullptr, rows,
          hidden, stream);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// Tile shapes: wide batches take 32-row tiles of 8 units; batches of at
// most 16 rows take 16-row tiles of 4 units with the contraction split 8
// ways.
template <typename W, typename G>
using Wide = StepLauncher<W, W, G, 32, 8, 2>;
template <typename W, typename G>
using Narrow = StepLauncher<W, W, G, 16, 4, 8>;

bool use_wide(int rows) { return rows > 16; }

bool shape_ok(int rows, int hidden) {
  return rows > 0 && hidden > 0 && hidden % 32 == 0;
}

template <typename W, typename G>
cudaError_t layer_with(const void* zx, const void* wh, const float* bias,
                       const float* mask, float* h_buf, float* c, void* ys,
                       void* cs, void* gates, int steps, int rows, int hidden,
                       cudaStream_t st) {
  if (use_wide(rows)) {
    Wide<W, G> l;
    return run_layer_with<W, W, G>(l, zx, wh, bias, mask, h_buf, c, ys, cs,
                                   gates, steps, rows, hidden, st);
  }
  Narrow<W, G> l;
  return run_layer_with<W, W, G>(l, zx, wh, bias, mask, h_buf, c, ys, cs,
                                 gates, steps, rows, hidden, st);
}

template <typename W>
cudaError_t stack_with(const void* zx, const void* wx_rest, const void* wh,
                       const float* bias, const float* mask, float* h_buf,
                       float* c, void* ys, void* cs, void* gates, int steps,
                       int rows, int hidden, int layers, cudaStream_t st) {
  if (use_wide(rows)) {
    Wide<W, W> l;
    return run_stack_with<W, W>(l, zx, wx_rest, wh, bias, mask, h_buf, c,
                                ys, cs, gates, steps, rows, hidden, layers,
                                st);
  }
  Narrow<W, W> l;
  return run_stack_with<W, W>(l, zx, wx_rest, wh, bias, mask, h_buf, c, ys,
                              cs, gates, steps, rows, hidden, layers, st);
}

// ---------------------------------------------------------------------------
// The persistent bf16 kernels
// ---------------------------------------------------------------------------

namespace pc = lstm_cluster;
using bf16 = __nv_bfloat16;

// Shared memory of a block at H = 32 NB: the resident slice, the h buffer
// (bf16, all H units of the tile's rows), the block's own bf16(h_t) before
// the exchange (also its ys tile), the partial sums the two contraction
// halves swap, and the step's gates tile in G (written out in 16-byte
// pieces: a 2-byte store per gate took a visible share of the step).  A
// projection stage uses the first three: the slice, its A tile, red.
template <int NB, typename G>
struct FwdSmem {
  static constexpr int kHidden = NB * pc::kUnits;
  static constexpr int kAPitch = kHidden + 8;     // bf16 per h row
  static constexpr size_t kWs = (size_t)kHidden * pc::kWsPitch * 2;
  static constexpr size_t kA = (size_t)pc::kRows * kAPitch * 2;
  static constexpr size_t kHs = (size_t)pc::kRows * pc::kUnits * 2;
  // [m tile][gate][entry][4 octets x 32 lanes] fp32
  static constexpr size_t kRed = (size_t)2 * 16 * 128 * 4;
  static constexpr size_t kG = (size_t)pc::kRows * pc::kCols * sizeof(G);
  static constexpr size_t kBytes = kWs + kA + kHs + kRed + kG;
  static_assert(kBytes <= (size_t)kMaxSmem, "forward slice does not fit");
};

__device__ __forceinline__ float component(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The products of the tile's 32 rows (abuf: bf16, pitch H + 8) with the
// block's resident slice ws, for this thread's 16 accumulator entries:
// z[g][e] = sum over k < H of a[row, k] ws[k, slice_col(g, unit)] for row
// 16 kh + gl (e < 2) or 16 kh + gl + 8 (e >= 2) and unit 8q + 2tl + e % 2 of
// the block, where warp = 4 kh + q and lane = 4 gl + tl.  Warp (q, kh) sums
// contraction half kh for both 16-row m tiles on mma.sync; the halves swap
// partial sums through `red` and each warp keeps m tile kh, first half +
// second half.  Holds a block barrier; red is free after the caller's next.
template <int H>
__device__ __forceinline__ void tile_product(const bf16* abuf,
                                             const bf16* ws, float* red,
                                             float (&z)[4][4]) {
  constexpr int P = H + 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = warp % 4, kh = warp / 4;
  float acc[2][4][4] = {};
  const int kbeg = kh * (H / 2);
#pragma unroll 4
  for (int k0 = kbeg; k0 < kbeg + H / 2; k0 += 16) {
    uint32_t af[2][4], bfr[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      mma::ldsm_x4(af[m], abuf + (16 * m + mma::a_row(lane)) * P + k0 +
                              mma::a_col(lane));
#pragma unroll
    for (int pr = 0; pr < 2; ++pr)
      mma::ldsm_x4_trans(bfr[pr], ws + (size_t)(k0 + mma::bk_row(lane)) *
                                           pc::kWsPitch +
                                       32 * q + 16 * pr + mma::bk_col(lane));
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        mma::mma_bf16(acc[m][g], af[m], bfr[g / 2][2 * (g % 2)],
                      bfr[g / 2][2 * (g % 2) + 1]);
  }
  // hand the other m tile's partial to the warp that finishes it (kh
  // selects by value: indexing acc by it would put acc in local memory)
  float* mine = red + (size_t)kh * 16 * 128 + q * 32 + lane;
  float* other = red + (size_t)(1 - kh) * 16 * 128 + q * 32 + lane;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      other[(g * 4 + e) * 128] = kh == 0 ? acc[1][g][e] : acc[0][g][e];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      z[g][e] = kh == 0 ? acc[0][g][e] + mine[(g * 4 + e) * 128]
                        : mine[(g * 4 + e) * 128] + acc[1][g][e];
}

// One recurrence: the 32-row tile [row0, row0 + 32) of one layer (rows from
// row_hi on are padding) for all T steps on one cluster of NB blocks; block
// `rank` owns units U_rank.  Streams are [T, B, .] with B = rows; h0, c0,
// hT, cT [B, H] fp32.  Its input projection comes from the bf16 stream zx
// [T, B, 4H] or (kRing) from the fp32 ring [kRingDepth][NB][4][256] float4
// that a projection stage fills, once its flags (`ring_ready`) say the step
// is there.  done: this stage's flags, published after each step (ys, cs
// and the gates written, the ring slot read), or null.
template <typename G>
struct FwdRec {
  const bf16* zx;
  const float4* ring;
  const unsigned* ring_ready;
  unsigned* done;
  const bf16* wh;
  const float* bias;
  const float* mask;
  const float* h0;
  const float* c0;
  bf16* ys;
  bf16* cs;
  G* gates;                    // [T, B, 4H] or null
  float* hT;
  float* cT;
  bf16* xtile;                 // h's exchange: 2 halves of [32][H]
  size_t xhalf;
  int steps, rows, row0, row_hi;
};

// The all-gather goes through L2: each block writes its bf16(h_t)[rows,
// U_j] into the step's half of the exchange, a cluster barrier (release /
// acquire) orders the writes, and every block copies the whole [rows, H]
// tile into its h buffer (cp.async.cg) before the next step's products;
// pushed into the peers' shared memory with st.shared::cluster instead, the
// same bytes took longer.  The halves alternate by step, so one barrier a
// step suffices.
//
// Thread (warp 4 kh + q, lane 4 gl + tl) owns, after tile_product, rows
// 16 kh + gl and 16 kh + gl + 8 and units 8q + 2tl, 8q + 2tl + 1: their
// four gates' pre-activations, and their h and c in registers.
template <int NB, typename G, bool kRing>
__device__ __forceinline__ void fwd_recurrence(const FwdRec<G>& a,
                                               unsigned char* smem) {
  using Sm = FwdSmem<NB, G>;
  constexpr int H = Sm::kHidden, P = Sm::kAPitch;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* abuf = reinterpret_cast<bf16*>(smem + Sm::kWs);
  bf16* hs = reinterpret_cast<bf16*>(smem + Sm::kWs + Sm::kA);
  float* red = reinterpret_cast<float*>(smem + Sm::kWs + Sm::kA + Sm::kHs);
  G* gtile = reinterpret_cast<G*>(smem + Sm::kWs + Sm::kA + Sm::kHs +
                                  Sm::kRed);     // [rows][gate][unit]
  const int steps = a.steps, rows = a.rows, row0 = a.row0, row_hi = a.row_hi;
  const unsigned me = pc::rank();
  const int u0 = me * pc::kUnits;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = warp % 4, kh = warp / 4;
  const int gl = lane / 4, tl = lane % 4;
  const int ucol = 8 * q + 2 * tl;           // this lane's first unit
  // this thread's rows, index hf: tile rows 16 kh + 8 hf + gl
  int rloc[2], rglob[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rloc[hf] = 16 * kh + 8 * hf + gl;
    rglob[hf] = row0 + rloc[hf];
  }

  pc::stage_slice(a.wh, H, u0, ws);
  // bf16(h0) of the tile's rows, all H units, into the h buffer
  for (int e = tid; e < pc::kRows * H / 4; e += pc::kThreads) {
    const int r = e / (H / 4), k = 4 * (e % (H / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < row_hi)
      v = *reinterpret_cast<const float4*>(a.h0 + (size_t)(row0 + r) * H + k);
    *reinterpret_cast<uint2*>(abuf + r * P + k) =
        make_uint2(mma::pack_bf16(v.x, v.y), mma::pack_bf16(v.z, v.w));
  }
  // the fp32 state [hf][ui] and the bias [gate][ui] of this thread's pairs
  float h[2][2], c[2][2], b[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int ui = 0; ui < 2; ++ui) b[g][ui] = a.bias[g * H + u0 + ucol + ui];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int ui = 0; ui < 2; ++ui) {
      const bool ok = rglob[hf] < row_hi;
      const size_t idx = (size_t)rglob[hf] * H + u0 + ucol + ui;
      h[hf][ui] = ok ? a.h0[idx] : 0.f;
      c[hf][ui] = ok ? a.c0[idx] : 0.f;
    }
  mma::cp_async_wait<0>();
  __syncthreads();

  const size_t four_h = 4 * (size_t)H;
  // step t's input projection of this thread's entries ([hf][gate]: a bf16
  // pair from the stream; [gate]: a float4 from the ring) and mask, loaded
  // a step ahead
  uint32_t zn[2][4];
  float4 rn[4];
  float mn[2];
  auto load_in = [&](int t) {
    if constexpr (kRing) {
      if (t < steps) {
        pc::wait_for<NB>(a.ring_ready, t + 1);
        const float4* src =
            a.ring +
            ((size_t)(t % pc::kRingDepth) * NB + me) * 4 * pc::kThreads + tid;
#pragma unroll
        for (int g = 0; g < 4; ++g) rn[g] = __ldcg(src + g * pc::kThreads);
      }
    } else {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const bool ok = t < steps && rglob[hf] < row_hi;
        const bf16* zr =
            a.zx + ((size_t)t * rows + rglob[hf]) * four_h + u0 + ucol;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          zn[hf][g] =
              ok ? *reinterpret_cast<const uint32_t*>(zr + g * H) : 0u;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      mn[hf] = t < steps && rglob[hf] < row_hi
                   ? a.mask[(size_t)t * rows + rglob[hf]]
                   : 0.f;
  };
  load_in(0);
  for (int t = 0; t < steps; ++t) {
    if (t > 0) {  // bf16(h_{t-1}) of the whole tile, from xh's half
      const bf16* src = a.xtile + ((t - 1) & 1) * a.xhalf;
      for (int e = tid; e < pc::kRows * H / 8; e += pc::kThreads) {
        const int r = e / (H / 8), k = 8 * (e % (H / 8));
        mma::cp_async16(abuf + r * P + k, src + (size_t)r * H + k);
      }
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      __syncthreads();
    }
    uint32_t zv[2][4];
    float4 rv[4];
    float mv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mv[hf] = mn[hf];
#pragma unroll
      for (int g = 0; g < 4; ++g) zv[hf][g] = zn[hf][g];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) rv[g] = rn[g];
    load_in(t + 1);                            // in flight over this step
    float prod[4][4];                          // bf16(h_{t-1}) . Wh
    tile_product<H>(abuf, ws, red, prod);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float act[4][2];
#pragma unroll
      for (int ui = 0; ui < 2; ++ui) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int e = 2 * hf + ui;
          float zxv;
          if constexpr (kRing) {
            zxv = component(rv[g], e);
          } else {
            const uint32_t zp = zv[hf][g];     // bf16 pair, as bits
            zxv = __uint_as_float(ui ? zp & 0xffff0000u : zp << 16);
          }
          z[g] = (zxv + prod[g][e]) + b[g][ui];
        }
        act[0][ui] = sigmoid(z[0]);
        act[1][ui] = tanhf(z[1]);
        act[2][ui] = sigmoid(z[2] + 1.0f);    // in-cell forget bias
        act[3][ui] = sigmoid(z[3]);
        const float c_new = act[2][ui] * c[hf][ui] + act[0][ui] * act[1][ui];
        const float h_new = act[3][ui] * tanhf(c_new);
        if (mv[hf] > 0.0f) {
          h[hf][ui] = h_new;
          c[hf][ui] = c_new;
        }
      }
      *reinterpret_cast<uint32_t*>(hs + rloc[hf] * pc::kUnits + ucol) =
          mma::pack_bf16(h[hf][0], h[hf][1]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        G* gp = gtile + rloc[hf] * pc::kCols + g * pc::kUnits + ucol;
        gp[0] = gate_out<G>(act[g][0], g != 1);
        gp[1] = gate_out<G>(act[g][1], g != 1);
      }
      if (rglob[hf] < row_hi)
        *reinterpret_cast<uint32_t*>(
            a.cs + ((size_t)t * rows + rglob[hf]) * H + u0 + ucol) =
            mma::pack_bf16(c[hf][0], c[hf][1]);
    }
    __syncthreads();  // hs and the gates tile complete; red read
    // ys (= hs) and the gates of the tile's rows, in 16-byte pieces
    for (int e = tid; e < pc::kRows * 4; e += pc::kThreads) {
      const int r = e / 4, o = e % 4;
      if (row0 + r < row_hi)
        *reinterpret_cast<uint4*>(a.ys + ((size_t)t * rows + row0 + r) * H +
                                  u0 + 8 * o) =
            *reinterpret_cast<const uint4*>(hs + r * pc::kUnits + 8 * o);
    }
    if (a.gates != nullptr) {
      constexpr int kPer = 16 / sizeof(G);           // gates a piece
      constexpr int kRowPieces = pc::kCols / kPer;
      for (int e = tid; e < pc::kRows * kRowPieces; e += pc::kThreads) {
        const int r = e / kRowPieces, col = (e % kRowPieces) * kPer;
        if (row0 + r < row_hi)
          *reinterpret_cast<uint4*>(
              a.gates + ((size_t)t * rows + row0 + r) * four_h +
              (size_t)(col / pc::kUnits) * H + u0 + col % pc::kUnits) =
              *reinterpret_cast<const uint4*>(gtile + r * pc::kCols + col);
      }
    }
    if (t + 1 == steps) {
      if (a.done != nullptr) {
        __syncthreads();
        if (tid == 0) pc::publish(a.done, t + 1);
      }
      break;
    }
    // bf16(h_t)[rows, U_j], 128 pieces of 16 bytes, into xh's half
    if (tid < pc::kRows * 4) {
      const int r = tid / 4, o = tid % 4;
      __stcg(reinterpret_cast<uint4*>(a.xtile + (t & 1) * a.xhalf +
                                      (size_t)r * H + u0 + 8 * o),
             *reinterpret_cast<const uint4*>(hs + r * pc::kUnits + 8 * o));
    }
    pc::sync();  // h_t in L2 for the whole cluster
    if (a.done != nullptr && tid == 0) pc::publish(a.done, t + 1);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (rglob[hf] >= row_hi) continue;
    const size_t idx = (size_t)rglob[hf] * H + u0 + ucol;
    *reinterpret_cast<float2*>(a.hT + idx) = make_float2(h[hf][0], h[hf][1]);
    *reinterpret_cast<float2*>(a.cT + idx) = make_float2(c[hf][0], c[hf][1]);
  }
}

// zx [T, B, 4H], wh [H, 4H], ys/cs [T, B, H] bf16; bias [4H], mask [T, B],
// h0/c0/hT/cT [B, H] fp32; gates [T, B, 4H] in G, or null; xh, the
// exchange: [2 (step parity)][row tiles][rows][H] bf16.  Grid (NB, row
// tiles) in clusters of (NB, 1): one recurrence per row tile.
template <int NB, typename G>
__global__ void __launch_bounds__(pc::kThreads, 1)
    lstm_fwd_persist_kernel(const bf16* __restrict__ zx,
                            const bf16* __restrict__ wh,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const float* __restrict__ h0,
                            const float* __restrict__ c0,
                            bf16* __restrict__ ys, bf16* __restrict__ cs,
                            G* __restrict__ gates, float* __restrict__ hT,
                            float* __restrict__ cT, bf16* __restrict__ xh,
                            int steps, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = NB * pc::kUnits;
  FwdRec<G> a{zx, nullptr, nullptr, nullptr, wh, bias, mask, h0, c0, ys, cs,
              gates, hT, cT, xh + (size_t)blockIdx.y * pc::kRows * H,
              (size_t)gridDim.y * pc::kRows * H, steps, rows,
              (int)blockIdx.y * pc::kRows, rows};
  fwd_recurrence<NB, G, false>(a, smem);
}

// One projection stage of the stack: layer l >= 1's input projection of
// the tile, zx_l[t][rows, C_j] = bf16(ys_{l-1}[t]) . Wx_l[:, C_j] in fp32
// (tile_product with Wx's slice resident), into the ring that recurrence
// stage l reads, for all T steps.  Feed-forward: no cluster barrier.  Step
// t waits for ys_{l-1}[t] (in_ready: the flags of recurrence stage l-1) and
// for its ring slot (slot_free: recurrence stage l has finished step
// t - kRingDepth).
// ys_in reads exactly what the TPU kernel feeds the product, bf16 of the
// masked h (lstm_fused.py:107 and :123).
struct FwdProj {
  const bf16* ys_in;           // [T, B, H], layer l-1
  const bf16* wx;              // [H, 4H]
  float4* ring;
  const unsigned* in_ready;
  const unsigned* slot_free;
  unsigned* done;
  int steps, rows, row0, row_hi;
};

template <int NB>
__device__ __forceinline__ void fwd_projection(const FwdProj& a,
                                               unsigned char* smem) {
  using Sm = FwdSmem<NB, bf16>;
  constexpr int H = Sm::kHidden, P = Sm::kAPitch;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* abuf = reinterpret_cast<bf16*>(smem + Sm::kWs);
  float* red = reinterpret_cast<float*>(smem + Sm::kWs + Sm::kA + Sm::kHs);
  const unsigned me = pc::rank();
  const int tid = threadIdx.x;
  pc::stage_slice(a.wx, H, me * pc::kUnits, ws);
  for (int t = 0; t < a.steps; ++t) {
    if (tid < NB) {
      pc::spin_until(a.in_ready + tid, t + 1);
      if (t >= pc::kRingDepth)
        pc::spin_until(a.slot_free + tid, t - pc::kRingDepth + 1);
    }
    __syncthreads();
    const bf16* src = a.ys_in + (size_t)t * a.rows * H;
    for (int e = tid; e < pc::kRows * H / 8; e += pc::kThreads) {
      const int r = e / (H / 8), k = 8 * (e % (H / 8));
      const bool ok = a.row0 + r < a.row_hi;
      mma::cp_async16(abuf + r * P + k,
                      src + (ok ? (size_t)(a.row0 + r) * H + k : 0),
                      ok ? 16 : 0);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    float z[4][4];
    tile_product<H>(abuf, ws, red, z);
    float4* dst = a.ring +
                  ((size_t)(t % pc::kRingDepth) * NB + me) * 4 * pc::kThreads +
                  tid;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      __stcg(dst + g * pc::kThreads,
             make_float4(z[g][0], z[g][1], z[g][2], z[g][3]));
    __syncthreads();  // the slot written, abuf and red free
    if (tid == 0) pc::publish(a.done, t + 1);
  }
}

// The stack as a layer wavefront of 2L - 1 stages per 32-row tile, each a
// cluster of NB blocks, all resident at once (a cooperative launch):
// recurrence stage l (cluster s = 2l of the tile) runs layer l's
// fwd_recurrence with Wh_l's slice resident, projection stage l >= 1
// (s = 2l - 1) fwd_projection with Wx_l's.  Layer 0 runs ahead on the zx
// stream, stage 2l - 1 follows it through ys_{l-1}, and layer l reads its
// projection from the ring: in steady state a step costs the slowest
// stage's step plus nothing, not L recurrence steps.
//
// zx [T, B, 4H], wx [L-1, H, 4H], wh [L, H, 4H], ys/cs [L, T, B, H] bf16;
// bias [L, 4H], mask [T, B], h0/c0/hT/cT [L, B, H] fp32; gates [L, T, B,
// 4H] bf16 or null.  Scratch: xh [tiles][L][2][32][H] bf16, ring
// [tiles][L-1][kRingDepth][NB][4][256] float4, step flags [tiles][2L - 1]
// [NB] (zero on entry).  Grid (NB, tiles (2L - 1)): cluster y = (2L - 1) tile +
// s runs stage s of the tile of rows [row_lo + 32 tile, + 32) below row_hi.
template <int NB>
__global__ void __launch_bounds__(pc::kThreads, 1)
    lstm_fwd_stack_persist_kernel(
        const bf16* __restrict__ zx, const bf16* __restrict__ wx,
        const bf16* __restrict__ wh, const float* __restrict__ bias,
        const float* __restrict__ mask, const float* __restrict__ h0,
        const float* __restrict__ c0, bf16* __restrict__ ys,
        bf16* __restrict__ cs, bf16* __restrict__ gates,
        float* __restrict__ hT, float* __restrict__ cT,
        bf16* __restrict__ xh, float4* __restrict__ ring,
        unsigned* __restrict__ flags, int steps, int rows, int row_lo,
        int row_hi, int layers) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = NB * pc::kUnits;
  const int stages = 2 * layers - 1;
  const int tile = blockIdx.y / stages, s = blockIdx.y % stages;
  const int row0 = row_lo + tile * pc::kRows;
  unsigned* cnt = flags + (size_t)tile * stages * NB;  // stage s: + s NB
  const size_t whh = (size_t)H * 4 * H, bh = (size_t)rows * H;
  const size_t ring_len = (size_t)pc::kRingDepth * NB * 4 * pc::kThreads;
  if (s % 2 == 1) {
    const int l = (s + 1) / 2;
    FwdProj a{ys + (size_t)(l - 1) * steps * bh, wx + (size_t)(l - 1) * whh,
              ring + ((size_t)tile * (layers - 1) + l - 1) * ring_len,
              cnt + (s - 1) * NB, cnt + (s + 1) * NB, cnt + s * NB, steps,
              rows, row0, row_hi};
    fwd_projection<NB>(a, smem);
    return;
  }
  const int l = s / 2;
  FwdRec<bf16> a{
      zx,
      l > 0 ? ring + ((size_t)tile * (layers - 1) + l - 1) * ring_len
            : nullptr,
      l > 0 ? cnt + (s - 1) * NB : nullptr, cnt + s * NB,
      wh + (size_t)l * whh,
      bias + (size_t)l * 4 * H, mask, h0 + (size_t)l * bh,
      c0 + (size_t)l * bh, ys + (size_t)l * steps * bh,
      cs + (size_t)l * steps * bh,
      gates != nullptr ? gates + (size_t)l * steps * 4 * bh : nullptr,
      hT + (size_t)l * bh, cT + (size_t)l * bh,
      xh + ((size_t)tile * layers + l) * 2 * pc::kRows * H,
      (size_t)pc::kRows * H, steps, rows, row0, row_hi};
  if (l == 0)
    fwd_recurrence<NB, bf16, false>(a, smem);
  else
    fwd_recurrence<NB, bf16, true>(a, smem);
}

template <int NB, typename G>
cudaError_t persist_with(const void* zx, const void* wh, const float* bias,
                         const float* mask, const float* h0, const float* c0,
                         void* ys, void* cs, void* gates, float* hT,
                         float* cT, void* xh, int steps, int rows,
                         cudaStream_t st) {
  return pc::launch(lstm_fwd_persist_kernel<NB, G>, NB, rows,
                    FwdSmem<NB, G>::kBytes, st, static_cast<const bf16*>(zx),
                    static_cast<const bf16*>(wh), bias, mask, h0, c0,
                    static_cast<bf16*>(ys), static_cast<bf16*>(cs),
                    static_cast<G*>(gates), hT, cT, static_cast<bf16*>(xh),
                    steps, rows);
}

template <typename G>
cudaError_t persist(const void* zx, const void* wh, const float* bias,
                    const float* mask, const float* h0, const float* c0,
                    void* ys, void* cs, void* gates, float* hT, float* cT,
                    void* xh, int steps, int rows, int hidden,
                    cudaStream_t st) {
  switch (hidden / pc::kUnits) {
    case 4:
      return persist_with<4, G>(zx, wh, bias, mask, h0, c0, ys, cs, gates,
                                hT, cT, xh, steps, rows, st);
    case 8:
      return persist_with<8, G>(zx, wh, bias, mask, h0, c0, ys, cs, gates,
                                hT, cT, xh, steps, rows, st);
    case 12:
      return persist_with<12, G>(zx, wh, bias, mask, h0, c0, ys, cs, gates,
                                 hT, cT, xh, steps, rows, st);
    case 16:
      return persist_with<16, G>(zx, wh, bias, mask, h0, c0, ys, cs, gates,
                                 hT, cT, xh, steps, rows, st);
  }
  return cudaErrorInvalidValue;
}

// The stack kernel at H = 32 NB: launch (tiles > 0: tiles row tiles) or
// query (tiles = 0: how many tiles one launch holds at `layers`).
template <int NB>
cudaError_t stack_persist_with(const void* zx, const void* wx,
                               const void* wh, const float* bias,
                               const float* mask, const float* h0,
                               const float* c0, void* ys, void* cs,
                               void* gates, float* hT, float* cT, void* xh,
                               void* ring, unsigned* flags, int steps,
                               int rows, int row_lo, int row_hi, int layers,
                               int tiles, int* fit, cudaStream_t st) {
  auto kernel = lstm_fwd_stack_persist_kernel<NB>;
  constexpr size_t smem = FwdSmem<NB, bf16>::kBytes;
  if (tiles == 0) {
    *fit = pc::max_clusters(kernel, NB, smem) / (2 * layers - 1);
    return cudaSuccess;
  }
  return pc::launch_clusters(
      kernel, NB, tiles * (2 * layers - 1), true, smem, st,
      static_cast<const bf16*>(zx), static_cast<const bf16*>(wx),
      static_cast<const bf16*>(wh), bias, mask, h0, c0,
      static_cast<bf16*>(ys), static_cast<bf16*>(cs),
      static_cast<bf16*>(gates), hT, cT, static_cast<bf16*>(xh),
      static_cast<float4*>(ring), flags, steps, rows, row_lo, row_hi,
      layers);
}

cudaError_t stack_persist(const void* zx, const void* wx, const void* wh,
                          const float* bias, const float* mask,
                          const float* h0, const float* c0, void* ys,
                          void* cs, void* gates, float* hT, float* cT,
                          void* xh, void* ring, unsigned* flags, int steps,
                          int rows, int row_lo, int row_hi, int hidden,
                          int layers, int tiles, int* fit, cudaStream_t st) {
  switch (hidden / pc::kUnits) {
#define LSTM_STACK_CASE(NB)                                                  \
  case NB:                                                                   \
    return stack_persist_with<NB>(zx, wx, wh, bias, mask, h0, c0, ys, cs,    \
                                  gates, hT, cT, xh, ring, flags, steps,  \
                                  rows, row_lo, row_hi, layers, tiles, fit,  \
                                  st);
    LSTM_STACK_CASE(4)
    LSTM_STACK_CASE(8)
    LSTM_STACK_CASE(12)
    LSTM_STACK_CASE(16)
#undef LSTM_STACK_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32 weights and streams, 1 = bf16 weights and streams.
// gates_code: 0 = gates in the stream dtype, 1 = int8 coded.
// h_buf [2, B, H] holds h0 in slot 0 on entry; after `steps` steps the final
// h is in slot steps % 2.  c [B, H] holds c0 on entry and cT on return.
// gates [T, B, 4H] or null (serving).
// Returns a cudaError_t code (0 = launched).
extern "C" int lstm_fwd_layer(const void* zx, const void* wh,
                              const float* bias, const float* mask,
                              float* h_buf, float* c, void* ys, void* cs,
                              void* gates, int steps, int rows, int hidden,
                              int dtype, int gates_code, void* stream) {
  if (!shape_ok(rows, hidden) || (gates_code != 0 && gates_code != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (gates_code == 1)
      return layer_with<float, int8_t>(zx, wh, bias, mask, h_buf, c, ys, cs,
                                       gates, steps, rows, hidden, st);
    return layer_with<float, float>(zx, wh, bias, mask, h_buf, c, ys, cs,
                                    gates, steps, rows, hidden, st);
  }
  if (dtype == 1) {
    if (gates_code == 1)
      return layer_with<bf16, int8_t>(zx, wh, bias, mask, h_buf, c, ys, cs,
                                      gates, steps, rows, hidden, st);
    return layer_with<bf16, bf16>(zx, wh, bias, mask, h_buf, c, ys, cs,
                                  gates, steps, rows, hidden, st);
  }
  return cudaErrorInvalidValue;
}

// 1 where lstm_fwd_persist and lstm_bwd_persist take (rows, hidden, dtype).
extern "C" int lstm_persist_ok(int rows, int hidden, int dtype) {
  return pc::persist_ok(rows, hidden, dtype) ? 1 : 0;
}

// The persistent kernel (bf16 only): zx [T, B, 4H], wh [H, 4H], bias [4H],
// mask [T, B], h0/c0 [B, H] fp32 (read only); ys/cs [T, B, H]; gates
// [T, B, 4H] (gates_code 0: bf16, 1: int8) or null; hT/cT [B, H] fp32;
// xh: 2 x 32 ceil(B / 32) x H bf16 of scratch.
extern "C" int lstm_fwd_persist(const void* zx, const void* wh,
                                const float* bias, const float* mask,
                                const float* h0, const float* c0, void* ys,
                                void* cs, void* gates, float* hT, float* cT,
                                void* xh, int steps, int rows, int hidden,
                                int dtype, int gates_code, void* stream) {
  if (!pc::persist_ok(rows, hidden, dtype) || steps < 0 ||
      (gates_code != 0 && gates_code != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gates_code == 1)
    return persist<int8_t>(zx, wh, bias, mask, h0, c0, ys, cs, gates, hT, cT,
                           xh, steps, rows, hidden, st);
  return persist<bf16>(zx, wh, bias, mask, h0, c0, ys, cs, gates, hT, cT, xh,
                       steps, rows, hidden, st);
}

// How many clusters of the persistent forward kernel at this hidden size
// the card runs at once (cudaOccupancyMaxActiveClusters; -1 on error).
extern "C" int lstm_fwd_persist_clusters(int hidden) {
  if (!pc::persist_ok(1, hidden, 1)) return -1;
  switch (hidden / pc::kUnits) {
    case 4:
      return pc::max_clusters(lstm_fwd_persist_kernel<4, bf16>, 4,
                              FwdSmem<4, bf16>::kBytes);
    case 8:
      return pc::max_clusters(lstm_fwd_persist_kernel<8, bf16>, 8,
                              FwdSmem<8, bf16>::kBytes);
    case 12:
      return pc::max_clusters(lstm_fwd_persist_kernel<12, bf16>, 12,
                              FwdSmem<12, bf16>::kBytes);
    case 16:
      return pc::max_clusters(lstm_fwd_persist_kernel<16, bf16>, 16,
                              FwdSmem<16, bf16>::kBytes);
  }
  return -1;
}

// Whole stack of L >= 2 layers: zx [T, B, 4H] (layer 0), wx_rest
// [L-1, H, 4H], wh [L, H, 4H], bias [L, 4H], mask [T, B]; h_buf
// [2, L, B, H] with h0 in slot 0; c [L, B, H]; ys/cs [L, T, B, H]; gates
// [L, T, B, 4H] or null.
extern "C" int lstm_fwd_stack(const void* zx, const void* wx_rest,
                              const void* wh, const float* bias,
                              const float* mask, float* h_buf, float* c,
                              void* ys, void* cs, void* gates, int steps,
                              int rows, int hidden, int layers, int dtype,
                              void* stream) {
  if (!shape_ok(rows, hidden) || layers < 2) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stack_with<float>(zx, wx_rest, wh, bias, mask, h_buf, c, ys, cs,
                             gates, steps, rows, hidden, layers, st);
  if (dtype == 1)
    return stack_with<bf16>(zx, wx_rest, wh, bias, mask, h_buf, c, ys, cs,
                            gates, steps, rows, hidden, layers, st);
  return cudaErrorInvalidValue;
}

// 1 where lstm_fwd_stack_persist and lstm_bwd_stack_persist take (rows,
// hidden, layers, dtype).
extern "C" int lstm_stack_persist_ok(int rows, int hidden, int layers,
                                     int dtype) {
  return pc::stack_persist_ok(rows, hidden, layers, dtype) ? 1 : 0;
}

// How many 32-row tiles one launch of the persistent stack forward holds
// at (hidden, layers): its 2L - 1 clusters a tile must all be resident
// (cudaOccupancyMaxActiveClusters; 0: none fits, -1: not its route).
extern "C" int lstm_fwd_stack_persist_tiles(int hidden, int layers) {
  if (!pc::stack_persist_ok(1, hidden, layers, 1)) return -1;
  int fit = 0;
  if (stack_persist(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, 0, 0, 0, 0, hidden, layers, 0,
                    &fit, nullptr) != cudaSuccess)
    return -1;
  return fit;
}

// The persistent stack (bf16 only), rows [row_lo, row_hi) of the batch in
// one cooperative launch of ceil((row_hi - row_lo) / 32) row tiles: zx
// [T, B, 4H], wx_rest [L-1, H, 4H], wh [L, H, 4H], bias [L, 4H], mask
// [T, B], h0/c0 [L, B, H] fp32 (read only); ys/cs [L, T, B, H]; gates
// [L, T, B, 4H] or null; hT/cT [L, B, H] fp32.  Scratch: xh 2 L tiles 32 H
// bf16, ring (L - 1) tiles 4 32 4H fp32, step flags (2L - 1) tiles H / 32
// uint32, zero on entry (one set per launch).  A launch the card cannot
// hold at once is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int lstm_fwd_stack_persist(
    const void* zx, const void* wx_rest, const void* wh, const float* bias,
    const float* mask, const float* h0, const float* c0, void* ys, void* cs,
    void* gates, float* hT, float* cT, void* xh, void* ring,
    unsigned* flags, int steps, int rows, int row_lo, int row_hi,
    int hidden, int layers, int dtype, void* stream) {
  if (!pc::stack_persist_ok(rows, hidden, layers, dtype) || steps < 0 ||
      row_lo < 0 || row_hi > rows || row_lo >= row_hi)
    return cudaErrorInvalidValue;
  const int tiles = (row_hi - row_lo + pc::kRows - 1) / pc::kRows;
  int fit = 0;
  return stack_persist(zx, wx_rest, wh, bias, mask, h0, c0, ys, cs, gates,
                       hT, cT, xh, ring, flags, steps, rows, row_lo,
                       row_hi, hidden, layers, tiles, &fit,
                       static_cast<cudaStream_t>(stream));
}
