// Forward LSTM recurrence kernels for Hopper (sm_90a), plain C interface.
//
// Replace the two TPU forward kernels of the JAX package:
//   * fewshot/ops/lstm_pallas.py `_fwd_kernel`  -> lstm_fwd_layer (one layer)
//   * fewshot/ops/lstm_fused.py  `_fwd_kernel`  -> lstm_fwd_stack (all layers
//     advance inside one time step; layers >= 1 project their input here)
//
// Per time step and layer, one launch of `lstm_step_kernel` computes
//   z = zx[t] (layer 0) or x_t . Wx (layers >= 1)  +  h_{t-1} . Wh  +  b
// in fp32, applies the TF gates (i, j, f, o) with the +1 forget bias and the
// masked carry (a PAD step holds h and c), and writes the fp32 state and the
// ys/cs streams.  In train mode (a non-null `gates`) it also writes the gate
// activations (sigmoid i, tanh j, sigmoid(f + 1), sigmoid o) of every step,
// PAD steps included, in the stream dtype: the backward kernels
// (lstm_bwd.cu) read them instead of recomputing z.  Serving passes null and
// writes nothing more.  The product operands are rounded to the weight dtype first
// (bf16 or fp32) and the products are summed in fp32, as the TPU kernels do
// with preferred_element_type=float32.
//
// Design.  The TPU kernel keeps Wh resident in VMEM and walks time inside
// one program.  An SM cannot hold Wh (2 MB at H=512 bf16), so here a block
// owns a tile of ROWS batch rows and UNITS hidden units and computes all
// four gate columns of those units, which keeps the cell update local to the
// block.  Blocks of one step share nothing, so a step is one launch: the
// launch boundary is the grid-wide barrier between steps.  h ping-pongs
// between two fp32 buffers in device memory; c is updated in place (only
// its owning thread reads it).
//
// A block stages the whole contraction at once: its h rows and its Wh
// columns go to shared memory with cp.async (all copies in flight together,
// so one step pays the L2 latency once), then each thread sums its
// products.  Small batches (the state-mode support pass has 16 rows) use
// narrow unit tiles and split the contraction over KSPLIT thread groups, so
// that about one block runs on every SM.
//
// Bound.  At the serving shapes a step is small (160 or 16 rows), so the
// kernel is bound by per-step latency (launch, the L2 reads of Wh, the fp32
// FMA loop), far above its device-memory or tensor-core bound.  A
// persistent kernel with a grid barrier (Wh resident in shared memory across
// steps) and tensor-core products are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kPad = 4;             // floats of padding per staged h row
// shared memory a block may use; ops/lstm_layer.py max_hidden mirrors it
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

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Tile shape of a block: ROWS rows x UNITS hidden units (4 * UNITS gate
// columns), the contraction split over KSPLIT thread groups.  Each thread
// owns one unit, two rows (rp and rp + ROWS / 2) and one contraction slice.
template <int ROWS, int UNITS, int KSPLIT>
struct Tile {
  static constexpr int kThreads = (ROWS / 2) * UNITS * KSPLIT;
  template <typename W>
  static size_t smem_bytes(int hidden) {
    const size_t stage = (size_t)ROWS * (hidden + kPad) * sizeof(float) +
                         (size_t)hidden * 4 * UNITS * sizeof(W);
    const size_t reduce = (size_t)KSPLIT * ROWS * UNITS * 4 * sizeof(float);
    return stage > reduce ? stage : reduce;
  }
};

// Stage a [ROWS, H] fp32 operand block and the block's [H, 4 * UNITS] weight
// columns in shared memory; rows past `rows` read as 0.
template <typename W, int ROWS, int UNITS, int THREADS>
__device__ __forceinline__ void stage(const float* __restrict__ a,
                                      const W* __restrict__ w, int rows,
                                      int hidden, int row0, int u0,
                                      float* hs, W* ws) {
  const int tid = threadIdx.x;
  const int pairs = hidden / 2;
  for (int e = tid; e < ROWS * pairs; e += THREADS) {
    const int r = e / pairs, c = e % pairs;
    float* dst = hs + (size_t)r * (hidden + kPad) + 2 * c;
    const int row = row0 + r;
    if (row < rows) {
      cp_async8(dst, a + (size_t)row * hidden + 2 * c);
    } else {
      dst[0] = 0.0f;
      dst[1] = 0.0f;
    }
  }
  // per (k, gate): UNITS contiguous weights, moved in 8-byte pieces
  constexpr int kPieces = UNITS * (int)sizeof(W) / 8;
  const size_t four_h = 4 * (size_t)hidden;
  for (int e = tid; e < hidden * 4 * kPieces; e += THREADS) {
    const int k = e / (4 * kPieces), rem = e % (4 * kPieces);
    const int g = rem / kPieces, p = rem % kPieces;
    const char* src = reinterpret_cast<const char*>(
                          w + (size_t)k * four_h + (size_t)g * hidden + u0) +
                      8 * p;
    char* dst = reinterpret_cast<char*>(ws + ((size_t)k * 4 + g) * UNITS) +
                8 * p;
    cp_async8(dst, src);
  }
  cp_async_wait_all();
  __syncthreads();
}

// acc[i][g] += sum over this thread's k slice of round_W(a[row_i, k]) *
// w[k, g * H + u]
template <typename W, int ROWS, int UNITS, int KSPLIT>
__device__ __forceinline__ void contract(const float* hs, const W* ws,
                                         int hidden, int j, int rp, int ks,
                                         float (&acc)[2][4]) {
  const int kper = hidden / KSPLIT;
  const int kbeg = ks * kper;
  const float* a0 = hs + (size_t)rp * (hidden + kPad);
  const float* a1 = hs + (size_t)(rp + ROWS / 2) * (hidden + kPad);
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
// ys/cs [B, H] and (optional) gates [B, 4H] in the stream dtype.
template <typename W, typename S, int ROWS, int UNITS, int KSPLIT>
__global__ void __launch_bounds__(Tile<ROWS, UNITS, KSPLIT>::kThreads)
    lstm_step_kernel(const S* __restrict__ zx, const float* __restrict__ x,
                     const W* __restrict__ wx, const W* __restrict__ wh,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     const float* __restrict__ h_prev,
                     float* __restrict__ h_next, float* __restrict__ c,
                     S* __restrict__ ys, S* __restrict__ cs,
                     S* __restrict__ gates, int rows, int hidden) {
  constexpr int kThreads = Tile<ROWS, UNITS, KSPLIT>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  W* ws = reinterpret_cast<W*>(smem + (size_t)ROWS * (hidden + kPad) *
                                          sizeof(float));
  const int u0 = blockIdx.x * UNITS;
  const int row0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int j = tid % UNITS;
  const int rp = (tid / UNITS) % (ROWS / 2);
  const int ks = tid / (UNITS * (ROWS / 2));

  float acc[2][4] = {};
  if (x != nullptr) {
    stage<W, ROWS, UNITS, kThreads>(x, wx, rows, hidden, row0, u0, hs, ws);
    contract<W, ROWS, UNITS, KSPLIT>(hs, ws, hidden, j, rp, ks, acc);
    __syncthreads();  // the h stage below overwrites hs/ws
  }
  stage<W, ROWS, UNITS, kThreads>(h_prev, wh, rows, hidden, row0, u0, hs,
                                  ws);
  contract<W, ROWS, UNITS, KSPLIT>(hs, ws, hidden, j, rp, ks, acc);

  if (KSPLIT > 1) {  // sum the contraction slices in slice order
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();
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
      S* g = gates + (size_t)row * four_h + u;
      g[0] = from_float<S>(si);
      g[hidden] = from_float<S>(tj);
      g[2 * (size_t)hidden] = from_float<S>(sf);
      g[3 * (size_t)hidden] = from_float<S>(so);
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
template <typename W, typename S, int ROWS, int UNITS, int KSPLIT>
struct StepLauncher {
  using T = Tile<ROWS, UNITS, KSPLIT>;
  size_t smem = 0;

  cudaError_t prepare(int hidden) {
    smem = T::template smem_bytes<W>(hidden);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(
        lstm_step_kernel<W, S, ROWS, UNITS, KSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }

  cudaError_t launch(const S* zx, const float* x, const W* wx, const W* wh,
                     const float* bias, const float* mask,
                     const float* h_prev, float* h_next, float* c, S* ys,
                     S* cs, S* gates, int rows, int hidden,
                     cudaStream_t stream) const {
    const dim3 grid(hidden / UNITS, (rows + ROWS - 1) / ROWS);
    lstm_step_kernel<W, S, ROWS, UNITS, KSPLIT>
        <<<grid, T::kThreads, smem, stream>>>(zx, x, wx, wh, bias, mask,
                                              h_prev, h_next, c, ys, cs,
                                              gates, rows, hidden);
    return cudaGetLastError();
  }
};

template <typename W, typename S, typename L>
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
  S* gates = static_cast<S*>(gates_v);
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
// most 16 rows (or hidden sizes whose wide tile does not fit in shared
// memory) take 16-row tiles of 4 units with the contraction split 8 ways.
using WideF = StepLauncher<float, float, 32, 8, 2>;
using NarrowF = StepLauncher<float, float, 16, 4, 8>;
using WideB = StepLauncher<__nv_bfloat16, __nv_bfloat16, 32, 8, 2>;
using NarrowB = StepLauncher<__nv_bfloat16, __nv_bfloat16, 16, 4, 8>;

template <typename W>
bool use_wide(int rows, int hidden) {
  return rows > 16 &&
         Tile<32, 8, 2>::smem_bytes<W>(hidden) <= (size_t)kMaxSmem;
}

bool shape_ok(int rows, int hidden) {
  return rows > 0 && hidden > 0 && hidden % 32 == 0;
}

}  // namespace

// dtype: 0 = fp32 weights and streams, 1 = bf16 weights and streams.
// h_buf [2, B, H] holds h0 in slot 0 on entry; after `steps` steps the final
// h is in slot steps % 2.  c [B, H] holds c0 on entry and cT on return.
// gates [T, B, 4H] or null (serving).
// Returns a cudaError_t code (0 = launched).
extern "C" int lstm_fwd_layer(const void* zx, const void* wh,
                              const float* bias, const float* mask,
                              float* h_buf, float* c, void* ys, void* cs,
                              void* gates, int steps, int rows, int hidden,
                              int dtype, void* stream) {
  if (!shape_ok(rows, hidden)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (use_wide<float>(rows, hidden)) {
      WideF l;
      return run_layer_with<float, float>(l, zx, wh, bias, mask, h_buf, c,
                                          ys, cs, gates, steps, rows, hidden,
                                          st);
    }
    NarrowF l;
    return run_layer_with<float, float>(l, zx, wh, bias, mask, h_buf, c, ys,
                                        cs, gates, steps, rows, hidden, st);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    if (use_wide<B>(rows, hidden)) {
      WideB l;
      return run_layer_with<B, B>(l, zx, wh, bias, mask, h_buf, c, ys, cs,
                                  gates, steps, rows, hidden, st);
    }
    NarrowB l;
    return run_layer_with<B, B>(l, zx, wh, bias, mask, h_buf, c, ys, cs,
                                gates, steps, rows, hidden, st);
  }
  return cudaErrorInvalidValue;
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
  if (dtype == 0) {
    if (use_wide<float>(rows, hidden)) {
      WideF l;
      return run_stack_with<float, float>(l, zx, wx_rest, wh, bias, mask,
                                          h_buf, c, ys, cs, gates, steps,
                                          rows, hidden, layers, st);
    }
    NarrowF l;
    return run_stack_with<float, float>(l, zx, wx_rest, wh, bias, mask,
                                        h_buf, c, ys, cs, gates, steps, rows,
                                        hidden, layers, st);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    if (use_wide<B>(rows, hidden)) {
      WideB l;
      return run_stack_with<B, B>(l, zx, wx_rest, wh, bias, mask, h_buf, c,
                                  ys, cs, gates, steps, rows, hidden, layers,
                                  st);
    }
    NarrowB l;
    return run_stack_with<B, B>(l, zx, wx_rest, wh, bias, mask, h_buf, c,
                                ys, cs, gates, steps, rows, hidden, layers,
                                st);
  }
  return cudaErrorInvalidValue;
}
