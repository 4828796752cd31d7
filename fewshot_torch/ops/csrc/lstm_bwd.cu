// Backward (BPTT) LSTM recurrence kernels for Hopper (sm_90a), plain C
// interface.
//
// Replace the two TPU backward kernels of the JAX package:
//   * fewshot/ops/lstm_pallas.py `_bwd_kernel`  -> lstm_bwd_persist (bf16,
//     H = 128..512 in steps of 128: one launch a call) and lstm_bwd_layer
//     (fp32, and bf16 past that width: one launch per time step)
//   * fewshot/ops/lstm_fused.py  `_bwd_kernel`  -> lstm_bwd_stack_persist
//     (bf16, the forward's route: a layer wavefront, top layer ahead) and
//     lstm_bwd_stack (fp32 and every other stack: all layers of one time
//     step, top layer first, one launch each)
//
// Time runs in reverse.  With the forward's saved gate activations g_t =
// (sigmoid i, tanh j, sigmoid(f + 1), sigmoid o) and cell streams, step t
// computes, per row and hidden unit (mf = mask[t]):
//   dh  = ext_t + dh_c               ext_t = dys[t] (top layer) or, in the
//                                    stack, dz_{l+1,t} . Wx_{l+1}^T
//   d_new_h = mf dh,  d_new_c = d_new_h so (1 - tanh(c_t)^2) + mf dc
//   dz_t = (d_new_c tj si (1-si), d_new_c si (1-tj^2),
//           d_new_c c_{t-1} sf (1-sf), d_new_h tanh(c_t) so (1-so))
//   dh_c <- round(dz_t) . Wh^T + (1 - mf) dh,  dc <- d_new_c sf + (1 - mf) dc
// exactly as the Pallas kernels do: c_{t-1} and tanh(c_t) come from the
// stream-dtype cs (c0 in fp32 at t = 0), dz is stored in the stream dtype
// (dzx) and rounded to the weight dtype for the products, which sum in fp32.
// The per-layer kernels also read int8-coded gates (gates code 1,
// lstm_pallas.py's FEWSHOT_LSTM_GATES_INT8 branch): g = q / 127, then
// (g + 1) / 2 for the sigmoids.  db is summed in the kernels from the
// unrounded fp32 dz, as per-row-block partials that the caller adds up;
// dWh and dWx are bulk products over the saved streams, outside.
//
// The step kernels (lstm_bwd_step_kernel).  The dependency per step is the
// whole dz_{t+1} [rows, 4H] row contracted with Wh^T.  As in the forward
// (lstm_fwd.cu), one launch runs one step (and one layer), and the launch
// boundary is the grid barrier.  A block owns ROWS rows and UNITS hidden
// units: it walks the 4H columns of its rows of dz_{t+1} and of its units'
// Wh rows in chunks (256 or 1024) through a two-slot cp.async ring (so its shared
// memory is the same at every H, and any H % 32 == 0 runs), forms dh for
// its units (the contraction split over KSPLIT thread groups, fp32 SIMT),
// then the four gate deltas of its units, written to dzx[t].  The carried fp32 dh and dc
// live in device memory.  A last launch per layer contracts dz_0 for dh0.
// At 160 rows x 96 steps, H=512, a step costs ~56 us, ~1 us of it the
// launch: the per-step L2 reads and the SIMT products bound it.
//
// The persistent kernel (lstm_bwd_persist_kernel, lstm_cluster.cuh).  A
// row tile of 32 rows runs on one cluster of NB = H / 32 blocks for all
// steps; block j keeps the same resident Wh[:, C_j] slice as the forward.
// Step t: block j forms dz[rows, C_j] from its own units' gates, cs, dh and
// dc, writes dzx and adds the unrounded dz to its db in registers, then the
// partial dh_j[rows, :] = bf16(dz[rows, C_j]) . Wh[:, C_j]^T on mma.sync (the
// slice read as B = Wh^T).  A reduce-scatter sends the [rows, U_k] slice of
// that partial to block k through L2 (a scratch buffer, ordered by the
// cluster barrier); block k sums the NB partials in the fixed order
// j = 0..NB-1 and adds (1 - mf) dh: no float atomics, the same bits on
// every launch.  The exchange (64 KB of fp32 partials written and read by
// every SM a step at H=512) and the barrier bound it.
//
// The persistent stack (lstm_bwd_stack_persist_kernel) is the forward's
// wavefront run backwards: recurrence stage l (Wh_l resident) is the body
// above, the top layer's fed by dys; projection stage l >= 1 (Wx_l[:, C_j]
// resident) forms bf16(dz_l[t][rows, C_j]) . Wx_l[:, C_j]^T from the bf16
// dzx stream, reduce-scatters it in its own cluster, and the owner of
// units U_k sums the NB slices in block order into a ring that recurrence
// stage l-1 reads as its dh from above (4 KB a block a step, where reading
// the NB partials itself would double that stage's exchange).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_cluster.cuh"

namespace {

// shared memory a block may use
constexpr int kMaxSmem = 227 * 1024;
constexpr int kPadBytes = 16;       // padding per staged row
constexpr int kStages = 2;          // chunks in flight

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

// A saved gate back to its activation: the stream dtype as stored; int8
// decoded, g = q / 127, then (g + 1) / 2 for a sigmoid (rounded at the same
// points as lstm_pallas.py, never fused into an FMA)
template <typename G>
__device__ __forceinline__ float gate_in(G v, bool sig) {
  return to_float(v);
}
template <>
__device__ __forceinline__ float gate_in<int8_t>(int8_t v, bool sig) {
  const float g = __fmul_rn(static_cast<float>(v), 1.0f / 127.0f);
  return sig ? __fmul_rn(__fadd_rn(g, 1.0f), 0.5f) : g;
}

// a . w over one 16-byte piece of each, into two partial sums
__device__ __forceinline__ void dot16(const uint4& a, const uint4& w,
                                      float& s0, float& s1, float) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&w);
  s0 = fmaf(x.x, y.x, s0);
  s1 = fmaf(x.y, y.y, s1);
  s0 = fmaf(x.z, y.z, s0);
  s1 = fmaf(x.w, y.w, s1);
}

__device__ __forceinline__ void dot16(const uint4& a, const uint4& w,
                                      float& s0, float& s1, __nv_bfloat16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 xf = __bfloat1622float2(x[p]);
    const float2 yf = __bfloat1622float2(y[p]);
    s0 = fmaf(xf.x, yf.x, s0);
    s1 = fmaf(xf.y, yf.y, s1);
  }
}

// Tile of a block: ROWS rows x UNITS hidden units, the 4H-deep contraction
// split over KSPLIT thread groups.  Each thread owns one unit, two rows (rp
// and rp + ROWS / 2) and one contraction slice of every chunk.  A ring slot
// holds one chunk: kChunk columns of the 4H contraction for the block's
// ROWS operand rows and UNITS weight rows, so shared memory does not grow
// with H.
template <typename T, int ROWS, int UNITS, int KSPLIT>
struct BwdTile {
  static constexpr int kThreads = (ROWS / 2) * UNITS * KSPLIT;
  // narrow tiles (one block an SM) stage 1024 columns at once, wide ones
  // 256, which lets three blocks share an SM
  static constexpr int kChunk = ROWS <= 16 ? 1024 : 256;
  static constexpr int kStride = kChunk + kPadBytes / (int)sizeof(T);
  __host__ __device__ static constexpr size_t slot_bytes() {
    return (size_t)(ROWS + UNITS) * kStride * sizeof(T);
  }
  static constexpr size_t smem_bytes() {
    const size_t ring = kStages * slot_bytes();
    const size_t reduce = ((size_t)KSPLIT * ROWS * UNITS * 2 +
                           (size_t)ROWS * UNITS * 4) * sizeof(float);
    return ring > reduce ? ring : reduce;
  }
};

// Stage columns [k0, k0 + kc) of rows [row0, row0 + ROWS) of a [rows, 4H]
// operand (rows past `rows` zero-filled) and of rows [u0, u0 + UNITS) of a
// weight [H, 4H] into one ring slot by cp.async (the caller commits).
template <typename T, int ROWS, int UNITS, int THREADS>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ dz,
                                            const T* __restrict__ w, int rows,
                                            int hidden, int row0, int u0,
                                            int k0, int kc, T* slot) {
  constexpr int kStride = BwdTile<T, ROWS, UNITS, 1>::kStride;
  const int tid = threadIdx.x;
  const int pieces = kc * (int)sizeof(T) / 16;   // per staged row
  const size_t four_h = 4 * (size_t)hidden;
  // unrolled explicitly: left to nvcc, the unroll moved with unrelated code
  // in this file, and kernel 4's time with it
#pragma unroll 4
  for (int e = tid; e < (ROWS + UNITS) * pieces; e += THREADS) {
    const int r = e / pieces, p = e % pieces;
    char* dst = reinterpret_cast<char*>(slot + (size_t)r * kStride) + 16 * p;
    if (r < ROWS) {
      const int row = row0 + r;
      const bool ok = row < rows;
      mma::cp_async16(dst,
                      reinterpret_cast<const char*>(
                          dz + (size_t)(ok ? row : 0) * four_h + k0) +
                          16 * p,
                      ok ? 16 : 0);
    } else {
      mma::cp_async16(dst, reinterpret_cast<const char*>(
                               w + (size_t)(u0 + r - ROWS) * four_h + k0) +
                               16 * p);
    }
  }
}

// acc[i] += sum over this thread's slice of the chunk's kc columns of
// dz[row_i, k] * w[unit, k]
template <typename T, int ROWS, int UNITS, int KSPLIT>
__device__ __forceinline__ void contract(const T* slot, int kc, int j, int rp,
                                         int ks, float (&acc)[2]) {
  constexpr int kStride = BwdTile<T, ROWS, UNITS, KSPLIT>::kStride;
  const int per = kc * (int)sizeof(T) / 16 / KSPLIT;
  const uint4* a0 = reinterpret_cast<const uint4*>(slot + (size_t)rp * kStride);
  const uint4* a1 =
      reinterpret_cast<const uint4*>(slot + (size_t)(rp + ROWS / 2) * kStride);
  const uint4* w =
      reinterpret_cast<const uint4*>(slot + (size_t)(ROWS + j) * kStride);
  float s[2][2] = {};
#pragma unroll 4
  for (int v = ks * per; v < (ks + 1) * per; ++v) {
    const uint4 wv = w[v];
    dot16(a0[v], wv, s[0][0], s[0][1], T());
    dot16(a1[v], wv, s[1][0], s[1][1], T());
  }
  acc[0] += s[0][0] + s[0][1];
  acc[1] += s[1][0] + s[1][1];
}

struct StepArgs {
  const void* dz_next;   // [B, 4H] dzx[t + 1] of this layer, or null (t = T-1)
  const void* wh;        // [H, 4H]
  const float* mask_next;  // [B] mask[t + 1] (mask[0] in the final launch)
  const void* dz_up;     // [B, 4H] dzx of the layer above at t, or null
  const void* wx_up;     // [H, 4H] Wx of the layer above
  const void* dys;       // [B, H] output cotangent at t, or null
  const void* gates;     // [B, 4H] at t; null = final launch (dh0 only)
  const void* cs;        // [B, H] at t
  const void* cs_prev;   // [B, H] at t - 1, or null (t = 0: c0)
  const float* c0;       // [B, H]
  const float* mask;     // [B] mask[t]
  float* dh;             // [B, H] carried dh (see lstm_bwd_layer)
  float* dc;             // [B, H] carried dc
  void* dzx;             // [B, 4H] at t (out)
  float* db;             // [4H] this layer's partial of row block 0
  size_t db_stride;      // floats between the partials of two row blocks
  int rows;
  int hidden;
};

template <typename T, typename G, int ROWS, int UNITS, int KSPLIT>
__global__ void __launch_bounds__(BwdTile<T, ROWS, UNITS, KSPLIT>::kThreads)
    lstm_bwd_step_kernel(StepArgs a) {
  using Tile = BwdTile<T, ROWS, UNITS, KSPLIT>;
  constexpr int kThreads = Tile::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hidden = a.hidden;
  const int u0 = blockIdx.x * UNITS;
  const int row0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int j = tid % UNITS;
  const int rp = (tid / UNITS) % (ROWS / 2);
  const int ks = tid / (UNITS * (ROWS / 2));

  // acc[0]: the layer above's dz . Wx^T; acc[1]: this layer's dz_{t+1} . Wh^T.
  // The 4H-deep contractions run as one walk over kChunk-column chunks
  // through a kStages-slot cp.async ring: chunks [0, n_up) of dz_up . Wx^T,
  // then those of dz_next . Wh^T.
  float acc[2][2] = {};
  const T* dz_up = static_cast<const T*>(a.dz_up);
  const T* dz_next = static_cast<const T*>(a.dz_next);
  constexpr int kChunk = Tile::kChunk;
  const int per = (4 * hidden + kChunk - 1) / kChunk;
  const int n_up = dz_up != nullptr ? per : 0;
  const int n_all = n_up + (dz_next != nullptr ? per : 0);
  auto slot = [&](int ch) {
    return reinterpret_cast<T*>(smem + (ch % kStages) * Tile::slot_bytes());
  };
  auto k_first = [&](int ch) { return (ch < n_up ? ch : ch - n_up) * kChunk; };
  auto width = [&](int ch) {
    const int k0 = k_first(ch);
    return 4 * hidden - k0 < kChunk ? 4 * hidden - k0 : kChunk;
  };
  auto issue = [&](int ch) {
    const bool up = ch < n_up;
    stage_chunk<T, ROWS, UNITS, kThreads>(
        up ? dz_up : dz_next,
        static_cast<const T*>(up ? a.wx_up : a.wh), a.rows, hidden, row0, u0,
        k_first(ch), width(ch), slot(ch));
    mma::cp_async_commit();
  };
  if (n_all > 0) issue(0);
#pragma unroll 1
  for (int ch = 0; ch < n_all; ++ch) {
    if (ch + 1 < n_all) {
      issue(ch + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch landed
    float part[2] = {};
    contract<T, ROWS, UNITS, KSPLIT>(slot(ch), width(ch), j, rp, ks, part);
    if (ch < n_up) {            // static indices: acc stays in registers
      acc[0][0] += part[0];
      acc[0][1] += part[1];
    } else {
      acc[1][0] += part[0];
      acc[1][1] += part[1];
    }
    __syncthreads();  // its slot is free for chunk ch + kStages
  }

  float* red = reinterpret_cast<float*>(smem);
  float* dbred = red + (size_t)KSPLIT * ROWS * UNITS * 2;
  if (KSPLIT > 1) {  // sum the contraction slices in slice order
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rp + i * (ROWS / 2);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        red[(((size_t)ks * ROWS + r) * UNITS + j) * 2 + q] = acc[q][i];
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rp + i * (ROWS / 2);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float s = red[((size_t)r * UNITS + j) * 2 + q];
          for (int p = 1; p < KSPLIT; ++p)
            s += red[(((size_t)p * ROWS + r) * UNITS + j) * 2 + q];
          acc[q][i] = s;
        }
      }
    }
  }

  const bool final_launch = a.gates == nullptr;
  const int u = u0 + j;
  const size_t four_h = 4 * (size_t)hidden;
  if (ks == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rp + i * (ROWS / 2);
      const int row = row0 + r;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row < a.rows) {
        const size_t idx = (size_t)row * hidden + u;
        // the carry from step t+1: its product plus its masked-off dh
        float dh_c = a.dh[idx];
        if (dz_next != nullptr)
          dh_c = acc[1][i] + (a.mask_next[row] > 0.0f ? 0.0f : dh_c);
        if (final_launch) {
          a.dh[idx] = dh_c;  // dh0
          continue;
        }
        const float ext = a.dys != nullptr
                              ? to_float(static_cast<const T*>(a.dys)[idx])
                              : acc[0][i];
        const float dh = ext + dh_c;
        const float dc = a.dc[idx];
        const float mf = a.mask[row] > 0.0f ? 1.0f : 0.0f;
        const G* g = static_cast<const G*>(a.gates) + (size_t)row * four_h + u;
        const float si = gate_in(g[0], true);
        const float tj = gate_in(g[hidden], false);
        const float sf = gate_in(g[2 * (size_t)hidden], true);
        const float so = gate_in(g[3 * (size_t)hidden], true);
        const float tc = tanhf(to_float(static_cast<const T*>(a.cs)[idx]));
        const float c_prev =
            a.cs_prev != nullptr
                ? to_float(static_cast<const T*>(a.cs_prev)[idx])
                : a.c0[idx];
        const float d_new_h = mf * dh;
        const float d_new_c = d_new_h * so * (1.0f - tc * tc) + mf * dc;
        d[0] = d_new_c * tj * si * (1.0f - si);
        d[1] = d_new_c * si * (1.0f - tj * tj);
        d[2] = d_new_c * c_prev * sf * (1.0f - sf);
        d[3] = d_new_h * tc * so * (1.0f - so);
        T* out = static_cast<T*>(a.dzx) + (size_t)row * four_h + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * (size_t)hidden] = from_float<T>(d[q]);
        a.dh[idx] = dh;
        a.dc[idx] = d_new_c * sf + (1.0f - mf) * dc;
      }
      if (!final_launch) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dbred[((size_t)r * UNITS + j) * 4 + q] = d[q];
      }
    }
  }
  if (final_launch) return;  // uniform over the block
  __syncthreads();
  // db: this block's rows summed in row order, added to its partial
  if (tid < 4 * UNITS) {
    const int q = tid / UNITS, jj = tid % UNITS;
    float s = 0.0f;
    for (int r = 0; r < ROWS; ++r) s += dbred[((size_t)r * UNITS + jj) * 4 + q];
    a.db[blockIdx.y * a.db_stride + (size_t)q * hidden + u0 + jj] += s;
  }
}

template <typename T, typename G, int ROWS, int UNITS, int KSPLIT>
struct BwdLauncher {
  using Tile = BwdTile<T, ROWS, UNITS, KSPLIT>;
  size_t smem = 0;

  cudaError_t prepare(int) {
    smem = Tile::smem_bytes();
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(lstm_bwd_step_kernel<T, G, ROWS, UNITS, KSPLIT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }

  cudaError_t launch(const StepArgs& a, cudaStream_t stream) const {
    const dim3 grid(a.hidden / UNITS, (a.rows + ROWS - 1) / ROWS);
    lstm_bwd_step_kernel<T, G, ROWS, UNITS, KSPLIT>
        <<<grid, Tile::kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

// Reverse-time loop over `layers` layers (1 = the per-layer kernel).
// Stack layout: gates/dzx [L, T, B, 4H], cs [L, T, B, H], wh [L, H, 4H],
// wx_rest [L-1, H, 4H], c0/dh/dc [L, B, H], db [row blocks, L, 4H]; dys
// [T, B, H] lands on the top layer.
template <typename T, typename G, typename L>
cudaError_t run_with(L& launcher, const void* gates_v, const void* wx_v,
                     const void* wh_v, const float* mask, const void* cs_v,
                     const float* c0, const void* dys_v, float* dh, float* dc,
                     void* dzx_v, float* db, int steps, int rows, int hidden,
                     int layers, cudaStream_t stream) {
  cudaError_t err = launcher.prepare(hidden);
  if (err != cudaSuccess) return err;
  const G* gates = static_cast<const G*>(gates_v);
  const T* wx = static_cast<const T*>(wx_v);
  const T* wh = static_cast<const T*>(wh_v);
  const T* cs = static_cast<const T*>(cs_v);
  const T* dys = static_cast<const T*>(dys_v);
  T* dzx = static_cast<T*>(dzx_v);
  const size_t bh = (size_t)rows * hidden;
  const size_t whh = (size_t)hidden * 4 * hidden;
  const size_t lt = (size_t)steps * bh;           // one layer's [T, B, H]
  for (int t = steps - 1; t >= -1; --t) {
    for (int l = layers - 1; l >= 0; --l) {
      StepArgs a;
      const bool last = t == -1;                  // dh0 = dz_0 . Wh^T + ...
      const int tn = last ? 0 : t + 1;            // the step whose dz flows in
      a.dz_next = (last || t < steps - 1) ? dzx + 4 * ((size_t)l * lt + tn * bh)
                                          : nullptr;
      a.wh = wh + (size_t)l * whh;
      a.mask_next = mask + (size_t)tn * rows;
      a.dz_up = (!last && l < layers - 1)
                    ? dzx + 4 * ((size_t)(l + 1) * lt + (size_t)t * bh)
                    : nullptr;
      a.wx_up = l < layers - 1 ? wx + (size_t)l * whh : nullptr;
      a.dys = (!last && l == layers - 1) ? dys + (size_t)t * bh : nullptr;
      a.gates = last ? nullptr : gates + 4 * ((size_t)l * lt + (size_t)t * bh);
      a.cs = last ? nullptr : cs + (size_t)l * lt + (size_t)t * bh;
      a.cs_prev = (!last && t > 0) ? cs + (size_t)l * lt + (size_t)(t - 1) * bh
                                   : nullptr;
      a.c0 = c0 + (size_t)l * bh;
      a.mask = last ? nullptr : mask + (size_t)t * rows;
      a.dh = dh + (size_t)l * bh;
      a.dc = dc + (size_t)l * bh;
      a.dzx = last ? nullptr : dzx + 4 * ((size_t)l * lt + (size_t)t * bh);
      a.db = db + (size_t)l * 4 * hidden;
      a.db_stride = (size_t)layers * 4 * hidden;
      a.rows = rows;
      a.hidden = hidden;
      err = launcher.launch(a, stream);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// Tile shapes as in the forward: wide batches take 32-row tiles of 8 units;
// batches of at most 16 rows take 16-row tiles of 4 units with the
// contraction split 8 ways.  The
// caller sizes db for 16-row blocks, the narrowest.
bool use_wide(int rows) { return rows > 16; }

template <typename T, typename G>
cudaError_t dispatch(const void* gates, const void* wx_rest, const void* wh,
                     const float* mask, const void* cs, const float* c0,
                     const void* dys, float* dh, float* dc, void* dzx,
                     float* db, int steps, int rows, int hidden, int layers,
                     cudaStream_t st) {
  if (use_wide(rows)) {
    BwdLauncher<T, G, 32, 8, 2> l;
    return run_with<T, G>(l, gates, wx_rest, wh, mask, cs, c0, dys, dh, dc,
                          dzx, db, steps, rows, hidden, layers, st);
  }
  BwdLauncher<T, G, 16, 4, 8> l;
  return run_with<T, G>(l, gates, wx_rest, wh, mask, cs, c0, dys, dh, dc,
                        dzx, db, steps, rows, hidden, layers, st);
}

template <typename G8>
int run(const void* gates, const void* wx_rest, const void* wh,
        const float* mask, const void* cs, const float* c0, const void* dys,
        float* dh, float* dc, void* dzx, float* db, int steps, int rows,
        int hidden, int layers, int dtype, void* stream) {
  if (steps < 0 || rows <= 0 || hidden <= 0 || hidden % 32 || layers < 1)
    return cudaErrorInvalidValue;
  if (steps == 0) return cudaSuccess;      // dh0 = dhT, dc0 = dcT
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // G8 = int8_t: int8-coded gates; void: gates in the stream dtype
  constexpr bool coded = !std::is_void<G8>::value;
  using GF = typename std::conditional<coded, int8_t, float>::type;
  using GB = typename std::conditional<coded, int8_t, __nv_bfloat16>::type;
  if (dtype == 0)
    return dispatch<float, GF>(gates, wx_rest, wh, mask, cs, c0, dys, dh, dc,
                               dzx, db, steps, rows, hidden, layers, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, GB>(gates, wx_rest, wh, mask, cs, c0, dys,
                                       dh, dc, dzx, db, steps, rows, hidden,
                                       layers, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The persistent bf16 kernels
// ---------------------------------------------------------------------------

namespace pc = lstm_cluster;
using bf16 = __nv_bfloat16;

constexpr size_t kSlice = (size_t)pc::kRows * pc::kUnits;  // [32][32] fp32

// Shared memory of a block at H = 32 NB: the resident slice, its bf16 dz
// tile (the product's A operand, columns in the slice's order) and the
// [rows][128] fp32 scratch of the last db reduction.
template <int NB>
struct BwdSmem {
  static constexpr int kHidden = NB * pc::kUnits;
  static constexpr size_t kWs = (size_t)kHidden * pc::kWsPitch * 2;
  static constexpr size_t kD = (size_t)pc::kRows * pc::kWsPitch * 2;
  static constexpr size_t kPart = (size_t)pc::kRows * pc::kCols * 4;
  static constexpr size_t kBytes = kWs + kD + kPart;
  static_assert(kBytes <= (size_t)kMaxSmem, "backward slice does not fit");
};

// Four consecutive saved gates of one kind: bf16 (8 bytes) or int8 (4).
template <typename G>
struct Gate4 {
  using V = uint2;
};
template <>
struct Gate4<int8_t> {
  using V = uint32_t;
};

// Entry e of four packed bf16, as fp32 (a bf16 is the top half of its
// fp32)
__device__ __forceinline__ float bf16_at(uint2 v, int e) {
  const uint32_t w = e < 2 ? v.x : v.y;
  return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}
__device__ __forceinline__ float gate4_at(uint2 v, int e, bool sig) {
  return bf16_at(v, e);
}
__device__ __forceinline__ float gate4_at(uint32_t v, int e, bool sig) {
  return gate_in(static_cast<int8_t>(static_cast<uint8_t>(v >> (8 * e))),
                 sig);
}
__device__ __forceinline__ float component(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One step's inputs of a thread's four (row, unit) pairs.
template <typename G>
struct StepIn {
  typename Gate4<G>::V g[4];
  uint2 cs, cs_prev, dys;
  float m;
};

// Load step t's inputs for row `row`, units u..u+3 (dys: where kDys);
// zeros where the row is padding.
template <bool kDys, typename G>
__device__ __forceinline__ void load_step(StepIn<G>& in, const G* gates,
                                          const float* mask, const bf16* cs,
                                          const bf16* dys, int t, int row,
                                          bool valid, int rows, int hidden,
                                          int u) {
  using V = typename Gate4<G>::V;
  if (!valid) {
    for (int g = 0; g < 4; ++g) in.g[g] = V{};
    in.cs = in.cs_prev = in.dys = make_uint2(0, 0);
    in.m = 0.f;
    return;
  }
  const size_t rs = (size_t)t * rows + row;
  const G* gp = gates + rs * 4 * hidden + u;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    in.g[g] = *reinterpret_cast<const V*>(gp + (size_t)g * hidden);
  in.cs = *reinterpret_cast<const uint2*>(cs + rs * hidden + u);
  in.cs_prev = t > 0 ? *reinterpret_cast<const uint2*>(
                           cs + (rs - rows) * hidden + u)
                     : make_uint2(0, 0);
  if constexpr (kDys)
    in.dys = *reinterpret_cast<const uint2*>(dys + rs * hidden + u);
  in.m = mask[rs];
}

// The partial bf16(dz[rows, C_j]) . W[:, C_j]^T of the block's 128 columns
// over all H units: dtile holds bf16(dz) [32][kWsPitch] with the columns in
// the slice's order, ws the resident slice, read as B = W^T[k = column,
// n = unit] (ldmatrix).  Warp w owns units [w H / 8, (w + 1) H / 8) (its
// H / 64 n-fragments) for both 16-row m tiles and the whole 128-deep
// contraction, on mma.sync.
template <int H>
__device__ __forceinline__ void partial_product(const bf16* dtile,
                                                const bf16* ws,
                                                float (&acc)[2][H / 64][4]) {
  constexpr int NF = H / 64;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = warp * (H / 8);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < pc::kCols; k0 += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      mma::ldsm_x4(af[m], dtile + (16 * m + mma::a_row(lane)) * pc::kWsPitch +
                              k0 + mma::a_col(lane));
#pragma unroll
    for (int pr = 0; pr < NF / 2; ++pr) {
      uint32_t bfr[4];
      mma::ldsm_x4(bfr, ws + (size_t)(n0 + 16 * pr + mma::bn_row(lane)) *
                                 pc::kWsPitch +
                             k0 + mma::bn_col(lane));
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma::mma_bf16(acc[m][2 * pr], af[m], bfr[0], bfr[1]);
        mma::mma_bf16(acc[m][2 * pr + 1], af[m], bfr[2], bfr[3]);
      }
    }
  }
}

// The reduce-scatter's sends: the [rows, U_k] slice of the partial to
// owner k, at dst + k NB kSlice (dst: this sender's slot of owner 0's
// region of an exchange half [NB owners][NB senders][32][32] fp32), in
// 16-byte pieces (4 units of one row); lane pairs swap halves so each holds
// four consecutive columns.
template <int H>
__device__ __forceinline__ void scatter_partials(
    const float (&acc)[2][H / 64][4], float* dst) {
  constexpr int NB = H / pc::kUnits, NF = H / 64;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = warp * (H / 8);
  const int gl = lane / 4, tl = lane % 4;
  const bool odd = tl & 1;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float* v = acc[m][f];
      const float sx = odd ? v[0] : v[2], sy = odd ? v[1] : v[3];
      const float ox = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float oy = __shfl_xor_sync(0xffffffffu, sy, 1);
      const uint4 piece =
          odd ? make_uint4(__float_as_uint(ox), __float_as_uint(oy),
                           __float_as_uint(v[2]), __float_as_uint(v[3]))
              : make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                           __float_as_uint(ox), __float_as_uint(oy));
      const int pr_row = 16 * m + gl + (odd ? 8 : 0);
      const int n = n0 + 8 * f + 2 * (tl & ~1);
      __stcg(reinterpret_cast<uint4*>(dst + (size_t)(n / pc::kUnits) * NB *
                                                kSlice +
                                      pr_row * pc::kUnits + n % pc::kUnits),
             piece);
    }
}

// The owner's sum of the NB slices sent to it, in sender order j = 0..NB-1
// (no atomics: the same bits on every launch): src points at sender 0's
// slice, this thread's row and first unit.
template <int NB>
__device__ __forceinline__ float4 gather_partials(const float* src) {
  float4 p[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    p[j] = __ldcg(reinterpret_cast<const float4*>(src + j * kSlice));
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    s.x += p[j].x, s.y += p[j].y, s.z += p[j].z, s.w += p[j].w;
  return s;
}

// One BPTT recurrence: the 32-row tile [row0, row0 + 32) of one layer (rows
// from row_hi on are padding) for all T steps in reverse, on one cluster of
// NB blocks.  gates [T, B, 4H] in G, cs [T, B, H] bf16, c0/dhT/dcT/dh0/dc0
// [B, H] fp32, dzx [T, B, 4H] bf16 (out), db [4H] fp32 (out: this tile's
// partial).  The dh arriving from above is the bf16 stream dys [T, B, H],
// or (kRing) the fp32 ring [kRingDepth][NB][256] float4 a projection stage
// fills, once its flags (ring_ready) say the step is there.  done: this
// stage's flags, published after each reverse step (dzx of the step
// written, the ring slot read), or null.
template <typename G>
struct BwdRec {
  const G* gates;
  const bf16* wh;
  const float* mask;
  const bf16* cs;
  const float* c0;
  const bf16* dys;
  const float4* ring;
  const unsigned* ring_ready;
  unsigned* done;
  const float* dhT;
  const float* dcT;
  float* dh0;
  float* dc0;
  bf16* dzx;
  float* db;
  float* xtile;    // the dh partials' exchange: 2 halves, `half` apart
  size_t half;
  int steps, rows, row0, row_hi;
};

// The reduce-scatter goes through L2: each sender writes its [rows, U_k]
// slices into the owners' regions of the step's half of the exchange, a
// cluster barrier (release / acquire) orders them, and each owner reads its
// NB slices back (ld.global.cg); pushed into the peers' shared memory with
// st.shared::cluster instead, the same bytes took longer than the rest of
// the step.  The halves alternate by step, so one barrier a step suffices:
// a half is written again only after every block passed the barrier that
// follows its reads.
//
// Cell phase: thread tid owns row tid / 8 of the tile and units 4 (tid % 8)
// .. + 3 of the block.  Product phase: partial_product.
template <int NB, typename G, bool kRing>
__device__ __forceinline__ void bwd_recurrence(const BwdRec<G>& a,
                                               unsigned char* smem) {
  using Sm = BwdSmem<NB>;
  constexpr int H = Sm::kHidden;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* dtile = reinterpret_cast<bf16*>(smem + Sm::kWs);
  float* part = reinterpret_cast<float*>(smem + Sm::kWs + Sm::kD);
  const int steps = a.steps, rows = a.rows;
  const unsigned me = pc::rank();
  const int u0 = me * pc::kUnits;
  const int tid = threadIdx.x;
  const int r = tid / 8, i0 = 4 * (tid % 8);  // cell phase: row, first unit
  const int row = a.row0 + r;
  const bool valid = row < a.row_hi;
  const size_t sidx = (size_t)row * H + u0 + i0;

  pc::stage_slice(a.wh, H, u0, ws);
  float dh_c[4], dc[4], keep[4] = {}, c0v[4], dbs[4][4] = {};
  {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 p = valid ? *reinterpret_cast<const float4*>(a.dhT + sidx) : z;
    const float4 q = valid ? *reinterpret_cast<const float4*>(a.dcT + sidx) : z;
    const float4 c = valid ? *reinterpret_cast<const float4*>(a.c0 + sidx) : z;
    dh_c[0] = p.x, dh_c[1] = p.y, dh_c[2] = p.z, dh_c[3] = p.w;
    dc[0] = q.x, dc[1] = q.y, dc[2] = q.z, dc[3] = q.w;
    c0v[0] = c.x, c0v[1] = c.y, c0v[2] = c.z, c0v[3] = c.w;
  }
  StepIn<G> cur{}, nxt{};
  float4 ext_cur = make_float4(0.f, 0.f, 0.f, 0.f), ext_nxt = ext_cur;
  // step t's inputs; from the ring, reverse step steps - 1 - t
  auto load = [&](StepIn<G>& in, float4& ext, int t) {
    load_step<!kRing>(in, a.gates, a.mask, a.cs, a.dys, t, row, valid, rows,
                      H, u0 + i0);
    if constexpr (kRing) {
      const int s = steps - 1 - t;
      pc::wait_for<NB>(a.ring_ready, s + 1);
      ext = __ldcg(a.ring + ((size_t)(s % pc::kRingDepth) * NB + me) *
                                pc::kThreads + tid);
    }
  };
  if (steps > 0) load(cur, ext_cur, steps - 1);
  mma::cp_async_wait<0>();
  __syncthreads();

  // dh_c = the partials of step t + 1 (exchange half (t + 1) % 2), in block
  // order, + (1 - mf) dh
  auto gather = [&](int t) {
    const float4 p = gather_partials<NB>(
        a.xtile + ((t + 1) & 1) * a.half + (size_t)me * NB * kSlice +
        (size_t)r * pc::kUnits + i0);
    dh_c[0] = p.x + keep[0], dh_c[1] = p.y + keep[1];
    dh_c[2] = p.z + keep[2], dh_c[3] = p.w + keep[3];
  };

  for (int t = steps - 1; t >= 0; --t) {
    if (t < steps - 1) gather(t);
    if (t > 0) load(nxt, ext_nxt, t - 1);
    // the cell's backward for this thread's four pairs
    const float mf = cur.m > 0.0f ? 1.0f : 0.0f;
    float d[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float si = gate4_at(cur.g[0], e, true);
      const float tj = gate4_at(cur.g[1], e, false);
      const float sf = gate4_at(cur.g[2], e, true);
      const float so = gate4_at(cur.g[3], e, true);
      const float tc = tanhf(bf16_at(cur.cs, e));
      const float c_prev = t > 0 ? bf16_at(cur.cs_prev, e) : c0v[e];
      const float ext = kRing ? component(ext_cur, e) : bf16_at(cur.dys, e);
      const float dh = ext + dh_c[e];
      const float d_new_h = mf * dh;
      const float d_new_c = d_new_h * so * (1.0f - tc * tc) + mf * dc[e];
      d[0][e] = d_new_c * tj * si * (1.0f - si);
      d[1][e] = d_new_c * si * (1.0f - tj * tj);
      d[2][e] = d_new_c * c_prev * sf * (1.0f - sf);
      d[3][e] = d_new_h * tc * so * (1.0f - so);
      keep[e] = (1.0f - mf) * dh;
      dc[e] = d_new_c * sf + (1.0f - mf) * dc[e];
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint2 packed = make_uint2(mma::pack_bf16(d[g][0], d[g][1]),
                                      mma::pack_bf16(d[g][2], d[g][3]));
      *reinterpret_cast<uint2*>(dtile + r * pc::kWsPitch +
                                pc::slice_col(g, i0)) = packed;
      if (valid)
        *reinterpret_cast<uint2*>(
            a.dzx + ((size_t)t * rows + row) * 4 * H + (size_t)g * H + u0 +
            i0) = packed;
#pragma unroll
      for (int e = 0; e < 4; ++e) dbs[g][e] += d[g][e];
    }
    __syncthreads();
    // the partial bf16(dz[rows, C_j]) . Wh[:, C_j]^T, reduce-scattered
    float acc[2][H / 64][4];
    partial_product<H>(dtile, ws, acc);
    scatter_partials<H>(acc, a.xtile + (t & 1) * a.half + (size_t)me * kSlice);
    pc::sync();  // the partials of step t are written and visible
    if (a.done != nullptr && tid == 0) pc::publish(a.done, steps - t);
    cur = nxt;
    ext_cur = ext_nxt;
  }
  if (steps > 0) gather(-1);
  if (valid) {
    *reinterpret_cast<float4*>(a.dh0 + sidx) =
        make_float4(dh_c[0], dh_c[1], dh_c[2], dh_c[3]);
    *reinterpret_cast<float4*>(a.dc0 + sidx) =
        make_float4(dc[0], dc[1], dc[2], dc[3]);
  }
  // db of the tile: each column's 32 rows summed in row order
#pragma unroll
  for (int g = 0; g < 4; ++g)
    *reinterpret_cast<float4*>(part + r * pc::kCols + g * pc::kUnits + i0) =
        make_float4(dbs[g][0], dbs[g][1], dbs[g][2], dbs[g][3]);
  __syncthreads();
  if (tid < pc::kCols) {
    float s = 0.f;
    for (int rr = 0; rr < pc::kRows; ++rr) s += part[rr * pc::kCols + tid];
    const int g = tid / pc::kUnits, i = tid % pc::kUnits;
    a.db[(size_t)g * H + u0 + i] = s;
  }
}

// gates [T, B, 4H] in G; wh [H, 4H], cs/dys [T, B, H] bf16; mask [T, B];
// c0/dhT/dcT/dh0/dc0 [B, H] fp32; dzx [T, B, 4H] bf16 (out); db
// [row tiles, 4H] fp32 (out, one partial per row tile); xbuf, the
// exchange: [2 (step parity)][row tiles][NB owners][NB senders][rows][32]
// fp32, 2 x tiles x H^2 floats.  Grid (NB, row tiles) in clusters of
// (NB, 1): one recurrence per row tile.
template <int NB, typename G>
__global__ void __launch_bounds__(pc::kThreads, 1)
    lstm_bwd_persist_kernel(const G* __restrict__ gates,
                            const bf16* __restrict__ wh,
                            const float* __restrict__ mask,
                            const bf16* __restrict__ cs,
                            const float* __restrict__ c0,
                            const bf16* __restrict__ dys,
                            const float* __restrict__ dhT,
                            const float* __restrict__ dcT,
                            float* __restrict__ dh0, float* __restrict__ dc0,
                            bf16* __restrict__ dzx, float* __restrict__ db,
                            float* __restrict__ xbuf, int steps, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = NB * pc::kUnits;
  const size_t region = (size_t)NB * NB * kSlice;   // one tile's, one half
  BwdRec<G> a{gates, wh, mask, cs, c0, dys, nullptr, nullptr, nullptr, dhT,
              dcT, dh0, dc0, dzx, db + (size_t)blockIdx.y * 4 * H,
              xbuf + blockIdx.y * region, gridDim.y * region, steps, rows,
              (int)blockIdx.y * pc::kRows, rows};
  bwd_recurrence<NB, G, false>(a, smem);
}

// One projection stage of the stack's backward: layer l >= 1's dz reaches
// layer l-1 as its dh input bf16(dz_l[t]) . Wx_l^T.  Block j holds
// Wx_l[:, C_j] and forms the partial of its 128 columns from the bf16 dzx
// stream that recurrence stage l has just written (the rounding of
// lstm_fused.py:247 and :257-258); the partials are reduce-scattered in the
// cluster as the recurrence's are, and owner k sums its NB slices in sender
// order and writes ext[rows, U_k] into the ring that recurrence stage l-1
// reads.  Reverse step s (time T - 1 - s) waits for dzx_l (in_ready: the
// flags of recurrence stage l) and for its ring slot (slot_free:
// recurrence stage l-1 has finished reverse step s - kRingDepth).
struct BwdProj {
  const bf16* dzx;             // [T, B, 4H], layer l
  const bf16* wx;              // [H, 4H]
  float4* ring;
  const unsigned* in_ready;
  const unsigned* slot_free;
  unsigned* done;
  float* xtile;                // the partials' exchange, 2 halves
  size_t half;
  int steps, rows, row0, row_hi;
};

template <int NB>
__device__ __forceinline__ void bwd_projection(const BwdProj& a,
                                               unsigned char* smem) {
  using Sm = BwdSmem<NB>;
  constexpr int H = Sm::kHidden;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* dtile = reinterpret_cast<bf16*>(smem + Sm::kWs);
  const unsigned me = pc::rank();
  const int u0 = me * pc::kUnits;
  const int tid = threadIdx.x;
  const int r = tid / 8, i0 = 4 * (tid % 8);
  pc::stage_slice(a.wx, H, u0, ws);
  for (int s = 0; s < a.steps; ++s) {
    const int t = a.steps - 1 - s;
    if (tid < NB) {
      pc::spin_until(a.in_ready + tid, s + 1);
      if (s >= pc::kRingDepth)
        pc::spin_until(a.slot_free + tid, s - pc::kRingDepth + 1);
    }
    __syncthreads();
    // bf16(dz_l[t])[rows, C_j] into the dz tile, columns in slice order
    for (int e = tid; e < pc::kRows * 16; e += pc::kThreads) {
      const int rr = e / 16, g = (e % 16) / 4, oct = e % 4;
      const bool ok = a.row0 + rr < a.row_hi;
      mma::cp_async16(
          dtile + rr * pc::kWsPitch + pc::slice_col(g, 8 * oct),
          a.dzx + (ok ? ((size_t)t * a.rows + a.row0 + rr) * 4 * H +
                            (size_t)g * H + u0 + 8 * oct
                      : 0),
          ok ? 16 : 0);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();
    float acc[2][H / 64][4];
    partial_product<H>(dtile, ws, acc);
    float* half = a.xtile + (s & 1) * a.half;
    scatter_partials<H>(acc, half + (size_t)me * kSlice);
    pc::sync();  // the partials of step s are written and visible
    const float4 v = gather_partials<NB>(half + (size_t)me * NB * kSlice +
                                         (size_t)r * pc::kUnits + i0);
    __stcg(a.ring + ((size_t)(s % pc::kRingDepth) * NB + me) * pc::kThreads +
               tid,
           v);
    __syncthreads();  // the slot written
    if (tid == 0) pc::publish(a.done, s + 1);
  }
}

// The stack's BPTT as a layer wavefront of 2L - 1 stages per 32-row tile,
// each a cluster of NB blocks, all resident at once (a cooperative launch):
// cluster s of a tile runs recurrence stage l = L - 1 - s / 2 (s even,
// bwd_recurrence with Wh_l resident) or projection stage l = L - (s + 1) / 2
// (s odd, bwd_projection with Wx_l resident).  The top layer runs ahead on
// dys, each projection stage follows its recurrence through the dzx stream,
// and the layer below reads its dh input from the ring.
//
// gates [L, T, B, 4H], wx [L-1, H, 4H], wh [L, H, 4H], cs [L, T, B, H], dys
// [T, B, H] bf16; mask [T, B], c0/dhT/dcT/dh0/dc0 [L, B, H] fp32; dzx [L, T,
// B, 4H] bf16 (out); db [tiles, L, 4H] fp32 (out, each tile's partial).
// Scratch: xbuf [tiles][2L - 1][2][NB][NB][32][32] fp32, ring
// [tiles][L-1][kRingDepth][NB][256] float4, step flags [tiles][2L - 1][NB]
// (zero on entry).  Grid (NB, tiles (2L - 1)), rows as the forward's.
template <int NB>
__global__ void __launch_bounds__(pc::kThreads, 1)
    lstm_bwd_stack_persist_kernel(
        const bf16* __restrict__ gates, const bf16* __restrict__ wx,
        const bf16* __restrict__ wh, const float* __restrict__ mask,
        const bf16* __restrict__ cs, const float* __restrict__ c0,
        const bf16* __restrict__ dys, const float* __restrict__ dhT,
        const float* __restrict__ dcT, float* __restrict__ dh0,
        float* __restrict__ dc0, bf16* __restrict__ dzx,
        float* __restrict__ db, float* __restrict__ xbuf,
        float4* __restrict__ ring, unsigned* __restrict__ flags,
        int steps, int rows, int row_lo, int row_hi, int layers) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = NB * pc::kUnits;
  const int stages = 2 * layers - 1;
  const int tile = blockIdx.y / stages, s = blockIdx.y % stages;
  const int row0 = row_lo + tile * pc::kRows;
  unsigned* cnt = flags + (size_t)tile * stages * NB;  // stage s: + s NB
  const size_t whh = (size_t)H * 4 * H, bh = (size_t)rows * H;
  const size_t lt = (size_t)steps * bh;             // a layer's [T, B, H]
  const size_t region = (size_t)NB * NB * kSlice;
  float* xtile = xbuf + ((size_t)tile * stages + s) * 2 * region;
  const size_t ring_len = (size_t)pc::kRingDepth * NB * pc::kThreads;
  if (s % 2 == 1) {
    const int l = layers - (s + 1) / 2;
    BwdProj a{dzx + (size_t)l * 4 * lt, wx + (size_t)(l - 1) * whh,
              ring + ((size_t)tile * (layers - 1) + l - 1) * ring_len,
              cnt + (s - 1) * NB, cnt + (s + 1) * NB, cnt + s * NB, xtile,
              region, steps, rows, row0, row_hi};
    bwd_projection<NB>(a, smem);
    return;
  }
  const int l = layers - 1 - s / 2;
  const bool top = l == layers - 1;
  BwdRec<bf16> a{
      gates + (size_t)l * 4 * lt, wh + (size_t)l * whh, mask,
      cs + (size_t)l * lt, c0 + (size_t)l * bh, top ? dys : nullptr,
      top ? nullptr : ring + ((size_t)tile * (layers - 1) + l) * ring_len,
      top ? nullptr : cnt + (s - 1) * NB, cnt + s * NB,
      dhT + (size_t)l * bh,
      dcT + (size_t)l * bh, dh0 + (size_t)l * bh, dc0 + (size_t)l * bh,
      dzx + (size_t)l * 4 * lt, db + ((size_t)tile * layers + l) * 4 * H,
      xtile, region, steps, rows, row0, row_hi};
  if (top)
    bwd_recurrence<NB, bf16, false>(a, smem);
  else
    bwd_recurrence<NB, bf16, true>(a, smem);
}

template <int NB, typename G>
cudaError_t persist_with(const void* gates, const void* wh,
                         const float* mask, const void* cs, const float* c0,
                         const void* dys, const float* dhT, const float* dcT,
                         float* dh0, float* dc0, void* dzx, float* db,
                         float* xbuf, int steps, int rows, cudaStream_t st) {
  return pc::launch(lstm_bwd_persist_kernel<NB, G>, NB, rows,
                    BwdSmem<NB>::kBytes, st, static_cast<const G*>(gates),
                    static_cast<const bf16*>(wh), mask,
                    static_cast<const bf16*>(cs), c0,
                    static_cast<const bf16*>(dys), dhT, dcT, dh0, dc0,
                    static_cast<bf16*>(dzx), db, xbuf, steps, rows);
}

template <typename G>
cudaError_t persist(const void* gates, const void* wh, const float* mask,
                    const void* cs, const float* c0, const void* dys,
                    const float* dhT, const float* dcT, float* dh0,
                    float* dc0, void* dzx, float* db, float* xbuf,
                    int steps, int rows, int hidden, cudaStream_t st) {
  switch (hidden / pc::kUnits) {
    case 4:
      return persist_with<4, G>(gates, wh, mask, cs, c0, dys, dhT, dcT, dh0,
                                dc0, dzx, db, xbuf, steps, rows, st);
    case 8:
      return persist_with<8, G>(gates, wh, mask, cs, c0, dys, dhT, dcT, dh0,
                                dc0, dzx, db, xbuf, steps, rows, st);
    case 12:
      return persist_with<12, G>(gates, wh, mask, cs, c0, dys, dhT, dcT, dh0,
                                 dc0, dzx, db, xbuf, steps, rows, st);
    case 16:
      return persist_with<16, G>(gates, wh, mask, cs, c0, dys, dhT, dcT, dh0,
                                 dc0, dzx, db, xbuf, steps, rows, st);
  }
  return cudaErrorInvalidValue;
}

// The stack kernel at H = 32 NB: launch (tiles > 0) or query (tiles = 0:
// how many tiles one launch holds at `layers`, into *fit).
template <int NB>
cudaError_t stack_persist_with(const void* gates, const void* wx,
                               const void* wh, const float* mask,
                               const void* cs, const float* c0,
                               const void* dys, const float* dhT,
                               const float* dcT, float* dh0, float* dc0,
                               void* dzx, float* db, float* xbuf, void* ring,
                               unsigned* flags, int steps, int rows,
                               int row_lo, int row_hi, int layers, int tiles,
                               int* fit, cudaStream_t st) {
  auto kernel = lstm_bwd_stack_persist_kernel<NB>;
  constexpr size_t smem = BwdSmem<NB>::kBytes;
  if (tiles == 0) {
    *fit = pc::max_clusters(kernel, NB, smem) / (2 * layers - 1);
    return cudaSuccess;
  }
  return pc::launch_clusters(
      kernel, NB, tiles * (2 * layers - 1), true, smem, st,
      static_cast<const bf16*>(gates), static_cast<const bf16*>(wx),
      static_cast<const bf16*>(wh), mask, static_cast<const bf16*>(cs), c0,
      static_cast<const bf16*>(dys), dhT, dcT, dh0, dc0,
      static_cast<bf16*>(dzx), db, xbuf, static_cast<float4*>(ring),
      flags, steps, rows, row_lo, row_hi, layers);
}

cudaError_t stack_persist(const void* gates, const void* wx, const void* wh,
                          const float* mask, const void* cs, const float* c0,
                          const void* dys, const float* dhT, const float* dcT,
                          float* dh0, float* dc0, void* dzx, float* db,
                          float* xbuf, void* ring, unsigned* flags,
                          int steps, int rows, int row_lo, int row_hi,
                          int hidden, int layers, int tiles, int* fit,
                          cudaStream_t st) {
  switch (hidden / pc::kUnits) {
#define LSTM_STACK_CASE(NB)                                                   \
  case NB:                                                                    \
    return stack_persist_with<NB>(gates, wx, wh, mask, cs, c0, dys, dhT, dcT, \
                                  dh0, dc0, dzx, db, xbuf, ring, flags,    \
                                  steps, rows, row_lo, row_hi, layers, tiles, \
                                  fit, st);
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
// gates [T, B, 4H], wh [H, 4H], mask [T, B], cs [T, B, H], c0 [B, H] fp32,
// dys [T, B, H]; dh/dc [B, H] fp32 hold dhT/dcT on entry and dh0/dc0 on
// return; dzx [T, B, 4H] (out); db [ceil(B / 16), 4H] fp32, zeroed by the
// caller, receives per-row-block partial sums of dz.
// Returns a cudaError_t code (0 = launched).
extern "C" int lstm_bwd_layer(const void* gates, const void* wh,
                              const float* mask, const void* cs,
                              const float* c0, const void* dys, float* dh,
                              float* dc, void* dzx, float* db, int steps,
                              int rows, int hidden, int dtype,
                              int gates_code, void* stream) {
  if (gates_code == 0)
    return run<void>(gates, nullptr, wh, mask, cs, c0, dys, dh, dc, dzx, db,
                     steps, rows, hidden, 1, dtype, stream);
  if (gates_code == 1)
    return run<int8_t>(gates, nullptr, wh, mask, cs, c0, dys, dh, dc, dzx,
                       db, steps, rows, hidden, 1, dtype, stream);
  return cudaErrorInvalidValue;
}

// The persistent kernel (bf16 only): gates [T, B, 4H] (gates_code 0: bf16,
// 1: int8), wh [H, 4H], mask [T, B], cs [T, B, H], c0 [B, H] fp32, dys
// [T, B, H], dhT/dcT [B, H] fp32 (read only); dh0/dc0 [B, H] fp32, dzx
// [T, B, 4H] and db [ceil(B / 32), 4H] fp32 (each row tile's partial,
// every entry written): out; xbuf: 2 ceil(B / 32) H^2 fp32 of scratch.
extern "C" int lstm_bwd_persist(const void* gates, const void* wh,
                                const float* mask, const void* cs,
                                const float* c0, const void* dys,
                                const float* dhT, const float* dcT,
                                float* dh0, float* dc0, void* dzx, float* db,
                                float* xbuf, int steps, int rows, int hidden,
                                int dtype, int gates_code, void* stream) {
  if (!pc::persist_ok(rows, hidden, dtype) || steps < 0 ||
      (gates_code != 0 && gates_code != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gates_code == 1)
    return persist<int8_t>(gates, wh, mask, cs, c0, dys, dhT, dcT, dh0, dc0,
                           dzx, db, xbuf, steps, rows, hidden, st);
  return persist<bf16>(gates, wh, mask, cs, c0, dys, dhT, dcT, dh0, dc0, dzx,
                       db, xbuf, steps, rows, hidden, st);
}

// How many clusters of the persistent backward kernel at this hidden size
// the card runs at once (cudaOccupancyMaxActiveClusters; -1 on error).
extern "C" int lstm_bwd_persist_clusters(int hidden) {
  if (!pc::persist_ok(1, hidden, 1)) return -1;
  switch (hidden / pc::kUnits) {
    case 4:
      return pc::max_clusters(lstm_bwd_persist_kernel<4, bf16>, 4,
                              BwdSmem<4>::kBytes);
    case 8:
      return pc::max_clusters(lstm_bwd_persist_kernel<8, bf16>, 8,
                              BwdSmem<8>::kBytes);
    case 12:
      return pc::max_clusters(lstm_bwd_persist_kernel<12, bf16>, 12,
                              BwdSmem<12>::kBytes);
    case 16:
      return pc::max_clusters(lstm_bwd_persist_kernel<16, bf16>, 16,
                              BwdSmem<16>::kBytes);
  }
  return -1;
}

// Whole stack of L >= 2 layers: gates [L, T, B, 4H], wx_rest [L-1, H, 4H],
// wh [L, H, 4H], mask [T, B], cs [L, T, B, H], c0 [L, B, H], dys [T, B, H]
// (the top layer's cotangent); dh/dc [L, B, H] (dhT/dcT in, dh0/dc0 out);
// dzx [L, T, B, 4H]; db [ceil(B / 16), L, 4H], zeroed by the caller.
extern "C" int lstm_bwd_stack(const void* gates, const void* wx_rest,
                              const void* wh, const float* mask,
                              const void* cs, const float* c0,
                              const void* dys, float* dh, float* dc,
                              void* dzx, float* db, int steps, int rows,
                              int hidden, int layers, int dtype,
                              void* stream) {
  if (layers < 2) return cudaErrorInvalidValue;
  return run<void>(gates, wx_rest, wh, mask, cs, c0, dys, dh, dc, dzx, db,
                   steps, rows, hidden, layers, dtype, stream);
}

// How many 32-row tiles one launch of the persistent stack backward holds
// at (hidden, layers) (cudaOccupancyMaxActiveClusters over its 2L - 1
// clusters a tile; 0: none fits, -1: not its route).
extern "C" int lstm_bwd_stack_persist_tiles(int hidden, int layers) {
  if (!pc::stack_persist_ok(1, hidden, layers, 1)) return -1;
  int fit = 0;
  if (stack_persist(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, hidden,
                    layers, 0, &fit, nullptr) != cudaSuccess)
    return -1;
  return fit;
}

// The persistent stack backward (bf16 only), rows [row_lo, row_hi) of the
// batch in one cooperative launch of ceil((row_hi - row_lo) / 32) row
// tiles: gates [L, T, B, 4H], wx_rest [L-1, H, 4H], wh [L, H, 4H], mask
// [T, B], cs [L, T, B, H], c0 [L, B, H] fp32, dys [T, B, H] (the top
// layer's cotangent), dhT/dcT [L, B, H] fp32 (read only); dh0/dc0 [L, B, H]
// fp32, dzx [L, T, B, 4H] and db [tiles, L, 4H] fp32 (each tile's partial,
// every entry written): out.  Scratch: xbuf (2L - 1) tiles 2 H^2 fp32, ring
// (L - 1) tiles 4 32 H fp32, step flags (2L - 1) tiles H / 32 uint32, zero
// on entry (one set per launch).  A launch the card cannot hold at once is
// refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int lstm_bwd_stack_persist(
    const void* gates, const void* wx_rest, const void* wh,
    const float* mask, const void* cs, const float* c0, const void* dys,
    const float* dhT, const float* dcT, float* dh0, float* dc0, void* dzx,
    float* db, float* xbuf, void* ring, unsigned* flags, int steps,
    int rows, int row_lo, int row_hi, int hidden, int layers, int dtype,
    void* stream) {
  if (!pc::stack_persist_ok(rows, hidden, layers, dtype) || steps < 0 ||
      row_lo < 0 || row_hi > rows || row_lo >= row_hi)
    return cudaErrorInvalidValue;
  const int tiles = (row_hi - row_lo + pc::kRows - 1) / pc::kRows;
  int fit = 0;
  return stack_persist(gates, wx_rest, wh, mask, cs, c0, dys, dhT, dcT, dh0,
                       dc0, dzx, db, xbuf, ring, flags, steps, rows,
                       row_lo, row_hi, hidden, layers, tiles, &fit,
                       static_cast<cudaStream_t>(stream));
}
