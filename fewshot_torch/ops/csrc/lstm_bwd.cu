// Backward (BPTT) LSTM recurrence kernels for Hopper (sm_90a), plain C
// interface.
//
// Replace the two TPU backward kernels of the JAX package:
//   * fewshot/ops/lstm_pallas.py `_bwd_kernel`  -> lstm_bwd_layer (one layer)
//   * fewshot/ops/lstm_fused.py  `_bwd_kernel`  -> lstm_bwd_stack (all layers
//     of one time step, top layer first)
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
// The stream dtype equals the weight dtype in the port, so the rounded dz of
// step t+1 is read straight back from dzx[t+1].  db is summed in the kernel
// from the unrounded fp32 dz, as per-row-block partials that the caller
// adds up; dWh and dWx are bulk products over the saved streams, outside.
//
// Design.  The dependency per step is the whole dz_{t+1} [rows, 4H] row
// contracted with Wh^T.  As in the forward (lstm_fwd.cu), one launch runs
// one step (and one layer), and the launch boundary is the grid barrier.  A
// block owns ROWS rows and UNITS hidden units: it stages its rows of dz_{t+1}
// (4H wide) and its units' Wh rows (each a contiguous 4H row of Wh [H, 4H])
// in shared memory with 16-byte cp.async copies, forms dh for its units
// (the contraction split over KSPLIT thread groups), then computes the four
// gate deltas of its units locally and writes them to dzx[t].  The carried
// fp32 dh and dc live in device memory, each element read and written only
// by its owning thread.  A last launch per layer contracts dz_0 for dh0.
//
// Bound.  At the training shapes a step is small (160 or 16 rows), so the
// kernel is bound by per-step latency (launch, the L2 reads of Wh and dz, the
// fp32 FMA loop), far above its device-memory bound.  The same next steps as
// for the forward apply: a persistent kernel and tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// shared memory a block may use; ops/lstm_layer.py max_hidden_bwd mirrors it
constexpr int kMaxSmem = 227 * 1024;
constexpr int kPadBytes = 16;       // padding per staged 4H row

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
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
// and rp + ROWS / 2) and one contraction slice.
template <typename T, int ROWS, int UNITS, int KSPLIT>
struct BwdTile {
  static constexpr int kThreads = (ROWS / 2) * UNITS * KSPLIT;
  __host__ __device__ static size_t stride(int hidden) {  // per staged row
    return 4 * (size_t)hidden + kPadBytes / sizeof(T);
  }
  static size_t smem_bytes(int hidden) {
    const size_t stage = (size_t)(ROWS + UNITS) * stride(hidden) * sizeof(T);
    const size_t reduce = ((size_t)KSPLIT * ROWS * UNITS * 2 +
                           (size_t)ROWS * UNITS * 4) * sizeof(float);
    return stage > reduce ? stage : reduce;
  }
};

// Stage rows [row0, row0 + ROWS) of a [rows, 4H] operand and rows
// [u0, u0 + UNITS) of a weight [H, 4H]; operand rows past `rows` read as 0.
template <typename T, int ROWS, int UNITS, int THREADS>
__device__ __forceinline__ void stage(const T* __restrict__ dz,
                                      const T* __restrict__ w, int rows,
                                      int hidden, size_t stride, int row0,
                                      int u0, T* dzs, T* ws) {
  const int tid = threadIdx.x;
  const int pieces = 4 * hidden * (int)sizeof(T) / 16;   // per 4H row
  for (int e = tid; e < (ROWS + UNITS) * pieces; e += THREADS) {
    const int r = e / pieces, p = e % pieces;
    if (r < ROWS) {
      char* dst = reinterpret_cast<char*>(dzs + (size_t)r * stride) + 16 * p;
      const int row = row0 + r;
      if (row < rows) {
        cp_async16(dst, reinterpret_cast<const char*>(
                            dz + (size_t)row * 4 * hidden) + 16 * p);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      const int k = r - ROWS;
      char* dst = reinterpret_cast<char*>(ws + (size_t)k * stride) + 16 * p;
      cp_async16(dst, reinterpret_cast<const char*>(
                          w + (size_t)(u0 + k) * 4 * hidden) + 16 * p);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// acc[i] += sum over this thread's slice of the 4H columns of
// dz[row_i, k] * w[unit, k]
template <typename T, int ROWS, int UNITS, int KSPLIT>
__device__ __forceinline__ void contract(const T* dzs, const T* ws,
                                         int hidden, size_t stride, int j,
                                         int rp, int ks, float (&acc)[2]) {
  const int per = 4 * hidden * (int)sizeof(T) / 16 / KSPLIT;
  const uint4* a0 = reinterpret_cast<const uint4*>(dzs + (size_t)rp * stride);
  const uint4* a1 =
      reinterpret_cast<const uint4*>(dzs + (size_t)(rp + ROWS / 2) * stride);
  const uint4* w = reinterpret_cast<const uint4*>(ws + (size_t)j * stride);
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

template <typename T, int ROWS, int UNITS, int KSPLIT>
__global__ void __launch_bounds__(BwdTile<T, ROWS, UNITS, KSPLIT>::kThreads)
    lstm_bwd_step_kernel(StepArgs a) {
  using Tile = BwdTile<T, ROWS, UNITS, KSPLIT>;
  constexpr int kThreads = Tile::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hidden = a.hidden;
  const size_t stride = Tile::stride(hidden);
  T* dzs = reinterpret_cast<T*>(smem);
  T* ws = dzs + (size_t)ROWS * stride;
  const int u0 = blockIdx.x * UNITS;
  const int row0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int j = tid % UNITS;
  const int rp = (tid / UNITS) % (ROWS / 2);
  const int ks = tid / (UNITS * (ROWS / 2));

  // acc[0]: the layer above's dz . Wx^T; acc[1]: this layer's dz_{t+1} . Wh^T
  float acc[2][2] = {};
  const T* dz_up = static_cast<const T*>(a.dz_up);
  const T* dz_next = static_cast<const T*>(a.dz_next);
  if (dz_up != nullptr) {
    stage<T, ROWS, UNITS, kThreads>(dz_up, static_cast<const T*>(a.wx_up),
                                    a.rows, hidden, stride, row0, u0, dzs,
                                    ws);
    contract<T, ROWS, UNITS, KSPLIT>(dzs, ws, hidden, stride, j, rp, ks,
                                     acc[0]);
    __syncthreads();  // the next stage overwrites dzs/ws
  }
  if (dz_next != nullptr) {
    stage<T, ROWS, UNITS, kThreads>(dz_next, static_cast<const T*>(a.wh),
                                    a.rows, hidden, stride, row0, u0, dzs,
                                    ws);
    contract<T, ROWS, UNITS, KSPLIT>(dzs, ws, hidden, stride, j, rp, ks,
                                     acc[1]);
  }

  float* red = reinterpret_cast<float*>(smem);
  float* dbred = red + (size_t)KSPLIT * ROWS * UNITS * 2;
  if (KSPLIT > 1) {  // sum the contraction slices in slice order
    __syncthreads();
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
        const T* g = static_cast<const T*>(a.gates) + (size_t)row * four_h + u;
        const float si = to_float(g[0]);
        const float tj = to_float(g[hidden]);
        const float sf = to_float(g[2 * (size_t)hidden]);
        const float so = to_float(g[3 * (size_t)hidden]);
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

template <typename T, int ROWS, int UNITS, int KSPLIT>
struct BwdLauncher {
  using Tile = BwdTile<T, ROWS, UNITS, KSPLIT>;
  size_t smem = 0;

  cudaError_t prepare(int hidden) {
    smem = Tile::smem_bytes(hidden);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(lstm_bwd_step_kernel<T, ROWS, UNITS, KSPLIT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }

  cudaError_t launch(const StepArgs& a, cudaStream_t stream) const {
    const dim3 grid(a.hidden / UNITS, (a.rows + ROWS - 1) / ROWS);
    lstm_bwd_step_kernel<T, ROWS, UNITS, KSPLIT>
        <<<grid, Tile::kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

// Reverse-time loop over `layers` layers (1 = the per-layer kernel).
// Stack layout: gates/dzx [L, T, B, 4H], cs [L, T, B, H], wh [L, H, 4H],
// wx_rest [L-1, H, 4H], c0/dh/dc [L, B, H], db [row blocks, L, 4H]; dys
// [T, B, H] lands on the top layer.
template <typename T, typename L>
cudaError_t run_with(L& launcher, const void* gates_v, const void* wx_v,
                     const void* wh_v, const float* mask, const void* cs_v,
                     const float* c0, const void* dys_v, float* dh, float* dc,
                     void* dzx_v, float* db, int steps, int rows, int hidden,
                     int layers, cudaStream_t stream) {
  cudaError_t err = launcher.prepare(hidden);
  if (err != cudaSuccess) return err;
  const T* gates = static_cast<const T*>(gates_v);
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
// batches of at most 16 rows (or hidden sizes whose wide tile does not fit)
// take 16-row tiles of 4 units with the contraction split 8 ways.  The
// caller sizes db for 16-row blocks, the narrowest.
template <typename T>
bool use_wide(int rows, int hidden) {
  return rows > 16 &&
         BwdTile<T, 32, 8, 2>::smem_bytes(hidden) <= (size_t)kMaxSmem;
}

template <typename T>
cudaError_t dispatch(const void* gates, const void* wx_rest, const void* wh,
                     const float* mask, const void* cs, const float* c0,
                     const void* dys, float* dh, float* dc, void* dzx,
                     float* db, int steps, int rows, int hidden, int layers,
                     cudaStream_t st) {
  if (use_wide<T>(rows, hidden)) {
    BwdLauncher<T, 32, 8, 2> l;
    return run_with<T>(l, gates, wx_rest, wh, mask, cs, c0, dys, dh, dc, dzx,
                       db, steps, rows, hidden, layers, st);
  }
  BwdLauncher<T, 16, 4, 8> l;
  return run_with<T>(l, gates, wx_rest, wh, mask, cs, c0, dys, dh, dc, dzx,
                     db, steps, rows, hidden, layers, st);
}

int run(const void* gates, const void* wx_rest, const void* wh,
        const float* mask, const void* cs, const float* c0, const void* dys,
        float* dh, float* dc, void* dzx, float* db, int steps, int rows,
        int hidden, int layers, int dtype, void* stream) {
  if (steps < 0 || rows <= 0 || hidden <= 0 || hidden % 32 || layers < 1)
    return cudaErrorInvalidValue;
  if (steps == 0) return cudaSuccess;      // dh0 = dhT, dc0 = dcT
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(gates, wx_rest, wh, mask, cs, c0, dys, dh, dc, dzx,
                           db, steps, rows, hidden, layers, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(gates, wx_rest, wh, mask, cs, c0, dys, dh,
                                   dc, dzx, db, steps, rows, hidden, layers,
                                   st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32 weights and streams, 1 = bf16 weights and streams.
// gates [T, B, 4H], wh [H, 4H], mask [T, B], cs [T, B, H], c0 [B, H] fp32,
// dys [T, B, H]; dh/dc [B, H] fp32 hold dhT/dcT on entry and dh0/dc0 on
// return; dzx [T, B, 4H] (out); db [ceil(B / 16), 4H] fp32, zeroed by the
// caller, receives per-row-block partial sums of dz.
// Returns a cudaError_t code (0 = launched).
extern "C" int lstm_bwd_layer(const void* gates, const void* wh,
                              const float* mask, const void* cs,
                              const float* c0, const void* dys, float* dh,
                              float* dc, void* dzx, float* db, int steps,
                              int rows, int hidden, int dtype, void* stream) {
  return run(gates, nullptr, wh, mask, cs, c0, dys, dh, dc, dzx, db, steps,
             rows, hidden, 1, dtype, stream);
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
  return run(gates, wx_rest, wh, mask, cs, c0, dys, dh, dc, dzx, db, steps,
             rows, hidden, layers, dtype, stream);
}
