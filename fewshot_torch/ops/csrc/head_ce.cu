// Fused LM head + cross-entropy kernels for Hopper (sm_90a), plain C
// interface.
//
// Replace the TPU kernels of fewshot/ops/head_ce.py:
//   * `_fwd_kernel` and `_fwd_kernel_tiled` (via `_fwd_call`)   -> head_ce_fwd
//   * `_bwd_kernel`, `_bwd_dh2_kernel_tiled` and
//     `_bwd_dwdb_kernel_tiled` (via `_bwd_call`, `_vjp_bwd`)      -> head_ce_bwd
//
// Per row r of h2 [R, D] and the head w [D, V] (read as wt = w^T [V, D]
// row-major: the tied head's embedding table as it is stored):
//   logits = h2 @ w + b,  lse = logsumexp(logits),  tl = logits[tgt]
// and, given the cotangents (dlse, dtl),
//   p = exp(logits - lse),  dlogits = dlse p + dtl onehot(tgt)
//   dlg = dlogits rounded to the operand dtype
//   dh2 = dlg @ w^T (fp32 sums, stored in the operand dtype)
//   dw = h2^T @ dlg (fp32),  db = sum over rows of the unrounded dlogits
// as the TPU kernels do: operands in bf16 (or fp32) with fp32 products and
// sums, nothing [R, V]-shaped ever written to device memory.
//
// Design.  The TPU keeps the whole [D, V] weight in VMEM (resident plan) or
// streams it with a sequential grid that carries the softmax state and the
// dW accumulator from one grid step to the next (tiled plan).  A block here
// has 227 KB of shared memory and blocks run in no order, so every kernel
// works on 64 x 64 logits tiles, recomputed from h2 and wt streamed through
// shared memory in 32-deep chunks (cp.async, double-buffered); 256 threads
// each own a 4 x 4 piece of the tile (rows ty + 16 i, columns tx + 16 j).
//   * Forward: a block owns 64 rows and walks all vocab tiles.  Each thread
//     keeps an online (max, sum-exp) over the columns it owns, merged across
//     the 16 threads of a row by shuffles at the end; the thread that owns
//     the target column keeps its logit.
//   * Backward, pass (a): a block owns 64 rows and walks the vocab tiles;
//     it forms the rounded dlogits tile in shared memory and adds
//     dlg @ wt[tile] into an fp32 [64, D] accumulator in shared memory.
//   * Backward, pass (b): a block owns 64 vocab columns and one of S chunks
//     of the rows; it adds dlg^T @ h2[tile] into its fp32 [64, D]
//     accumulator and sums the unrounded dlogits per column, then writes
//     both as partials [S, V, D] and [S, V] that the caller adds up in a
//     fixed order (no float atomics).
// D may be any multiple of 64 whose [64, D] accumulator fits in shared
// memory beside the staging buffers (ops/head_ce.py max_head_dim mirrors
// the arithmetic: D <= 640 fp32, 704 bf16); the forward alone has no limit.
//
// Bound.  At the training shape (R ~ 16k rows, D = 256, V = 5000) the
// forward does 2 R D V ~ 4e10 multiply-adds over ~11 MB of operands, so it
// is bound by operations, and the backward does twice as many per pass.
// This first version multiplies on the fp32 SIMT units (67 TFLOP/s peak,
// against 989 for bf16 tensor cores); its tiles keep operands in shared
// memory and registers, so device memory traffic stays near the bound.
// Tensor-core tiles (mma / wgmma) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows and vocab columns of a logits tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 tile entries each
constexpr int kChunk = 32;     // depth of one staged slice of the contraction
constexpr int kWin = 64;       // width of one staged D window (pass a / b)
constexpr int kSdPitch = kTile + 1;  // floats per row of the dlogits tile
constexpr int kAccPad = 16;          // floats of padding per accumulator row
// shared memory a block may use; ops/head_ce.py max_head_dim mirrors it
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

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 f = __bfloat1622float2(h[p]);
    out[2 * p] = f.x;
    out[2 * p + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);      // elements per 16 B
  static constexpr int kPitch = kChunk + kVec;           // staged chunk row
  static constexpr int kWinPitch = kWin + kVec;          // staged window row
  static constexpr size_t kGemm = 2 * 2 * (size_t)kTile * kPitch * sizeof(T);
  static constexpr size_t kWinBytes = (size_t)kTile * kWinPitch * sizeof(T);
  // the window aliases the chunk buffers: they are never live together
  static constexpr size_t kStage = kGemm > kWinBytes ? kGemm : kWinBytes;
  static size_t bwd_smem(int d) {
    return kStage + (size_t)kTile * kSdPitch * sizeof(float) +
           (size_t)kTile * (d + kAccPad) * sizeof(float);
  }
};

// Stage rows [row0, row0 + kTile) x columns [k0, k0 + WIDTH) of a row-major
// [n, ld] matrix into dst (PITCH elements per row); rows past n read as 0.
template <typename T, int WIDTH, int PITCH>
__device__ __forceinline__ void stage(const T* __restrict__ src, int n, int ld,
                                      int row0, int k0, T* dst) {
  constexpr int kVec = Layout<T>::kVec;
  constexpr int kPer = WIDTH / kVec;  // 16-byte pieces per row
  for (int e = threadIdx.x; e < kTile * kPer; e += kThreads) {
    const int r = e / kPer, p = e % kPer;
    T* d = dst + r * PITCH + p * kVec;
    const int row = row0 + r;
    if (row < n) {
      cp_async16(d, src + (size_t)row * ld + k0 + p * kVec);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  }
}

// acc[i][j] = sum over k of h2[row0 + ty + 16 i, k] wt[col0 + tx + 16 j, k],
// fp32 sums of the stored operands; rows past `rows` and columns past
// `vocab` read as zero.  buf holds two chunk buffers for each operand.
// Ends with a barrier, so the caller may reuse buf.
template <typename T>
__device__ __forceinline__ void logits_tile(const T* __restrict__ h2, int rows,
                                            int row0, const T* __restrict__ wt,
                                            int vocab, int col0, int d, T* buf,
                                            float (&acc)[4][4]) {
  constexpr int P = Layout<T>::kPitch;
  constexpr int kVec = Layout<T>::kVec;
  constexpr int kBuf = kTile * P;  // elements of one operand chunk
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  // buffers: a0, a1 (h2 chunks), b0, b1 (wt chunks)
  const int nk = d / kChunk;
  stage<T, kChunk, P>(h2, rows, d, row0, 0, buf);
  stage<T, kChunk, P>(wt, vocab, d, col0, 0, buf + 2 * kBuf);
  cp_async_commit();
  for (int c = 0; c < nk; ++c) {
    const int cur = c & 1;
    if (c + 1 < nk) {
      stage<T, kChunk, P>(h2, rows, d, row0, (c + 1) * kChunk,
                          buf + (1 - cur) * kBuf);
      stage<T, kChunk, P>(wt, vocab, d, col0, (c + 1) * kChunk,
                          buf + (3 - cur) * kBuf);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* A = buf + cur * kBuf;
    const T* B = buf + (2 + cur) * kBuf;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += kVec) {
      float a[4][kVec], b[4][kVec];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        unpack(*reinterpret_cast<const uint4*>(A + (ty + 16 * i) * P + kk),
               a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        unpack(*reinterpret_cast<const uint4*>(B + (tx + 16 * j) * P + kk),
               b[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < kVec; ++q)
            acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
    }
    __syncthreads();  // the next chunk overwrites this buffer
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    head_ce_fwd_kernel(const T* __restrict__ h2, const T* __restrict__ wt,
                       const float* __restrict__ bias,
                       const int* __restrict__ tgt, float* __restrict__ lse,
                       float* __restrict__ tl, int rows, int vocab, int d) {
  __shared__ __align__(16) T buf[Layout<T>::kGemm / sizeof(T)];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * kTile;
  // per owned row: running max and sum of exp over the owned columns, and
  // the target's logit (only the thread owning the target column adds it)
  float m[4], s[4], t[4];
  int tg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    m[i] = -INFINITY;
    s[i] = 0.0f;
    t[i] = 0.0f;
    tg[i] = r < rows ? tgt[r] : -1;
  }
  for (int col0 = 0; col0 < vocab; col0 += kTile) {
    float acc[4][4];
    logits_tile<T>(h2, rows, row0, wt, vocab, col0, d, buf, acc);
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      bj[j] = c < vocab ? bias[c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        acc[i][j] += bj[j];
        if (c < vocab) {
          mx = fmaxf(mx, acc[i][j]);
          if (c == tg[i]) t[i] += acc[i][j];
        }
      }
      if (mx > m[i]) {  // rescale the running sum to the new max
        s[i] *= expf(m[i] - mx);
        m[i] = mx;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col0 + tx + 16 * j < vocab) s[i] += expf(acc[i][j] - m[i]);
    }
  }
  // merge the 16 threads of each row (lanes tx = 0..15 of a half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off, 16);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off, 16);
      const float to = __shfl_xor_sync(0xffffffffu, t[i], off, 16);
      const float mn = fmaxf(m[i], mo);
      const float sa = m[i] == -INFINITY ? 0.0f : s[i] * expf(m[i] - mn);
      const float sb = mo == -INFINITY ? 0.0f : so * expf(mo - mn);
      s[i] = sa + sb;
      m[i] = mn;
      t[i] += to;
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < rows) {
      lse[r] = m[i] + logf(s[i]);
      tl[r] = t[i];
    }
  }
}

struct BwdArgs {
  const void* h2;      // [R, D]
  const void* wt;      // [V, D]
  const float* bias;   // [V]
  const int* tgt;      // [R]
  const float* lse;    // [R]
  const float* dlse;   // [R]
  const float* dtl;    // [R]
  void* dh2;           // [R, D] (pass a)
  float* dwt;          // [S, V, D] partials (pass b)
  float* db;           // [S, V] partials (pass b)
  int rows;
  int vocab;
  int d;
  int splits;          // S
};

// kDW = false: pass (a), dh2; kDW = true: pass (b), dW and db partials.
template <typename T, bool kDW>
__global__ void __launch_bounds__(kThreads, 2) head_ce_bwd_kernel(BwdArgs a) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  T* win = buf;  // aliases the chunk buffers
  float* sd = reinterpret_cast<float*>(smem + L::kStage);  // [64][65] dlg
  float* sacc = sd + kTile * kSdPitch;                      // [64][D + 16]
  const int d = a.d;
  const int accp = d + kAccPad;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* h2 = static_cast<const T*>(a.h2);
  const T* wt = static_cast<const T*>(a.wt);
  const int outer0 = blockIdx.x * kTile;  // rows (a) or vocab columns (b)

  for (int e = threadIdx.x; e < kTile * accp; e += kThreads) sacc[e] = 0.0f;
  int begin = 0, end;
  if (kDW) {  // this block's chunk of the row tiles
    const int nt = (a.rows + kTile - 1) / kTile;
    const int per = (nt + a.splits - 1) / a.splits;
    begin = min(nt, (int)blockIdx.y * per);
    end = min(nt, begin + per);
  } else {
    end = (a.vocab + kTile - 1) / kTile;
  }
  float dbacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  __syncthreads();

  for (int it = begin; it < end; ++it) {
    const int row0 = kDW ? it * kTile : outer0;
    const int col0 = kDW ? outer0 : it * kTile;
    float acc[4][4];
    logits_tile<T>(h2, a.rows, row0, wt, a.vocab, col0, d, buf, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      const bool live = r < a.rows;
      const float lse_r = live ? a.lse[r] : 0.0f;
      const float dlse_r = live ? a.dlse[r] : 0.0f;
      const float dtl_r = live ? a.dtl[r] : 0.0f;
      const int tg = live ? a.tgt[r] : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx + 16 * j;
        float dl = 0.0f;
        if (live && c < a.vocab) {
          const float p = expf(acc[i][j] + a.bias[c] - lse_r);
          dl = dlse_r * p + (c == tg ? dtl_r : 0.0f);
        }
        if (kDW) dbacc[j] += dl;
        sd[(ty + 16 * i) * kSdPitch + tx + 16 * j] =
            to_float(from_float<T>(dl));
      }
    }
    // (a): sacc[r][:] += sum over v of dlg[r][v] wt[col0 + v][:]
    // (b): sacc[v][:] += sum over r of dlg[r][v] h2[row0 + r][:]
    const T* src = kDW ? h2 : wt;
    const int src_n = kDW ? a.rows : a.vocab;
    const int src0 = kDW ? row0 : col0;
    for (int w0 = 0; w0 < d; w0 += kWin) {
      stage<T, kWin, L::kWinPitch>(src, src_n, d, src0, w0, win);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // the window and (first time) the dlogits tile
      float p[4][4] = {};
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = kDW ? sd[k * kSdPitch + ty + 16 * i]
                     : sd[(ty + 16 * i) * kSdPitch + k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          y[j] = to_float(win[k * L::kWinPitch + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = fmaf(x[i], y[j], p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sacc[(ty + 16 * i) * accp + w0 + tx + 16 * j] += p[i][j];
      __syncthreads();  // the window (and then the chunk buffers) is reused
    }
  }

  if (kDW) {
    // db: each column's 16 row groups added in order
#pragma unroll
    for (int j = 0; j < 4; ++j) sd[ty * kSdPitch + tx + 16 * j] = dbacc[j];
    __syncthreads();
    if (threadIdx.x < kTile) {
      float s = 0.0f;
      for (int g = 0; g < 16; ++g) s += sd[g * kSdPitch + threadIdx.x];
      const int c = outer0 + threadIdx.x;
      if (c < a.vocab) a.db[(size_t)blockIdx.y * a.vocab + c] = s;
    }
    for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
      const int v = e / d, k = e % d;
      const int c = outer0 + v;
      if (c < a.vocab)
        a.dwt[((size_t)blockIdx.y * a.vocab + c) * d + k] = sacc[v * accp + k];
    }
  } else {
    T* dh2 = static_cast<T*>(a.dh2);
    for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
      const int r = e / d, k = e % d;
      const int row = outer0 + r;
      if (row < a.rows)
        dh2[(size_t)row * d + k] = from_float<T>(sacc[r * accp + k]);
    }
  }
}

bool bad_shape(int rows, int vocab, int d) {
  return rows < 0 || vocab <= 0 || d <= 0 || d % kWin;
}

template <typename T>
cudaError_t fwd(const void* h2, const void* wt, const float* b, const int* tgt,
                float* lse, float* tl, int rows, int vocab, int d,
                cudaStream_t st) {
  const dim3 grid((rows + kTile - 1) / kTile);
  head_ce_fwd_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(h2), static_cast<const T*>(wt), b, tgt, lse, tl,
      rows, vocab, d);
  return cudaGetLastError();
}

template <typename T, bool kDW>
cudaError_t bwd_pass(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = Layout<T>::bwd_smem(a.d);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_ce_bwd_kernel<T, kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kDW ? dim3((a.vocab + kTile - 1) / kTile, a.splits)
                        : dim3((a.rows + kTile - 1) / kTile);
  head_ce_bwd_kernel<T, kDW><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const BwdArgs& a, cudaStream_t st) {
  if (a.rows > 0) {  // no rows: pass (b) alone writes the zero partials
    cudaError_t err = bwd_pass<T, false>(a, st);
    if (err != cudaSuccess) return err;
  }
  return bwd_pass<T, true>(a, st);
}

}  // namespace

// dtype: 0 = fp32 operands, 1 = bf16 operands (h2 and wt).
// h2 [R, D], wt [V, D] (the head w [D, V] transposed, row-major), b [V]
// fp32, tgt [R] int32; lse, tl [R] fp32 (out).  D a multiple of 64.
// Returns a cudaError_t code (0 = launched).
extern "C" int head_ce_fwd(const void* h2, const void* wt, const float* b,
                           const int* tgt, float* lse, float* tl, int rows,
                           int vocab, int d, int dtype, void* stream) {
  if (bad_shape(rows, vocab, d)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(h2, wt, b, tgt, lse, tl, rows, vocab, d, st);
  if (dtype == 1)
    return fwd<__nv_bfloat16>(h2, wt, b, tgt, lse, tl, rows, vocab, d, st);
  return cudaErrorInvalidValue;
}

// The forward's inputs plus lse and the cotangents dlse, dtl [R] fp32.
// Out: dh2 [R, D] in the operand dtype; dwt [S, V, D] and db [S, V] fp32
// partials over S chunks of the rows (every entry written), which the
// caller sums over S.  Launches pass (a) then pass (b).
extern "C" int head_ce_bwd(const void* h2, const void* wt, const float* b,
                           const int* tgt, const float* lse,
                           const float* dlse, const float* dtl, void* dh2,
                           float* dwt, float* db, int rows, int vocab, int d,
                           int splits, int dtype, void* stream) {
  if (bad_shape(rows, vocab, d) || splits < 1) return cudaErrorInvalidValue;
  BwdArgs a{h2, wt, b, tgt, lse, dlse, dtl, dh2, dwt, db,
            rows, vocab, d, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<float>(a, st);
  if (dtype == 1) return bwd<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
