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
// Bound.  At the training shape (R ~ 15k rows, D = 256, V = 5000) the
// forward does 2 R D V ~ 4e10 operations over ~11 MB of operands and the
// backward three times as many (the logits, dh2, dW): both are bound by
// operations, 0.04 and 0.12 ms at the card's bf16 tensor-core rate.
//
// The forward and the fp32 backward (v1).  The TPU keeps the whole [D, V]
// weight in VMEM (resident plan) or streams it with a sequential grid that
// carries the softmax state and the dW accumulator from one grid step to
// the next (tiled plan).  A block here has 227 KB of shared memory and
// blocks run in no order, so these kernels work on 64 x 64 logits tiles,
// recomputed from h2 and wt streamed through shared memory in 32-deep
// chunks (cp.async, double-buffered); 256 threads each own a 4 x 4 piece of
// the tile (rows ty + 16 i, columns tx + 16 j) and multiply on the fp32
// SIMT units (67 TFLOP/s).
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
//   D is a multiple of 64 whose [64, D] accumulator fits in shared memory
//   beside the staging buffers (D <= 640 fp32); the forward has no limit.
//
// The bf16 backward (v2, tensor cores).  The same two passes, as one
// kernel template (head_ce_bwd_tc) with the roles of h2 and wt swapped:
// a block of 4 warps owns 64 "outer" rows (pass a: h2 rows; pass b: vocab
// rows of wt) and walks tiles of BN "inner" rows (pass a: all vocab rows;
// pass b: its chunk of the h2 rows).  Per inner tile, each warp
//   1. forms its 16 x BN logits tile (pass b: the transposed tile) with
//      mma.sync.m16n8k16 bf16 -> fp32, operands read by ldmatrix from the
//      outer tile (resident in shared memory for the whole walk) and the
//      inner tile;
//   2. turns it into dlogits in registers (p against the saved lse; bias,
//      lse and the cotangents staged per inner row beside the tile) and
//      rounds them to bf16, packing the accumulators straight into the A
//      fragments of the next product (no trip through shared memory);
//   3. adds dlg @ inner[:, slice] into fp32 accumulators held in registers
//      (16 rows x up to 256 columns a warp; ldmatrix.trans reads the inner
//      tile, whose contraction axis is its row axis).
// Inner tiles stream through a two-stage cp.async ring (the next tile
// loads while this one multiplies).  The logits are recomputed in both
// passes (4 products of 2 R D V where the function needs 3): at the tensor
// cores' rate the fourth costs ~0.04 ms, less than a [R, V] dlg scratch
// would cost to write and read.  Pass b also sums the unrounded dlogits
// per vocab row (db) in registers; dW and db go out as per-chunk partials
// that the caller adds in chunk order: no atomics, bit-identical results
// run to run.  Output widths above 256 are cut into 256-wide slices, one
// block each (the logits recomputed per slice); D is a multiple of 64 and
// BN is 64, or 32 where a [64, D] outer tile and two [64, D] inner tiles
// do not fit in shared memory: D <= 896 (ops/head_ce.py max_head_dim
// mirrors the arithmetic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 backward on tensor cores (v2)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcOuter = 16 * kTcWarps;  // outer rows of a block
constexpr int kTcSlice = 256;            // widest output slice of a block
constexpr int kTcStages = 2;             // inner tiles in flight

// Shared memory of a block: the [64, D] outer tile, then kTcStages stages
// of a [BN, D] inner tile and 4 floats per inner row (pass a: the bias;
// pass b: lse, dlse, dtl, tgt); tiles pitched D + 8.
struct TcLayout {
  static __host__ __device__ size_t tile(int rows, int d) {
    return (size_t)rows * (d + 8) * sizeof(__nv_bfloat16);
  }
  static __host__ __device__ size_t stage(int bn, int d) {
    return tile(bn, d) + 4 * (size_t)bn * sizeof(float);
  }
  static size_t bytes(int bn, int d) {
    return tile(kTcOuter, d) + kTcStages * stage(bn, d);
  }
};

// One dlogits entry from its logit s: p against the row's saved lse, the
// target's cotangent where the column is the row's target; 0 off the
// matrix.
__device__ __forceinline__ float dlogit(float s, float bias, float lse,
                                        float dlse, float dtl, bool target,
                                        bool live) {
  if (!live) return 0.0f;
  const float p = expf(s + bias - lse);
  return dlse * p + (target ? dtl : 0.0f);
}

// kDW = false: pass (a), outer = h2 rows, inner = vocab rows, out dh2;
// kDW = true: pass (b), outer = vocab rows, inner = h2 rows of the block's
// chunk, out the dW and db partials.  grid: (outer tiles, slices) or
// (outer tiles, splits, slices).
template <int BN, bool kDW>
__global__ void __launch_bounds__(kTcThreads, 2) head_ce_bwd_tc(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int kNf = BN / 8;  // n-fragments of a logits tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, pitch = d + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  bf16* so = reinterpret_cast<bf16*>(smem);
  unsigned char* stages = smem + TcLayout::tile(kTcOuter, d);
  const size_t stage_bytes = TcLayout::stage(BN, d);

  const bf16* h2 = static_cast<const bf16*>(a.h2);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const bf16* outer = kDW ? wt : h2;
  const bf16* inner = kDW ? h2 : wt;
  const int n_outer = kDW ? a.vocab : a.rows;
  const int n_inner = kDW ? a.rows : a.vocab;
  const int outer0 = blockIdx.x * kTcOuter;
  const int d0 = (kDW ? blockIdx.z : blockIdx.y) * kTcSlice;
  const int nfr = min(kTcSlice, d - d0) / 8;  // n-fragments of the slice
  const int nt = (n_inner + BN - 1) / BN;
  int begin = 0, end = nt;
  if (kDW) {  // this block's chunk of the inner (h2 row) tiles
    const int per = (nt + a.splits - 1) / a.splits;
    begin = min(nt, (int)blockIdx.y * per);
    end = min(nt, begin + per);
  }

  // rows [row0, row0 + rows) of a [n, d] matrix into dst; rows past n zero
  auto stage_rows = [&](const bf16* src, int n, int row0, int rows,
                        bf16* dst) {
    const int per = d / 8;  // 16-byte pieces per row
    for (int e = threadIdx.x; e < rows * per; e += kTcThreads) {
      const int r = e / per, c = (e % per) * 8;
      const int row = row0 + r;
      const bool ok = row < n;
      mma::cp_async16(dst + r * pitch + c,
                      src + (size_t)(ok ? row : 0) * d + c, ok ? 16 : 0);
    }
  };
  // inner tile `it` and its per-row values into stage slot `slot`
  auto stage_inner = [&](int it, int slot) {
    unsigned char* base = stages + slot * stage_bytes;
    const int i0 = it * BN;
    stage_rows(inner, n_inner, i0, BN, reinterpret_cast<bf16*>(base));
    float* info = reinterpret_cast<float*>(base + TcLayout::tile(BN, d));
    const int n_vec = kDW ? 4 : 1;  // per-row arrays
    for (int e = threadIdx.x; e < n_vec * (BN / 4); e += kTcThreads) {
      const int which = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const float* src =
          !kDW ? a.bias
          : which == 0 ? a.lse
          : which == 1 ? a.dlse
          : which == 2 ? a.dtl
                       : reinterpret_cast<const float*>(a.tgt);
      const int left = n_inner - (i0 + c);
      mma::cp_async16(info + which * BN + c, src + (left > 0 ? i0 + c : 0),
                      left >= 4 ? 16 : left > 0 ? 4 * left : 0);
    }
  };

  // this thread's two outer rows (g and g + 8 of its warp's 16) and their
  // per-row values
  int orow[2];
  bool olive[2];
  float obias[2], olse[2], odlse[2], odtl[2];
  int otgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    orow[i] = outer0 + warp * 16 + g + 8 * i;
    olive[i] = orow[i] < n_outer;
    const int r = olive[i] ? orow[i] : 0;
    obias[i] = kDW && olive[i] ? a.bias[r] : 0.0f;
    olse[i] = !kDW && olive[i] ? a.lse[r] : 0.0f;
    odlse[i] = !kDW && olive[i] ? a.dlse[r] : 0.0f;
    odtl[i] = !kDW && olive[i] ? a.dtl[r] : 0.0f;
    otgt[i] = !kDW && olive[i] ? a.tgt[r] : -1;
  }

  float acc[kTcSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kTcSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float dbacc[2] = {0.0f, 0.0f};

  stage_rows(outer, n_outer, outer0, kTcOuter, so);
  if (begin < end) stage_inner(begin, 0);
  mma::cp_async_commit();

  for (int it = begin; it < end; ++it) {
    const int slot = (it - begin) % kTcStages;
    if (it + 1 < end) {
      stage_inner(it + 1, (slot + 1) % kTcStages);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and, first time, the outer tile) landed
    const bf16* si = reinterpret_cast<const bf16*>(stages + slot * stage_bytes);
    const float* info =
        reinterpret_cast<const float*>(stages + slot * stage_bytes +
                                       TcLayout::tile(BN, d));
    const int i0 = it * BN;

    // 1. logits: s[m][n] = outer[m] . inner[n] over D
    float s[kNf][4];
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const bf16* pa = so + (warp * 16 + mma::a_row(lane)) * pitch + mma::a_col(lane);
    const bf16* pb = si + mma::bn_row(lane) * pitch + mma::bn_col(lane);
    for (int k0 = 0; k0 < d; k0 += 16) {
      uint32_t af[4];
      mma::ldsm_x4(af, pa + k0);
#pragma unroll
      for (int jp = 0; jp < kNf / 2; ++jp) {
        uint32_t bfr[4];
        mma::ldsm_x4(bfr, pb + jp * 16 * pitch + k0);
        mma::mma_bf16(s[2 * jp], af, bfr[0], bfr[1]);
        mma::mma_bf16(s[2 * jp + 1], af, bfr[2], bfr[3]);
      }
    }

    // 2. dlogits in place (entry e of n-fragment j: outer row g + 8 (e / 2),
    // inner index j * 8 + 2 t4 + e % 2 of the tile)
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int oi = e / 2, ii = j * 8 + 2 * t4 + (e & 1);
        const bool live = olive[oi] && i0 + ii < n_inner;
        if (kDW) {  // outer = vocab row v, inner = h2 row r
          const int tg = reinterpret_cast<const int*>(info)[3 * BN + ii];
          s[j][e] = dlogit(s[j][e], obias[oi], info[ii], info[BN + ii],
                           info[2 * BN + ii], tg == orow[oi], live);
          dbacc[oi] += s[j][e];
        } else {  // outer = h2 row r, inner = vocab row v
          s[j][e] = dlogit(s[j][e], info[ii], olse[oi], odlse[oi], odtl[oi],
                           i0 + ii == otgt[oi], live);
        }
      }

    // 3. acc[m][:] += sum over the tile's n of bf16(dlogits)[m][n]
    // inner[n][d0:d0 + 256]
#pragma unroll
    for (int c = 0; c < kNf / 2; ++c) {
      uint32_t pf[4];
      mma::pack_a(pf, s[2 * c], s[2 * c + 1]);
      const bf16* pv = si + (c * 16 + mma::bk_row(lane)) * pitch + d0 +
                       mma::bk_col(lane);
#pragma unroll
      for (int np = 0; np < kTcSlice / 16; ++np) {
        if (2 * np < nfr) {
          uint32_t bfr[4];
          mma::ldsm_x4_trans(bfr, pv + np * 16);
          mma::mma_bf16(acc[2 * np], pf, bfr[0], bfr[1]);
          mma::mma_bf16(acc[2 * np + 1], pf, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this slot
  }
  mma::cp_async_wait<0>();

  // write-out: n-fragment j holds columns d0 + 8 j + 2 t4 (+1)
  if (kDW) {
    const size_t split = blockIdx.y;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // db: the quad's four partials of the row, added in a fixed order
      float x = dbacc[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (!olive[i]) continue;
      if (t4 == 0 && d0 == 0) a.db[split * a.vocab + orow[i]] = x;
      float* dst = a.dwt + (split * a.vocab + orow[i]) * d + d0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kTcSlice / 8; ++j)
        if (j < nfr)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  } else {
    bf16* dh2 = static_cast<bf16*>(a.dh2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!olive[i]) continue;
      bf16* dst = dh2 + (size_t)orow[i] * d + d0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kTcSlice / 8; ++j)
        if (j < nfr)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <int BN, bool kDW>
cudaError_t bwd_tc_pass(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = TcLayout::bytes(BN, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      head_ce_bwd_tc<BN, kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = (a.d + kTcSlice - 1) / kTcSlice;
  const dim3 grid =
      kDW ? dim3((a.vocab + kTcOuter - 1) / kTcOuter, a.splits, slices)
          : dim3((a.rows + kTcOuter - 1) / kTcOuter, slices);
  head_ce_bwd_tc<BN, kDW><<<grid, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int BN>
cudaError_t bwd_tc_bn(const BwdArgs& a, cudaStream_t st) {
  if (a.rows > 0) {  // no rows: pass (b) alone writes the zero partials
    cudaError_t err = bwd_tc_pass<BN, false>(a, st);
    if (err != cudaSuccess) return err;
  }
  return bwd_tc_pass<BN, true>(a, st);
}

// BN = 64 where it fits (D <= 576), else 32 (D <= 896)
cudaError_t bwd_tc(const BwdArgs& a, cudaStream_t st) {
  if (TcLayout::bytes(64, a.d) <= (size_t)kMaxSmem) return bwd_tc_bn<64>(a, st);
  if (TcLayout::bytes(32, a.d) <= (size_t)kMaxSmem) return bwd_tc_bn<32>(a, st);
  return cudaErrorInvalidValue;
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
// caller sums over S.  Launches pass (a) then pass (b): the v1 SIMT kernels
// for dtype 0, the tensor-core kernels for dtype 1.
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
  if (dtype == 1) return bwd_tc(a, st);
  return cudaErrorInvalidValue;
}
