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
// The fp32 forward and backward (v1).  The TPU keeps the whole [D, V]
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
//   D is a multiple of 64.  Where the [64, D] accumulator does not fit in
//   shared memory beside the staging buffers (D > 640), the output columns
//   are cut into 256-wide slices, one block each, the logits recomputed per
//   slice, and the accumulator is [64, 256].
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
// do not fit in shared memory (D <= 896).  Wider D runs head_ce_bwd_tc_wide:
// the same steps with the contraction of step 1 walked in 256-wide D
// chunks, an outer chunk and an inner chunk staged together in each slot
// of the ring; the chunks of an inner tile are walked starting after the
// block's own slice, so the last chunk staged is the slice that step 3
// multiplies (per slice, the logits are summed in another chunk order).
//
// The bf16 forward (v2, tensor cores: head_ce_fwd_tc).  Step 1 above with
// h2 as the outer tile, folded into an online softmax instead of step 2:
// per 64-column vocab tile each thread adds the staged bias to its logits,
// keeps the target's logit where its column is the row's target, and
// merges the tile into a running (max, sum of exp) per row over the
// columns it owns, in log2 units (exp2 of x log2 e).  The four threads of
// a row merge by shuffles at the end.  Where the row tiles are too few to
// fill the card, the vocab walk is cut into S contiguous chunks of tiles:
// a cluster of S blocks shares a row tile, block c walking chunk c, and
// block 0 merges the S partials (max, sum, target logit) per row in chunk
// order through distributed shared memory: no scratch in device memory, no
// atomics, the same bits on every launch.  A chunk with no live column
// gives (-inf, 0, 0), which merges as nothing.  (Training C's 238 row
// tiles already fill one wave at 2 blocks an SM: S = 1 there.)
// Bound: 2 R D V products (0.039 ms at training C's shape at an H100
// SXM's 989 TFLOP/s) and R V exp2 on the SFU (7.6e7, ~0.02 ms at 16 a
// clock on 132 SMs); h2 is read once per block, wt once per row tile
// (from L2).  It measured 0.255 ms there on an NVIDIA H100 80GB HBM3 at
// 700 W: a warp's 16-row tile reads 320 bytes of shared memory by
// ldmatrix per mma (PERF.md section 6).  The resident variant keeps the
// block's [64, D] h2 tile in shared memory for the whole walk (D <= 576);
// past that the D-chunked ring of the wide backward stages an h2 chunk
// beside each wt chunk.

#include <algorithm>
#include <cooperative_groups.h>
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
constexpr int kSlice = 256;          // widest output slice of a block
constexpr int kMaxSmem = 227 * 1024; // shared memory a block may use

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
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
// kSliced: the block's output columns are one 256-wide slice of D (grid
// dimension y in pass a, z in pass b), else all of D.
template <typename T, bool kDW, bool kSliced>
__global__ void __launch_bounds__(kThreads, 2) head_ce_bwd_kernel(BwdArgs a) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  T* win = buf;  // aliases the chunk buffers
  float* sd = reinterpret_cast<float*>(smem + L::kStage);  // [64][65] dlg
  float* sacc = sd + kTile * kSdPitch;                // [64][width + 16]
  const int d = a.d;
  const int d0 = kSliced ? (kDW ? blockIdx.z : blockIdx.y) * kSlice : 0;
  const int width = kSliced ? min(kSlice, d - d0) : d;
  const int accp = width + kAccPad;
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
    for (int w0 = d0; w0 < d0 + width; w0 += kWin) {
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
          sacc[(ty + 16 * i) * accp + w0 - d0 + tx + 16 * j] += p[i][j];
      __syncthreads();  // the window (and then the chunk buffers) is reused
    }
  }

  if (kDW) {
    // db: each column's 16 row groups added in order
#pragma unroll
    for (int j = 0; j < 4; ++j) sd[ty * kSdPitch + tx + 16 * j] = dbacc[j];
    __syncthreads();
    if (threadIdx.x < kTile && d0 == 0) {
      float s = 0.0f;
      for (int g = 0; g < 16; ++g) s += sd[g * kSdPitch + threadIdx.x];
      const int c = outer0 + threadIdx.x;
      if (c < a.vocab) a.db[(size_t)blockIdx.y * a.vocab + c] = s;
    }
    for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
      const int v = e / width, k = e % width;
      const int c = outer0 + v;
      if (c < a.vocab)
        a.dwt[((size_t)blockIdx.y * a.vocab + c) * d + d0 + k] =
            sacc[v * accp + k];
    }
  } else {
    T* dh2 = static_cast<T*>(a.dh2);
    for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
      const int r = e / width, k = e % width;
      const int row = outer0 + r;
      if (row < a.rows)
        dh2[(size_t)row * d + d0 + k] = from_float<T>(sacc[r * accp + k]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (v2): the backward, then the forward
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcOuter = 16 * kTcWarps;  // outer rows of a block
constexpr int kTcSlice = kSlice;         // widest output slice of a block
constexpr int kTcStages = 2;             // inner tiles in flight
// D chunk of the wide kernels: one output slice, so that the wide
// backward's last chunk of an inner tile is the slice step 3 reads
constexpr int kTcChunk = kTcSlice;
constexpr int kTcChunkPitch = kTcChunk + 8;

// Shared memory of a block: the [64, D] outer tile, then kTcStages stages
// of a [BN, D] inner tile and 4 floats per inner row (pass a: the bias;
// pass b: lse, dlse, dtl, tgt); tiles pitched D + 8.
struct TcLayout {
  static __host__ __device__ size_t tile(int rows, int d) {
    return (size_t)rows * (d + 8) * sizeof(bf16);
  }
  static __host__ __device__ size_t stage(int bn, int d) {
    return tile(bn, d) + 4 * (size_t)bn * sizeof(float);
  }
  static size_t bytes(int bn, int d) {
    return tile(kTcOuter, d) + kTcStages * stage(bn, d);
  }
};

// Shared memory of the D-chunked kernels: kTcStages slots, each an outer
// chunk [64, 256], an inner chunk [BN, 256] (pitched 264) and 4 floats per
// inner row.
struct TcChunkLayout {
  static __host__ __device__ size_t outer() {
    return (size_t)kTcOuter * kTcChunkPitch * sizeof(bf16);
  }
  static __host__ __device__ size_t inner(int bn) {
    return (size_t)bn * kTcChunkPitch * sizeof(bf16);
  }
  static __host__ __device__ size_t slot(int bn) {
    return outer() + inner(bn) + 4 * (size_t)bn * sizeof(float);
  }
  static size_t bytes(int bn) { return kTcStages * slot(bn); }
};

// Rows [row0, row0 + rows) x columns [c0, c0 + width) of a row-major
// [n, ld] bf16 matrix into dst (pitch elements a row) by cp.async; rows
// past n are zero-filled.  width a multiple of 8.
__device__ __forceinline__ void tc_stage(const bf16* __restrict__ src, int n,
                                         int ld, int row0, int rows, int c0,
                                         int width, bf16* dst, int pitch) {
  const int per = width / 8;  // 16-byte pieces per row
  for (int e = threadIdx.x; e < rows * per; e += kTcThreads) {
    const int r = e / per, c = (e % per) * 8;
    const int row = row0 + r;
    const bool ok = row < n;
    mma::cp_async16(dst + r * pitch + c,
                    src + (size_t)(ok ? row : 0) * ld + c0 + c, ok ? 16 : 0);
  }
}

// The per-row values of inner rows [i0, i0 + BN) beside their tile: the
// bias (pass a and the forward, kDW false) or lse, dlse, dtl and the target
// (pass b); zero past n_inner.
template <int BN, bool kDW>
__device__ __forceinline__ void tc_stage_info(
    const float* bias, const float* lse, const float* dlse, const float* dtl,
    const int* tgt, int n_inner, int i0, float* info) {
  const int n_vec = kDW ? 4 : 1;  // per-row arrays
  for (int e = threadIdx.x; e < n_vec * (BN / 4); e += kTcThreads) {
    const int which = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const float* src = !kDW        ? bias
                       : which == 0 ? lse
                       : which == 1 ? dlse
                       : which == 2 ? dtl
                                    : reinterpret_cast<const float*>(tgt);
    const int left = n_inner - (i0 + c);
    mma::cp_async16(info + which * BN + c, src + (left > 0 ? i0 + c : 0),
                    left >= 4 ? 16 : left > 0 ? 4 * left : 0);
  }
}

// Step 1: a warp's 16 x (8 kNf) logits tile s += A B^T over `width`
// columns of the contraction; A is 16 rows at pa, B is 8 kNf rows at pb,
// both row-major (pitches in elements), with the lane offsets of
// mma::a_row / a_col (pa) and bn_row / bn_col (pb) applied.
template <int kNf>
__device__ __forceinline__ void tc_logits(float (&s)[kNf][4], const bf16* pa,
                                          int pitch_a, const bf16* pb,
                                          int pitch_b, int width) {
  for (int k0 = 0; k0 < width; k0 += 16) {
    uint32_t af[4];
    mma::ldsm_x4(af, pa + k0);
#pragma unroll
    for (int jp = 0; jp < kNf / 2; ++jp) {
      uint32_t bfr[4];
      mma::ldsm_x4(bfr, pb + jp * 16 * pitch_b + k0);
      mma::mma_bf16(s[2 * jp], af, bfr[0], bfr[1]);
      mma::mma_bf16(s[2 * jp + 1], af, bfr[2], bfr[3]);
    }
  }
}

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

// A thread's two outer rows of the backward (g and g + 8 of its warp's 16)
// and their per-row values.
template <bool kDW>
struct OuterRows {
  int row[2];
  bool live[2];
  float bias[2], lse[2], dlse[2], dtl[2];
  int tgt[2];
  __device__ __forceinline__ OuterRows(const BwdArgs& a, int outer0,
                                       int warp, int g) {
    const int n_outer = kDW ? a.vocab : a.rows;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row[i] = outer0 + warp * 16 + g + 8 * i;
      live[i] = row[i] < n_outer;
      const int r = live[i] ? row[i] : 0;
      bias[i] = kDW && live[i] ? a.bias[r] : 0.0f;
      lse[i] = !kDW && live[i] ? a.lse[r] : 0.0f;
      dlse[i] = !kDW && live[i] ? a.dlse[r] : 0.0f;
      dtl[i] = !kDW && live[i] ? a.dtl[r] : 0.0f;
      tgt[i] = !kDW && live[i] ? a.tgt[r] : -1;
    }
  }
};

// Step 2: dlogits in place (entry e of n-fragment j: outer row g + 8 (e / 2),
// inner index j * 8 + 2 t4 + e % 2 of the tile at inner row i0); pass b
// also sums them per outer (vocab) row into dbacc.
template <int BN, bool kDW>
__device__ __forceinline__ void tc_dlogits(float (&s)[BN / 8][4],
                                           float (&dbacc)[2],
                                           const OuterRows<kDW>& o,
                                           const float* info, int i0,
                                           int n_inner, int t4) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int oi = e / 2, ii = j * 8 + 2 * t4 + (e & 1);
      const bool live = o.live[oi] && i0 + ii < n_inner;
      if (kDW) {  // outer = vocab row v, inner = h2 row r
        const int tg = reinterpret_cast<const int*>(info)[3 * BN + ii];
        s[j][e] = dlogit(s[j][e], o.bias[oi], info[ii], info[BN + ii],
                         info[2 * BN + ii], tg == o.row[oi], live);
        dbacc[oi] += s[j][e];
      } else {  // outer = h2 row r, inner = vocab row v
        s[j][e] = dlogit(s[j][e], info[ii], o.lse[oi], o.dlse[oi], o.dtl[oi],
                         i0 + ii == o.tgt[oi], live);
      }
    }
}

// Step 3: acc[m][:] += sum over the tile's n of bf16(dlogits)[m][n]
// inner[n][slice], the slice's nfr n-fragments read from pv (the slice's
// first column of inner row 0, pitch in elements).
template <int kNf>
__device__ __forceinline__ void tc_accumulate(float (&acc)[kTcSlice / 8][4],
                                              const float (&s)[kNf][4],
                                              const bf16* pv, int pitch,
                                              int nfr, int lane) {
#pragma unroll
  for (int c = 0; c < kNf / 2; ++c) {
    uint32_t pf[4];
    mma::pack_a(pf, s[2 * c], s[2 * c + 1]);
    const bf16* p = pv + (c * 16 + mma::bk_row(lane)) * pitch + mma::bk_col(lane);
#pragma unroll
    for (int np = 0; np < kTcSlice / 16; ++np) {
      if (2 * np < nfr) {
        uint32_t bfr[4];
        mma::ldsm_x4_trans(bfr, p + np * 16);
        mma::mma_bf16(acc[2 * np], pf, bfr[0], bfr[1]);
        mma::mma_bf16(acc[2 * np + 1], pf, bfr[2], bfr[3]);
      }
    }
  }
}

// Write-out: n-fragment j holds columns d0 + 8 j + 2 t4 (+1).
template <bool kDW>
__device__ __forceinline__ void tc_write(const BwdArgs& a,
                                         const float (&acc)[kTcSlice / 8][4],
                                         const float (&dbacc)[2],
                                         const OuterRows<kDW>& o, int d0,
                                         int nfr, int t4) {
  const int d = a.d;
  if (kDW) {
    const size_t split = blockIdx.y;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // db: the quad's four partials of the row, added in a fixed order
      float x = dbacc[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (!o.live[i]) continue;
      if (t4 == 0 && d0 == 0) a.db[split * a.vocab + o.row[i]] = x;
      float* dst = a.dwt + (split * a.vocab + o.row[i]) * d + d0 + 2 * t4;
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
      if (!o.live[i]) continue;
      bf16* dst = dh2 + (size_t)o.row[i] * d + d0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kTcSlice / 8; ++j)
        if (j < nfr)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// kDW = false: pass (a), outer = h2 rows, inner = vocab rows, out dh2;
// kDW = true: pass (b), outer = vocab rows, inner = h2 rows of the block's
// chunk, out the dW and db partials.  grid: (outer tiles, slices) or
// (outer tiles, splits, slices).
template <int BN, bool kDW>
__global__ void __launch_bounds__(kTcThreads, 2) head_ce_bwd_tc(BwdArgs a) {
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

  // inner tile `it` and its per-row values into stage slot `slot`
  auto stage_inner = [&](int it, int slot) {
    unsigned char* base = stages + slot * stage_bytes;
    const int i0 = it * BN;
    tc_stage(inner, n_inner, d, i0, BN, 0, d, reinterpret_cast<bf16*>(base),
             pitch);
    tc_stage_info<BN, kDW>(a.bias, a.lse, a.dlse, a.dtl, a.tgt, n_inner, i0,
                           reinterpret_cast<float*>(base + TcLayout::tile(BN, d)));
  };

  const OuterRows<kDW> o(a, outer0, warp, g);
  float acc[kTcSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kTcSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float dbacc[2] = {0.0f, 0.0f};

  tc_stage(outer, n_outer, d, outer0, kTcOuter, 0, d, so, pitch);
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

    // 1. logits: s[m][n] = outer[m] . inner[n] over D
    float s[kNf][4];
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    tc_logits<kNf>(
        s, so + (warp * 16 + mma::a_row(lane)) * pitch + mma::a_col(lane),
        pitch, si + mma::bn_row(lane) * pitch + mma::bn_col(lane), pitch, d);
    // 2. dlogits in place; 3. acc += bf16(dlogits) @ inner[:, slice]
    tc_dlogits<BN, kDW>(s, dbacc, o, info, it * BN, n_inner, t4);
    tc_accumulate<kNf>(acc, s, si + d0, pitch, nfr, lane);
    __syncthreads();  // the next iteration's prefetch overwrites this slot
  }
  mma::cp_async_wait<0>();
  tc_write<kDW>(a, acc, dbacc, o, d0, nfr, t4);
}

// head_ce_bwd_tc past the width where the [64, D] outer tile and two
// [BN, D] inner tiles fit (D > 896): each slot of the ring holds a 256-wide
// D chunk of the outer tile and of the inner tile.  Step q of the walk is
// inner tile begin + q / nc, chunk (z + 1 + q % nc) % nc of nc, where z is
// the block's output slice: the slice's own chunk comes last, and step 3
// reads it where it was staged.  Grid as head_ce_bwd_tc's.
template <int BN, bool kDW>
__global__ void __launch_bounds__(kTcThreads, 2)
    head_ce_bwd_tc_wide(BwdArgs a) {
  constexpr int kNf = BN / 8;
  constexpr int P = kTcChunkPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t slot_bytes = TcChunkLayout::slot(BN);

  const bf16* h2 = static_cast<const bf16*>(a.h2);
  const bf16* wt = static_cast<const bf16*>(a.wt);
  const bf16* outer = kDW ? wt : h2;
  const bf16* inner = kDW ? h2 : wt;
  const int n_outer = kDW ? a.vocab : a.rows;
  const int n_inner = kDW ? a.rows : a.vocab;
  const int outer0 = blockIdx.x * kTcOuter;
  const int z = kDW ? blockIdx.z : blockIdx.y;
  const int d0 = z * kTcSlice;
  const int nfr = min(kTcSlice, d - d0) / 8;
  const int nc = (d + kTcChunk - 1) / kTcChunk;
  const int nt = (n_inner + BN - 1) / BN;
  int begin = 0, end = nt;
  if (kDW) {
    const int per = (nt + a.splits - 1) / a.splits;
    begin = min(nt, (int)blockIdx.y * per);
    end = min(nt, begin + per);
  }
  const int steps = (end - begin) * nc;

  auto stage_step = [&](int q, int slot) {
    unsigned char* base = smem + slot * slot_bytes;
    const int i0 = (begin + q / nc) * BN;
    const int c0 = (z + 1 + q % nc) % nc * kTcChunk;
    const int w = min(kTcChunk, d - c0);
    tc_stage(outer, n_outer, d, outer0, kTcOuter, c0, w,
             reinterpret_cast<bf16*>(base), P);
    tc_stage(inner, n_inner, d, i0, BN, c0, w,
             reinterpret_cast<bf16*>(base + TcChunkLayout::outer()), P);
    if (q % nc == nc - 1)
      tc_stage_info<BN, kDW>(
          a.bias, a.lse, a.dlse, a.dtl, a.tgt, n_inner, i0,
          reinterpret_cast<float*>(base + TcChunkLayout::outer() +
                                   TcChunkLayout::inner(BN)));
  };

  const OuterRows<kDW> o(a, outer0, warp, g);
  float acc[kTcSlice / 8][4];
#pragma unroll
  for (int j = 0; j < kTcSlice / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float dbacc[2] = {0.0f, 0.0f};
  float s[kNf][4];

  if (steps > 0) stage_step(0, 0);
  mma::cp_async_commit();
  for (int q = 0; q < steps; ++q) {
    const int slot = q % kTcStages;
    if (q + 1 < steps) {
      stage_step(q + 1, (slot + 1) % kTcStages);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // step q's chunks landed
    const unsigned char* base = smem + slot * slot_bytes;
    const bf16* so = reinterpret_cast<const bf16*>(base);
    const bf16* si =
        reinterpret_cast<const bf16*>(base + TcChunkLayout::outer());
    const int k = q % nc;
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < kNf; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    const int w = min(kTcChunk, d - (z + 1 + k) % nc * kTcChunk);
    tc_logits<kNf>(s, so + (warp * 16 + mma::a_row(lane)) * P + mma::a_col(lane),
                   P, si + mma::bn_row(lane) * P + mma::bn_col(lane), P, w);
    if (k == nc - 1) {  // the tile's logits are whole; si is the slice
      const float* info = reinterpret_cast<const float*>(
          base + TcChunkLayout::outer() + TcChunkLayout::inner(BN));
      tc_dlogits<BN, kDW>(s, dbacc, o, info, (begin + q / nc) * BN, n_inner,
                          t4);
      tc_accumulate<kNf>(acc, s, si, P, nfr, lane);
    }
    __syncthreads();  // the next prefetch overwrites this slot
  }
  mma::cp_async_wait<0>();
  tc_write<kDW>(a, acc, dbacc, o, d0, nfr, t4);
}

cudaError_t bwd_tc_pass(void (*kernel)(BwdArgs), bool dw, size_t smem,
                        const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = (a.d + kTcSlice - 1) / kTcSlice;
  const dim3 grid =
      dw ? dim3((a.vocab + kTcOuter - 1) / kTcOuter, a.splits, slices)
         : dim3((a.rows + kTcOuter - 1) / kTcOuter, slices);
  kernel<<<grid, kTcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// pass (a) then pass (b)
cudaError_t bwd_tc_passes(void (*pass_a)(BwdArgs), void (*pass_b)(BwdArgs),
                          size_t smem, const BwdArgs& a, cudaStream_t st) {
  if (a.rows > 0) {  // no rows: pass (b) alone writes the zero partials
    cudaError_t err = bwd_tc_pass(pass_a, false, smem, a, st);
    if (err != cudaSuccess) return err;
  }
  return bwd_tc_pass(pass_b, true, smem, a, st);
}

// BN = 64 where it fits (D <= 576), else 32 (D <= 896), else the D-chunked
// kernels
cudaError_t bwd_tc(const BwdArgs& a, cudaStream_t st) {
  if (TcLayout::bytes(64, a.d) <= (size_t)kMaxSmem)
    return bwd_tc_passes(head_ce_bwd_tc<64, false>, head_ce_bwd_tc<64, true>,
                         TcLayout::bytes(64, a.d), a, st);
  if (TcLayout::bytes(32, a.d) <= (size_t)kMaxSmem)
    return bwd_tc_passes(head_ce_bwd_tc<32, false>, head_ce_bwd_tc<32, true>,
                         TcLayout::bytes(32, a.d), a, st);
  return bwd_tc_passes(head_ce_bwd_tc_wide<64, false>,
                       head_ce_bwd_tc_wide<64, true>,
                       TcChunkLayout::bytes(64), a, st);
}

// ---------------------------------------------------------------------------
// the bf16 forward on tensor cores (v2)
// ---------------------------------------------------------------------------

constexpr int kFwdBN = 64;       // vocab columns of a tile
constexpr int kFwdMaxSplits = 8;  // the largest portable cluster
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdArgs {
  const bf16* h2;     // [R, D]
  const bf16* wt;     // [V, D]
  const float* bias;  // [V]
  const int* tgt;     // [R]
  float* lse;         // [R]
  float* tl;          // [R]
  int rows;
  int vocab;
  int d;
};

// (m, s) <- the merge of two online softmax states (max and sum of exp in
// log2 units); -inf maxima merge as nothing (no inf - inf)
__device__ __forceinline__ void merge_state(float& m, float& s, float mo,
                                            float so) {
  const float mn = fmaxf(m, mo);
  const float mu = mn == -INFINITY ? 0.0f : mn;
  s = s * exp2f(m - mu) + so * exp2f(mo - mu);
  m = mn;
}

// Fold a warp's 16 x 64 logits tile (bias not yet added) at vocab columns
// [col0, col0 + 64) into the online state of the thread's two rows (g and
// g + 8): m the running max and sum the running sum of exp over the
// columns the thread owns, in log2 units; tl the target's logit.
__device__ __forceinline__ void fold_tile(const float (&s)[kFwdBN / 8][4],
                                          const float* bias, int col0,
                                          int vocab, int t4,
                                          const int (&tg)[2], float (&m)[2],
                                          float (&sum)[2], float (&tl)[2]) {
  constexpr int kNf = kFwdBN / 8;
  float b[kNf][2];
#pragma unroll
  for (int j = 0; j < kNf; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) b[j][e] = bias[j * 8 + 2 * t4 + e];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x[kNf][2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + j * 8 + 2 * t4 + e;
        const float v = s[j][2 * i + e] + b[j][e];
        if (col == tg[i]) tl[i] = v;
        x[j][e] = col < vocab ? v * kLog2e : -INFINITY;
        mx = fmaxf(mx, x[j][e]);
      }
    const float mn = fmaxf(m[i], mx);
    const float mu = mn == -INFINITY ? 0.0f : mn;
    float acc = sum[i] * exp2f(m[i] - mu);
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc += exp2f(x[j][e] - mu);
    sum[i] = acc;
    m[i] = mn;
  }
}

// Grid (S, row tiles) in clusters of (S, 1, 1): block c walks vocab tiles
// [c nt / S, (c + 1) nt / S) of its 64-row tile.  kWide: the D-chunked
// ring (D > 576), else the row tile resident.
template <bool kWide>
__global__ void __launch_bounds__(kTcThreads, 2) head_ce_fwd_tc(FwdArgs a) {
  constexpr int kNf = kFwdBN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part[3][kTcOuter];  // the block's (max, sum, tl) per row
  const int d = a.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = blockIdx.y * kTcOuter;
  const int splits = gridDim.x, chunk = blockIdx.x;
  const int nt = (a.vocab + kFwdBN - 1) / kFwdBN;
  const int begin = chunk * nt / splits, end = (chunk + 1) * nt / splits;
  const int nc = kWide ? (d + kTcChunk - 1) / kTcChunk : 1;
  const int steps = (end - begin) * nc;
  // resident: the [64, D] h2 tile, then slots of a [64, D] wt tile and its
  // bias; wide: slots of TcChunkLayout
  const int pitch = kWide ? kTcChunkPitch : d + 8;
  unsigned char* ring = kWide ? smem : smem + TcLayout::tile(kTcOuter, d);
  const size_t slot_bytes =
      kWide ? TcChunkLayout::slot(kFwdBN) : TcLayout::stage(kFwdBN, d);
  const size_t inner_off = kWide ? TcChunkLayout::outer() : 0;
  const size_t bias_off = kWide ? TcChunkLayout::outer() +
                                      TcChunkLayout::inner(kFwdBN)
                                : TcLayout::tile(kFwdBN, d);

  auto stage_step = [&](int q, int slot) {
    unsigned char* base = ring + slot * slot_bytes;
    const int i0 = (begin + q / nc) * kFwdBN;
    const int c0 = q % nc * kTcChunk;
    const int w = kWide ? min(kTcChunk, d - c0) : d;
    if (kWide)
      tc_stage(a.h2, a.rows, d, row0, kTcOuter, c0, w,
               reinterpret_cast<bf16*>(base), pitch);
    tc_stage(a.wt, a.vocab, d, i0, kFwdBN, c0, w,
             reinterpret_cast<bf16*>(base + inner_off), pitch);
    if (q % nc == nc - 1)
      tc_stage_info<kFwdBN, false>(a.bias, nullptr, nullptr, nullptr,
                                   nullptr, a.vocab, i0,
                                   reinterpret_cast<float*>(base + bias_off));
  };

  int tg[2];
  float m[2], sum[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + g + 8 * i;
    tg[i] = r < a.rows ? a.tgt[r] : -1;
    m[i] = -INFINITY;
    sum[i] = 0.0f;
    tl[i] = 0.0f;
  }
  if (!kWide)
    tc_stage(a.h2, a.rows, d, row0, kTcOuter, 0, d,
             reinterpret_cast<bf16*>(smem), pitch);
  if (steps > 0) stage_step(0, 0);
  mma::cp_async_commit();

  float s[kNf][4];
  for (int q = 0; q < steps; ++q) {
    const int slot = q % kTcStages;
    if (q + 1 < steps) {
      stage_step(q + 1, (slot + 1) % kTcStages);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // step q's tiles (and, first time, the h2 tile) landed
    const unsigned char* base = ring + slot * slot_bytes;
    const bf16* so = kWide ? reinterpret_cast<const bf16*>(base)
                           : reinterpret_cast<const bf16*>(smem);
    const bf16* si = reinterpret_cast<const bf16*>(base + inner_off);
    const int k = q % nc;
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < kNf; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    const int w = kWide ? min(kTcChunk, d - k * kTcChunk) : d;
    tc_logits<kNf>(
        s, so + (warp * 16 + mma::a_row(lane)) * pitch + mma::a_col(lane),
        pitch, si + mma::bn_row(lane) * pitch + mma::bn_col(lane), pitch, w);
    if (k == nc - 1)
      fold_tile(s, reinterpret_cast<const float*>(base + bias_off),
                (begin + q / nc) * kFwdBN, a.vocab, t4, tg, m, sum, tl);
    __syncthreads();  // the next prefetch overwrites this slot
  }
  mma::cp_async_wait<0>();

  // the four threads of a row (lanes 4 g .. 4 g + 3), then the block's
  // partials by row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, sum[i], off);
      tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], off);
      merge_state(m[i], sum[i], mo, so);
    }
    if (t4 == 0) {
      const int r = warp * 16 + g + 8 * i;
      part[0][r] = m[i];
      part[1][r] = sum[i];
      part[2][r] = tl[i];
    }
  }
  // block 0 of the cluster merges the chunks' partials in chunk order
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (chunk == 0 && threadIdx.x < kTcOuter) {
    const int r = threadIdx.x, row = row0 + r;
    float mm = -INFINITY, ss = 0.0f, tt = 0.0f;
    for (int c = 0; c < splits; ++c) {
      const float* p = cluster.map_shared_rank(&part[0][0], c);
      merge_state(mm, ss, p[r], p[kTcOuter + r]);
      tt += p[2 * kTcOuter + r];
    }
    if (row < a.rows) {
      a.lse[row] = (mm + log2f(ss)) * kLn2;
      a.tl[row] = tt;
    }
  }
  cluster.sync();  // the partials stay until block 0 has read them
}

bool fwd_tc_resident(int d) {
  return TcLayout::bytes(kFwdBN, d) + 3 * kTcOuter * sizeof(float) <=
         (size_t)kMaxSmem;
}

template <bool kWide>
size_t fwd_tc_smem(int d) {
  return kWide ? TcChunkLayout::bytes(kFwdBN) : TcLayout::bytes(kFwdBN, d);
}

// The split S of the vocab walk: the most chunks (at most 8, at most one
// per vocab tile) whose blocks the card still holds all at once, and 1
// where the row tiles alone fill a wave.  Training C's 238 row tiles take
// S = 1: splitting them further (S = 2-8) measured 2-28 % slower on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's split sweep).
template <bool kWide>
cudaError_t fwd_tc_splits(int rows, int vocab, int d, int* splits) {
  const size_t smem = fwd_tc_smem<kWide>(d);
  cudaError_t err = cudaFuncSetAttribute(
      head_ce_fwd_tc<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, head_ce_fwd_tc<kWide>, kTcThreads, smem)) != cudaSuccess)
    return err;
  const int row_tiles = (rows + kTcOuter - 1) / kTcOuter;
  const int nt = (vocab + kFwdBN - 1) / kFwdBN;
  const int fit = per_sm * sms / row_tiles;
  *splits = std::max(1, std::min({fit, kFwdMaxSplits, nt}));
  return cudaSuccess;
}

template <bool kWide>
cudaError_t fwd_tc_launch(const FwdArgs& a, int splits, cudaStream_t st) {
  const size_t smem = fwd_tc_smem<kWide>(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      head_ce_fwd_tc<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.rows + kTcOuter - 1) / kTcOuter, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, head_ce_fwd_tc<kWide>, a);
  // a refused launch leaves its error as the thread's last error: take it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// splits = 0: the rule of fwd_tc_splits; else S in [1, 8]
cudaError_t fwd_tc(const FwdArgs& a, int splits, cudaStream_t st) {
  const bool wide = !fwd_tc_resident(a.d);
  if (splits == 0) {
    cudaError_t err =
        wide ? fwd_tc_splits<true>(a.rows, a.vocab, a.d, &splits)
             : fwd_tc_splits<false>(a.rows, a.vocab, a.d, &splits);
    if (err != cudaSuccess) return err;
  }
  if (splits < 1 || splits > kFwdMaxSplits) return cudaErrorInvalidValue;
  return wide ? fwd_tc_launch<true>(a, splits, st)
              : fwd_tc_launch<false>(a, splits, st);
}

bool bad_shape(int rows, int vocab, int d) {
  return rows < 0 || vocab <= 0 || d <= 0 || d % kWin;
}

cudaError_t fwd_f32(const void* h2, const void* wt, const float* b,
                    const int* tgt, float* lse, float* tl, int rows,
                    int vocab, int d, cudaStream_t st) {
  const dim3 grid((rows + kTile - 1) / kTile);
  head_ce_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(h2), static_cast<const float*>(wt), b, tgt,
      lse, tl, rows, vocab, d);
  return cudaGetLastError();
}

template <typename T, bool kDW, bool kSliced>
cudaError_t bwd_pass(const BwdArgs& a, cudaStream_t st) {
  const size_t smem = Layout<T>::bwd_smem(kSliced ? kSlice : a.d);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_ce_bwd_kernel<T, kDW, kSliced>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = kSliced ? (a.d + kSlice - 1) / kSlice : 1;
  const dim3 grid =
      kDW ? dim3((a.vocab + kTile - 1) / kTile, a.splits, slices)
          : dim3((a.rows + kTile - 1) / kTile, slices);
  head_ce_bwd_kernel<T, kDW, kSliced><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kSliced>
cudaError_t bwd_passes(const BwdArgs& a, cudaStream_t st) {
  if (a.rows > 0) {  // no rows: pass (b) alone writes the zero partials
    cudaError_t err = bwd_pass<T, false, kSliced>(a, st);
    if (err != cudaSuccess) return err;
  }
  return bwd_pass<T, true, kSliced>(a, st);
}

// one block a row (or vocab) tile where its [64, D] accumulator fits
// (D <= 640), else a block per tile and 256-wide output slice
template <typename T>
cudaError_t bwd(const BwdArgs& a, cudaStream_t st) {
  if (Layout<T>::bwd_smem(a.d) <= (size_t)kMaxSmem)
    return bwd_passes<T, false>(a, st);
  return bwd_passes<T, true>(a, st);
}

}  // namespace

// dtype: 0 = fp32 operands (the v1 SIMT kernel), 1 = bf16 operands (h2
// and wt; the tensor-core kernel, its vocab walk split by the rule of
// fwd_tc_splits).  h2 [R, D], wt [V, D] (the head w [D, V] transposed,
// row-major), b [V] fp32, tgt [R] int32; lse, tl [R] fp32 (out).  D a
// multiple of 64.  Returns a cudaError_t code (0 = launched).
extern "C" int head_ce_fwd(const void* h2, const void* wt, const float* b,
                           const int* tgt, float* lse, float* tl, int rows,
                           int vocab, int d, int dtype, void* stream) {
  if (bad_shape(rows, vocab, d)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_f32(h2, wt, b, tgt, lse, tl, rows, vocab, d, st);
  if (dtype == 1)
    return fwd_tc(FwdArgs{static_cast<const bf16*>(h2),
                          static_cast<const bf16*>(wt), b, tgt, lse, tl, rows,
                          vocab, d},
                  0, st);
  return cudaErrorInvalidValue;
}

// The bf16 forward with its vocab walk split into `splits` chunks (1-8)
// instead of the rule's: the same results up to the order of the sums.
extern "C" int head_ce_fwd_split(const void* h2, const void* wt,
                                 const float* b, const int* tgt, float* lse,
                                 float* tl, int rows, int vocab, int d,
                                 int splits, void* stream) {
  if (bad_shape(rows, vocab, d) || splits < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  return fwd_tc(FwdArgs{static_cast<const bf16*>(h2),
                        static_cast<const bf16*>(wt), b, tgt, lse, tl, rows,
                        vocab, d},
                splits, static_cast<cudaStream_t>(stream));
}

// The split the bf16 forward takes at (rows, vocab, d) on the current
// device, or a negated cudaError_t code.
extern "C" int head_ce_fwd_splits(int rows, int vocab, int d) {
  if (bad_shape(rows, vocab, d) || rows == 0) return -cudaErrorInvalidValue;
  int splits = 0;
  const cudaError_t err =
      fwd_tc_resident(d) ? fwd_tc_splits<false>(rows, vocab, d, &splits)
                         : fwd_tc_splits<true>(rows, vocab, d, &splits);
  return err == cudaSuccess ? splits : -(int)err;
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
