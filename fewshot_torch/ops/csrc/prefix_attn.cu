// Episodic prefix attention kernels for Hopper (sm_90a), plain C interface.
//
// Replace the TPU kernels of fewshot/ops/prefix_attention.py, which compute
// one function under three VMEM plans:
//   * `_fwd_kernel` (streaming), `_res_fwd_kernel` (resident, heads-outer)
//     and `_tm_fwd_kernel` (resident, token-major)    -> prefix_attn_fwd
//   * `_dq_kernel`, and the dq part of `_res_bwd_kernel` and
//     `_tm_bwd_kernel`                                 -> prefix_attn_bwd_dq
//   * `_dkv_kernel` (one call per branch), and the dk/dv parts of
//     `_res_bwd_kernel` and `_tm_bwd_kernel`           -> prefix_attn_bwd_dkv
// and, with no prefix, the causal self-attention of JAX's shipped TPU flash
// kernel (fewshot/ops/attention.py `_flash_attention`).
//
// Each of S query songs (T rows, E = nh * hd features, token-major: heads
// are hd-wide column slices of E) attends to its episode's prefix (P keys,
// key-masked, shared by the episode's Q songs: episode = song / Q) and to
// itself (causal, key-masked).  Per head, with scale = 1 / sqrt(hd):
//   s = q k^T scale, masked keys and keys past the diagonal set to -1e30;
//   out = softmax(s) v,  lse = logsumexp(s)   (fp32)
// and, given the cotangent g (rounded to the stream dtype) and
// delta = rowsum(g_fp32 * out) per head (computed by the caller):
//   p = exp(s - lse),  ds = p (g v^T - delta) scale
//   dq = ds k,  dk = ds^T q,  dv = p^T g     (prefix dk/dv summed over the
//   episode's Q songs)
// Rounding points are the TPU kernels': operands in the stream dtype (bf16
// or fp32) with fp32 products and sums; p (unnormalised, against the running
// row maximum as in the streaming plan) rounded to the stream dtype before
// p v; p and ds rounded before their products in the backward; outputs fp32.
//
// Design (v1: every fp32 kernel).  A TPU grid runs in order and carries
// the softmax state and the dk/dv accumulators from one grid step to the
// next; blocks here run in no order, so each block owns its outputs and
// loops over what they need:
//   * Forward: one block per (64-row query tile, head, song).  The q tile
//     stays in shared memory; the block walks 64-key tiles, first the
//     episode's prefix tiles (read in place from the [B, P, E] prefix, never
//     replicated: the Q songs' blocks share it through L2), then the song's
//     own tiles up to the diagonal (tiles wholly above it are skipped), with
//     an online (max, sum) per row in fp32.
//   * dq: one block per query tile, the same walk, dq accumulated in fp32
//     registers.
//   * dk/dv: one block per (64-key tile, head, branch item).  A prefix key
//     tile loops over every query tile of its episode's Q songs; a self key
//     tile over its song's query tiles from the diagonal down.  dk and dv
//     accumulate in fp32 registers of the block: no float atomics, and the
//     sums run in a fixed order (deterministic).
// 256 threads each own a 4 x 4 piece of a 64 x 64 score tile (rows ty + 16 i,
// columns tx + 16 j) and 4 rows x hd / 16 columns of a [64, hd] accumulator,
// and multiply on the fp32 SIMT units; in fp32 no rounding point rounds.
//
// The bf16 forward (v2, tensor cores; fwd_tc_kernel), FlashAttention-2
// style, on the same grid and walk: 4 warps, each owning 16 of the block's
// 64 query rows.  A warp keeps its q rows as mma A fragments in registers
// for the whole walk; per key tile it forms its 16 x 64 scores with
// mma.sync.m16n8k16 bf16 -> fp32 (K read by ldmatrix), masks and scales
// them, updates its rows' running max and sum in registers (quad shuffles
// for the max, the sum reduced once at the end), rounds p = exp(s - running
// max) to bf16 in registers -- the TPU kernel's rounding point -- and feeds
// it straight back as the A fragment of p v (V read by ldmatrix.trans).
// K, V and the key mask go through a two-stage cp.async ring, so the next
// tile loads while this one multiplies; the q tile borrows the ring's
// second stage before the walk starts, which leaves a block 70 KB of
// shared memory at hd = 128 and lets three blocks share an SM (with two,
// the warps stalled issuing each next tile's copies: the kernel is bound
// by its K/V traffic from L2, and more resident warps hide it).  A warp
// whose 16 rows all lie past T (the second tile of a T = 95 song) or
// wholly above the diagonal of a self tile skips the math.  One block
// takes one song: the episode's Q songs read the same prefix tiles through
// L2 (0.25 MB per episode and head at the training shape), which costs
// less than the serialisation of one block per episode.
//
// The bf16 backward (v2, tensor cores; dq_tc_kernel, dkv_tc_kernel)
// replaces `_dq_kernel` and `_dkv_kernel` (streaming plan) and the
// backward halves of `_res_bwd_kernel` and `_tm_bwd_kernel` (fed, as the
// token-major VJP feeds them, the global lse and delta).  Two kernels, each
// computing the score tile in the orientation its outputs need, so that
// each product's A operand comes straight out of the previous product's
// accumulators (mma.cuh pack_a):
//   * dq_tc_kernel: the forward's grid, walk and ring; a warp keeps its 16
//     rows of q and g as A fragments, forms s = q k^T and dp = g v^T, then
//     ds = p (dp - delta) scale in registers, and feeds bf16(ds) into
//     dq += ds k (K by ldmatrix.trans).
//   * dkv_tc_kernel: v1's key-tile grid; a warp owns 16 keys as the M
//     dimension, forms s^T = k q^T and dp^T = v g^T, and feeds bf16(p^T)
//     and bf16(ds^T) into dv += p^T g and dk += ds^T q.  The self branch's
//     causal mask is the forward's transposed (key c sees row r >= c).  K
//     and V stay resident in shared memory and their A fragments are read
//     by ldmatrix at each use: as registers beside the 128 of dk and dv
//     they would spill.  Q, G, lse and delta stream through a two-stage
//     cp.async ring.
// A pass covers 32 keys (dq) or 32 query rows (dk/dv) of a 64-wide tile,
// so a warp holds two 16 x 32 fp32 tiles beside its accumulators (209 and
// 234 registers at hd = 128, no spills: two blocks an SM), and skips a pass
// wholly past the sequence or on the masked side of the diagonal.  One
// fused pass for dq and dk/dv cannot own both dq (query-major) and the
// prefix dk/dv (summed over the episode's Q songs) without a cross-block
// reduction: float atomics (run-dependent sums) or per-key-tile dq
// partials (~10x dq's bytes at the training shape).  Two kernels recompute
// s and dp (7 products against 5) and stay deterministic: every block owns
// its outputs and sums in a fixed order, with no atomics.
//
// Masked keys carry the finite -1e30, never -inf, and l == 0 -> 1 and
// log(max(l, 1e-30)) guard the division and the log, so a row whose every
// key is masked stays finite; keys past the end of a sequence (the partial
// last tile) are excluded outright.
//
// Head widths.  hd is a multiple of 16 here (ops/prefix_attention.py pads
// any other head with zero columns, which change no score, and passes the
// scale of the unpadded head).  The tensor-core kernels hold hd / 8 fp32
// accumulator fragments a thread and stop at hd = 128.  A wider head, in
// either dtype, runs the v1 kernels as column windows of at most 128
// (blockIdx.z): each window owns its output columns and recomputes the
// scores over the whole head, staging it 128 columns at a time, so shared
// memory and registers do not grow with hd; bf16 there rounds p and ds at
// the tensor-core kernels' points.  Scores are recomputed once per window.
//
// Bound.  At the training shape (S = 160 songs of T = 95 rows, P = 480, E =
// 256, bf16) the forward reads ~39 MB (q, k, v, the prefix k, v) and writes
// 15.6 MB of fp32 output against ~4 GFLOP over the real (row, key) pairs,
// so it is bound by bytes on this card (~16 us at 3.35 TB/s, ~4 us of bf16
// tensor-core operations); dq and dk/dv move about as many bytes for 1.5x
// and 2x the operations.  The v1 kernels multiply on the fp32 SIMT units
// (67 TFLOP/s peak) and stage synchronously, far from both bounds.  The v2
// kernels are latency-bound: mma.sync with 16 rows a warp and two to three
// blocks an SM leave each warp's chain of shared-memory loads, products and
// exponentials exposed; wgmma on 64-row warpgroup tiles fed by TMA is the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kTile = 64;             // query rows and keys of a score tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kSPitch = kTile + 1;    // floats per row of a score tile
constexpr int kMaxHd = 128;
constexpr int kMaxCols = kMaxHd / 16;  // accumulator columns per thread
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 227 * 1024;

// 16 bytes as floats
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

struct Args {
  const void* q;        // [S, T, E] stream dtype
  const void* k;        // [S, T, E]
  const void* v;        // [S, T, E]
  const float* kmask;   // [S, T], > 0 = real key
  const void* pk;       // [B, P, E] (null when P == 0)
  const void* pv;       // [B, P, E]
  const float* pmask;   // [B, P]
  const void* g;        // [S, T, E] cotangent, stream dtype (backward)
  const float* lse;     // [S, nh, T] (backward in; forward out)
  const float* delta;   // [S, nh, T] (backward)
  float* out;           // [S, T, E] (forward)
  float* lse_out;       // [S, nh, T] (forward)
  float* dq;            // [S, T, E]
  float* dk;            // [S, T, E]
  float* dv;            // [S, T, E]
  float* dpk;           // [B, P, E]
  float* dpv;           // [B, P, E]
  int songs;            // S
  int t;                // T
  int p;                // P (0: no prefix)
  int q_per_ep;         // Q: songs per episode, S = B Q
  int nh;
  int hd;
  float scale;
};

struct Smem {
  static constexpr int kVec = 4;  // floats per 16 bytes
  // floats per tile row
  static __host__ __device__ int pitch(int hd) { return hd + kVec; }
  static size_t tile_bytes(int hd) {
    return (size_t)kTile * pitch(hd) * sizeof(float);
  }
  // n_tiles [64, hd] operand tiles, n_scores [64, 65] fp32 tiles, and 3
  // per-row (or per-key) fp32 vectors of 64
  static size_t bytes(int hd, int n_tiles, int n_scores) {
    return n_tiles * tile_bytes(hd) +
           (size_t)n_scores * kTile * kSPitch * sizeof(float) +
           3 * kTile * sizeof(float);
  }
};

// x rounded to the stream dtype T, as fp32 (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [row0, row0 + 64) x columns [col0, col0 + width) of a row-major
// [n, ld] matrix in the stream dtype T into dst as fp32 (pitch floats per
// row), 16 bytes a thread at a time; rows past n read as zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int n,
                                           int ld, int row0, int col0,
                                           int width, float* dst, int pitch) {
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 bytes
  const int per = width / kVec;
  for (int e = threadIdx.x; e < kTile * per; e += kThreads) {
    const int r = e / per, c = (e % per) * kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + col0 + c);
    float* out = dst + r * pitch + c;
    if (sizeof(T) == sizeof(float)) {
      *reinterpret_cast<uint4*>(out) = val;
    } else {
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 lo = __bfloat1622float2(x[2 * i]);
        const float2 hi = __bfloat1622float2(x[2 * i + 1]);
        *reinterpret_cast<float4*>(out + 4 * i) =
            make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
  }
}

// acc[i][j] += sum over d < width of A[ty + 16 i][d] B[tx + 16 j][d], fp32
// sums of the staged operands (both [64, width] tiles with the same pitch).
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int pitch, int width,
                                         float (&acc)[4][4]) {
  constexpr int kVec = Smem::kVec;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int kk = 0; kk < width; kk += kVec) {
    float a[4][kVec], b[4][kVec];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      unpack(*reinterpret_cast<const uint4*>(A + (ty + 16 * i) * pitch + kk),
             a[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      unpack(*reinterpret_cast<const uint4*>(B + (tx + 16 * j) * pitch + kk),
             b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < kVec; ++q)
          acc[i][j] = fmaf(a[i][q], b[j][q], acc[i][j]);
  }
}

// The column chunks of a head: the v1 kernels stage at most kMaxHd columns
// of a head at a time.  Chunk c holds columns [c kMaxHd, c kMaxHd + width).
__host__ __device__ __forceinline__ int n_chunks(int hd) {
  return (hd + kMaxHd - 1) / kMaxHd;
}
__host__ __device__ __forceinline__ int chunk_width(int hd, int c) {
  return hd - c * kMaxHd < kMaxHd ? hd - c * kMaxHd : kMaxHd;
}

// Sum over the 16 threads of a row (lanes tx = 0..15 of a half-warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

// One key tile of the walk: which keys, from where.
struct KeyTile {
  bool prefix;
  int col0;   // first key of the tile within its sequence
  int n;      // keys in that sequence
  size_t base;  // element offset of the sequence's first row ([n, E])
  const float* mask;  // the sequence's key mask
};

// Key tile kt of query song s's walk: the episode's prefix tiles, then the
// song's own.
__device__ __forceinline__ KeyTile key_tile(const Args& a, int s, int kt) {
  const int e = a.nh * a.hd;
  const int n_pre = (a.p + kTile - 1) / kTile;
  KeyTile t{};
  t.prefix = kt < n_pre;
  if (t.prefix) {
    const int b = s / a.q_per_ep;
    t.col0 = kt * kTile;
    t.n = a.p;
    t.base = (size_t)b * a.p * e;
    t.mask = a.pmask + (size_t)b * a.p;
  } else {
    t.col0 = (kt - n_pre) * kTile;
    t.n = a.t;
    t.base = (size_t)s * a.t * e;
    t.mask = a.kmask + (size_t)s * a.t;
  }
  return t;
}

// The masked, scaled score of query row r against key c of tile kt:
// -inf for keys past the sequence (excluded), -1e30 for masked keys and,
// in the self branch, keys past the diagonal.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              const KeyTile& kt, int c,
                                              float key_ok, int r) {
  if (c >= kt.n) return -INFINITY;
  const float x = dot * scale;
  if (key_ok <= 0.0f || (!kt.prefix && c > r)) return kNeg;
  return x;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// kWide: a head wider than kMaxHd runs as column windows: blockIdx.z picks
// output window w (chunk w's columns); every window forms the scores over
// all of the head's chunks in chunk order, staging q and k a chunk at a
// time, so the windows' scores, maxima and sums are the same.  Without it
// (hd <= kMaxHd: one chunk, one window) the q tile is staged once, before
// the walk, and the chunk loop compiles away.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, e = a.nh * hd, n_ch = kWide ? n_chunks(hd) : 1;
  const int pitch = Smem::pitch(chunk_width(hd, 0));
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = sq + kTile * pitch;
  float* sv = sk + kTile * pitch;
  float* sp = reinterpret_cast<float*>(sv + kTile * pitch);  // [64][65]
  float* smask = sp + kTile * kSPitch;                         // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt, s = blockIdx.x / n_qt, h = blockIdx.y;
  const int w = kWide ? blockIdx.z : 0, col_w = h * hd + w * kMaxHd;
  const int ncol = chunk_width(hd, w) / 16;
  const int row0 = qt * kTile;
  const T* qs = static_cast<const T*>(a.q) + (size_t)s * a.t * e;

  if (!kWide) stage_rows(qs, a.t, e, row0, h * hd, hd, sq, pitch);
  float m[4], l[4], o[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) o[i][j] = 0.0f;
  }
  const int n_walk = (a.p + kTile - 1) / kTile + qt + 1;
  for (int kt = 0; kt < n_walk; ++kt) {
    const KeyTile t = key_tile(a, s, kt);
    const T* kp = static_cast<const T*>(t.prefix ? a.pk : a.k) + t.base;
    const T* vp = static_cast<const T*>(t.prefix ? a.pv : a.v) + t.base;
    __syncthreads();  // the previous tile's sk, sv, sp are no longer read
    stage_rows(vp, t.n, e, t.col0, col_w, ncol * 16, sv, pitch);
    if (threadIdx.x < kTile) {
      const int c = t.col0 + threadIdx.x;
      smask[threadIdx.x] = c < t.n ? t.mask[c] : 0.0f;
    }
    float sc[4][4] = {};
    for (int c = 0; c < n_ch; ++c) {
      const int col = h * hd + c * kMaxHd, width = chunk_width(hd, c);
      if (c > 0) __syncthreads();  // chunk c - 1's sq, sk are read
      if (kWide) stage_rows(qs, a.t, e, row0, col, width, sq, pitch);
      stage_rows(kp, t.n, e, t.col0, col, width, sk, pitch);
      __syncthreads();
      dot_tile(sq, sk, pitch, width, sc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = masked_score(sc[i][j], a.scale, t, t.col0 + tx + 16 * j,
                                smask[tx + 16 * j], r);
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps += p;
        // p v takes p rounded to the stream dtype; l sums it unrounded
        sp[(ty + 16 * i) * kSPitch + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = alpha * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    // o[i][j] += sum over keys c of p[row][c] v[c][tx + 16 j]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sp[(ty + 16 * i) * kSPitch + c];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < ncol) {
          const float y = sv[c * pitch + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(x[i], y, o[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= a.t) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    float* out = a.out + ((size_t)s * a.t + r) * e + col_w;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncol) out[tx + 16 * j] = o[i][j] * inv;
    if (tx == 0 && w == 0)
      a.lse_out[((size_t)s * a.nh + h) * a.t + r] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

// Column windows as in the forward (kWide); the scores walk the chunks
// starting after window w's, so the chunk staged last is the k window
// dq += ds k reads.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, e = a.nh * hd, n_ch = kWide ? n_chunks(hd) : 1;
  const int pitch = Smem::pitch(chunk_width(hd, 0));
  float* sq = reinterpret_cast<float*>(smem);
  float* sg = sq + kTile * pitch;
  float* sk = sg + kTile * pitch;
  float* sv = sk + kTile * pitch;
  float* sds = reinterpret_cast<float*>(sv + kTile * pitch);  // [64][65]
  float* smask = sds + kTile * kSPitch;                         // [64]
  float* slse = smask + kTile;                                  // [64]
  float* sdelta = slse + kTile;                                 // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt, s = blockIdx.x / n_qt, h = blockIdx.y;
  const int w = kWide ? blockIdx.z : 0, col_w = h * hd + w * kMaxHd;
  const int ncol = chunk_width(hd, w) / 16;
  const int row0 = qt * kTile;
  const size_t qbase = (size_t)s * a.t * e;
  const T* qs = static_cast<const T*>(a.q) + qbase;
  const T* gs = static_cast<const T*>(a.g) + qbase;

  if (!kWide) {
    stage_rows(qs, a.t, e, row0, h * hd, hd, sq, pitch);
    stage_rows(gs, a.t, e, row0, h * hd, hd, sg, pitch);
  }
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    const size_t at = ((size_t)s * a.nh + h) * a.t + r;
    slse[threadIdx.x] = r < a.t ? a.lse[at] : 0.0f;
    sdelta[threadIdx.x] = r < a.t ? a.delta[at] : 0.0f;
  }
  float dq[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) dq[i][j] = 0.0f;

  const int n_walk = (a.p + kTile - 1) / kTile + qt + 1;
  for (int kt = 0; kt < n_walk; ++kt) {
    const KeyTile t = key_tile(a, s, kt);
    const T* kp = static_cast<const T*>(t.prefix ? a.pk : a.k) + t.base;
    const T* vp = static_cast<const T*>(t.prefix ? a.pv : a.v) + t.base;
    __syncthreads();  // the previous tile's sk, sv, sds are no longer read
    if (threadIdx.x < kTile) {
      const int c = t.col0 + threadIdx.x;
      smask[threadIdx.x] = c < t.n ? t.mask[c] : 0.0f;
    }
    float sc[4][4] = {}, dp[4][4] = {};
    for (int i = 0; i < n_ch; ++i) {
      const int c = (w + 1 + i) % n_ch;
      const int col = h * hd + c * kMaxHd, width = chunk_width(hd, c);
      if (i > 0) __syncthreads();  // the previous chunk's tiles are read
      if (kWide) {
        stage_rows(qs, a.t, e, row0, col, width, sq, pitch);
        stage_rows(gs, a.t, e, row0, col, width, sg, pitch);
      }
      stage_rows(kp, t.n, e, t.col0, col, width, sk, pitch);
      stage_rows(vp, t.n, e, t.col0, col, width, sv, pitch);
      __syncthreads();
      dot_tile(sq, sk, pitch, width, sc);
      dot_tile(sg, sv, pitch, width, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i, r = row0 + rl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = masked_score(sc[i][j], a.scale, t,
                                     t.col0 + tx + 16 * j, smask[tx + 16 * j],
                                     r);
        const float p = r < a.t ? expf(x - slse[rl]) : 0.0f;
        sds[rl * kSPitch + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - sdelta[rl]) * a.scale);
      }
    }
    __syncthreads();
    // dq[i][j] += sum over keys c of ds[row][c] k[c][tx + 16 j]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sds[(ty + 16 * i) * kSPitch + c];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < ncol) {
          const float y = sk[c * pitch + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(x[i], y, dq[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= a.t) continue;
    float* out = a.dq + qbase + (size_t)r * e + col_w;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncol) out[tx + 16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// backward: dk / dv per branch
// ---------------------------------------------------------------------------

// Column windows as in dq (kWide: blockIdx.z = head x windows + window);
// the chunk staged last is the q and g window that dk += ds^T q and dv +=
// p^T g read.  Without it the K and V tiles stay resident for the whole
// walk.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, e = a.nh * hd, n_ch = kWide ? n_chunks(hd) : 1;
  const int pitch = Smem::pitch(chunk_width(hd, 0));
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kTile * pitch;
  float* sq = sv + kTile * pitch;
  float* sg = sq + kTile * pitch;
  float* sp = reinterpret_cast<float*>(sg + kTile * pitch);  // [64][65]
  float* sds = sp + kTile * kSPitch;                           // [64][65]
  float* smask = sds + kTile * kSPitch;                        // [64]
  float* slse = smask + kTile;                                 // [64]
  float* sdelta = slse + kTile;                                // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.t + kTile - 1) / kTile;
  // blockIdx.y: items, first the B episodes' prefixes, then the S songs
  const int n_ep = a.p > 0 ? a.songs / a.q_per_ep : 0;
  const int item = blockIdx.y;
  const bool prefix = item < n_ep;
  const int n = prefix ? a.p : a.t;
  const int kt = blockIdx.x, h = kWide ? blockIdx.z / n_ch : blockIdx.z;
  const int w = kWide ? blockIdx.z % n_ch : 0;
  const int col_w = h * hd + w * kMaxHd;
  const int ncol = chunk_width(hd, w) / 16;
  const int col0 = kt * kTile;
  if (col0 >= n) return;
  const size_t kbase = (size_t)(prefix ? item : item - n_ep) * n * e;
  const T* kp = static_cast<const T*>(prefix ? a.pk : a.k) + kbase;
  const T* vp = static_cast<const T*>(prefix ? a.pv : a.v) + kbase;
  const float* mk = prefix ? a.pmask + (size_t)item * a.p
                           : a.kmask + (size_t)(item - n_ep) * a.t;

  if (!kWide) {
    stage_rows(kp, n, e, col0, h * hd, hd, sk, pitch);
    stage_rows(vp, n, e, col0, h * hd, hd, sv, pitch);
  }
  if (threadIdx.x < kTile) {
    const int c = col0 + threadIdx.x;
    smask[threadIdx.x] = c < n ? mk[c] : 0.0f;
  }
  KeyTile t{};
  t.prefix = prefix;
  t.col0 = col0;
  t.n = n;
  // query tiles: every tile of the episode's Q songs (prefix), or the
  // song's own tiles from the diagonal down (self)
  const int s0 = prefix ? item * a.q_per_ep : item - n_ep;
  const int n_songs = prefix ? a.q_per_ep : 1;
  const int qt0 = prefix ? 0 : kt;

  float dk[4][kMaxCols], dv[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      dk[i][j] = 0.0f;
      dv[i][j] = 0.0f;
    }

  for (int si = 0; si < n_songs; ++si) {
    const int s = s0 + si;
    const size_t qbase = (size_t)s * a.t * e;
    const T* qs = static_cast<const T*>(a.q) + qbase;
    const T* gs = static_cast<const T*>(a.g) + qbase;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int row0 = qt * kTile;
      __syncthreads();  // the previous tile's sq, sg, sp, sds are read
      if (threadIdx.x < kTile) {
        const int r = row0 + threadIdx.x;
        const size_t at = ((size_t)s * a.nh + h) * a.t + r;
        slse[threadIdx.x] = r < a.t ? a.lse[at] : 0.0f;
        sdelta[threadIdx.x] = r < a.t ? a.delta[at] : 0.0f;
      }
      float sc[4][4] = {}, dp[4][4] = {};
      for (int i = 0; i < n_ch; ++i) {
        const int c = (w + 1 + i) % n_ch;
        const int col = h * hd + c * kMaxHd, width = chunk_width(hd, c);
        if (i > 0) __syncthreads();  // the previous chunk's tiles are read
        if (kWide) {
          stage_rows(kp, n, e, col0, col, width, sk, pitch);
          stage_rows(vp, n, e, col0, col, width, sv, pitch);
        }
        stage_rows(qs, a.t, e, row0, col, width, sq, pitch);
        stage_rows(gs, a.t, e, row0, col, width, sg, pitch);
        __syncthreads();
        dot_tile(sq, sk, pitch, width, sc);
        dot_tile(sg, sv, pitch, width, dp);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = ty + 16 * i, r = row0 + rl;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = tx + 16 * j;
          const float x = masked_score(sc[i][j], a.scale, t, col0 + cl,
                                       smask[cl], r);
          const float p = r < a.t ? expf(x - slse[rl]) : 0.0f;
          sp[rl * kSPitch + cl] = round_to<T>(p);
          sds[rl * kSPitch + cl] =
              round_to<T>(p * (dp[i][j] - sdelta[rl]) * a.scale);
        }
      }
      __syncthreads();
      // keys ty + 16 i: dv += p^T g, dk += ds^T q over the tile's rows
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float xp[4], xd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xp[i] = sp[r * kSPitch + ty + 16 * i];
          xd[i] = sds[r * kSPitch + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          if (j < ncol) {
            const float yg = sg[r * pitch + tx + 16 * j];
            const float yq = sq[r * pitch + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv[i][j] = fmaf(xp[i], yg, dv[i][j]);
              dk[i][j] = fmaf(xd[i], yq, dk[i][j]);
            }
          }
        }
      }
    }
  }
  float* dk_out = (prefix ? a.dpk : a.dk) + kbase;
  float* dv_out = (prefix ? a.dpv : a.dv) + kbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = col0 + ty + 16 * i;
    if (c >= n) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j < ncol) {
        dk_out[(size_t)c * e + col_w + tx + 16 * j] = dk[i][j];
        dv_out[(size_t)c * e + col_w + tx + 16 * j] = dv[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on tensor cores (v2)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;  // 16 query rows a warp
constexpr int kTcStages = 2;               // key tiles in flight

// Shared memory: kTcStages stages of the K and V tiles ([64, hd] each,
// pitched hd + 8) and the 64 key-mask floats, 70 KB at hd = 128, so three
// blocks fit an SM.  The [64, hd] q tile is staged in the second stage's K
// tile and read into registers before the ring reaches that stage.
__host__ __device__ size_t fwd_tc_tile(int hd) {
  return (size_t)kTile * (hd + 8) * sizeof(__nv_bfloat16);
}
__host__ __device__ size_t fwd_tc_stage(int hd) {
  return 2 * fwd_tc_tile(hd) + kTile * sizeof(float);
}
size_t fwd_tc_smem(int hd) { return kTcStages * fwd_tc_stage(hd); }

__global__ void __launch_bounds__(kTcThreads, 3) fwd_tc_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int kMaxK = kMaxHd / 16;  // 16-deep slices of q k^T
  constexpr int kNf = kTile / 8;      // n-fragments of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, pitch = hd + 8, e = a.nh * hd;
  const int nk = hd / 16;  // slices of q k^T; pairs of output n-fragments
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  unsigned char* stages = smem;
  const size_t stage_bytes = fwd_tc_stage(hd);
  bf16* sq = reinterpret_cast<bf16*>(stages + stage_bytes);  // stage 1
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt, s = blockIdx.x / n_qt, h = blockIdx.y;
  const int row0 = qt * kTile, wrow0 = row0 + 16 * warp;
  const bool live = wrow0 < a.t;  // warp-uniform
  const int n_walk = (a.p + kTile - 1) / kTile + qt + 1;
  const int per = hd / 8;  // 16-byte pieces per row

  // 64 rows from row0 of a token-major [n, E] sequence (head h) into dst
  auto stage_rows = [&](const bf16* seq, int n, int first, bf16* dst) {
    for (int x = threadIdx.x; x < kTile * per; x += kTcThreads) {
      const int r = x / per, c = (x % per) * 8, row = first + r;
      const bool ok = row < n;
      mma::cp_async16(dst + r * pitch + c,
                      seq + (size_t)(ok ? row : 0) * e + h * hd + c,
                      ok ? 16 : 0);
    }
  };
  auto stage_keys = [&](int kt, int slot) {
    const KeyTile t = key_tile(a, s, kt);
    bf16* sk = reinterpret_cast<bf16*>(stages + slot * stage_bytes);
    bf16* sv = sk + kTile * pitch;
    float* sm = reinterpret_cast<float*>(sv + kTile * pitch);
    stage_rows(static_cast<const bf16*>(t.prefix ? a.pk : a.k) + t.base, t.n,
               t.col0, sk);
    stage_rows(static_cast<const bf16*>(t.prefix ? a.pv : a.v) + t.base, t.n,
               t.col0, sv);
    if (threadIdx.x < kTile) {
      const int key = t.col0 + threadIdx.x;
      const bool ok = key < t.n;
      mma::cp_async4(sm + threadIdx.x, t.mask + (ok ? key : 0), ok ? 4 : 0);
    }
  };

  stage_rows(static_cast<const bf16*>(a.q) + (size_t)s * a.t * e, a.t, row0,
             sq);
  stage_keys(0, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kMaxK][4];  // the warp's q rows as A fragments
  if (live) {
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk)
      if (kk < nk)
        mma::ldsm_x4(qa[kk], sq + (16 * warp + mma::a_row(lane)) * pitch +
                                 16 * kk + mma::a_col(lane));
  }
  __syncthreads();  // stage 1 is free for key tile 1
  float o[kMaxHd / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxHd / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[j][x] = 0.0f;
  // this thread's rows g and g + 8 of the warp's 16: running max and its
  // share of the running sum
  const int rows[2] = {wrow0 + g, wrow0 + g + 8};
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < n_walk; ++kt) {
    const int slot = kt % kTcStages;
    if (kt + 1 < n_walk) {
      stage_keys(kt + 1, (slot + 1) % kTcStages);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt landed
    const KeyTile t = key_tile(a, s, kt);
    if (live && (t.prefix || t.col0 <= wrow0 + 15)) {
      const bf16* sk = reinterpret_cast<const bf16*>(stages + slot * stage_bytes);
      const bf16* sv = sk + kTile * pitch;
      const float* sm = reinterpret_cast<const float*>(sv + kTile * pitch);
      // scores: sc[j] = q k^T over keys 8 j .. 8 j + 7 of the tile
      float sc[kNf][4];
#pragma unroll
      for (int j = 0; j < kNf; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[j][x] = 0.0f;
      const bf16* pk = sk + mma::bn_row(lane) * pitch + mma::bn_col(lane);
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < nk) {
#pragma unroll
          for (int jp = 0; jp < kNf / 2; ++jp) {
            uint32_t bfr[4];
            mma::ldsm_x4(bfr, pk + 16 * jp * pitch + 16 * kk);
            mma::mma_bf16(sc[2 * jp], qa[kk], bfr[0], bfr[1]);
            mma::mma_bf16(sc[2 * jp + 1], qa[kk], bfr[2], bfr[3]);
          }
        }
      }
      // mask and scale (entry x of n-fragment j: row g + 8 (x / 2), key
      // 8 j + 2 t4 + x % 2 of the tile), then the rows' new maxima
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < kNf; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int cl = 8 * j + 2 * t4 + (x & 1);
          sc[j][x] = masked_score(sc[j][x], a.scale, t, t.col0 + cl, sm[cl],
                                  rows[x / 2]);
          mx[x / 2] = fmaxf(mx[x / 2], sc[j][x]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // p = exp(s - running max), summed unrounded
#pragma unroll
      for (int j = 0; j < kNf; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          sc[j][x] = expf(sc[j][x] - m[x / 2]);
          l[x / 2] += sc[j][x];
        }
#pragma unroll
      for (int j = 0; j < kMaxHd / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // o += bf16(p) v, 16 keys at a time
#pragma unroll
      for (int c = 0; c < kNf / 2; ++c) {
        uint32_t pf[4];
        mma::pack_a(pf, sc[2 * c], sc[2 * c + 1]);
        const bf16* pv = sv + (16 * c + mma::bk_row(lane)) * pitch +
                         mma::bk_col(lane);
#pragma unroll
        for (int np = 0; np < kMaxK; ++np) {
          if (np < nk) {
            uint32_t bfr[4];
            mma::ldsm_x4_trans(bfr, pv + 16 * np);
            mma::mma_bf16(o[2 * np], pf, bfr[0], bfr[1]);
            mma::mma_bf16(o[2 * np + 1], pf, bfr[2], bfr[3]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this slot
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = rows[i];
    if (r >= a.t) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    float* out = a.out + ((size_t)s * a.t + r) * e + h * hd + 2 * t4;
#pragma unroll
    for (int j = 0; j < kMaxHd / 8; ++j)
      if (j < 2 * nk)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (t4 == 0)
      a.lse_out[((size_t)s * a.nh + h) * a.t + r] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on tensor cores (v2)
// ---------------------------------------------------------------------------

// A pass of the backward covers half a score tile: 32 keys of the key tile
// (dq) or 32 rows of the query tile (dk/dv), so that a warp holds its two
// 16 x 32 fp32 tiles (scores and g v^T) beside its fp32 accumulators.
constexpr int kHalf = kTile / 2;
constexpr int kHalfNf = kHalf / 8;  // n-fragments of a pass's tile

// 64 rows from `first` of a token-major [n, E] bf16 sequence, the hd
// columns from `col`, into dst (pitch hd + 8) by cp.async, 16 bytes a
// thread at a time; rows past n are zero-filled.
__device__ __forceinline__ void stage_tc(const __nv_bfloat16* seq, int n,
                                         int first, int e, int col, int hd,
                                         __nv_bfloat16* dst) {
  const int per = hd / 8, pitch = hd + 8;  // 16-byte pieces per row
  for (int x = threadIdx.x; x < kTile * per; x += kTcThreads) {
    const int r = x / per, c = (x % per) * 8, row = first + r;
    const bool ok = row < n;
    mma::cp_async16(dst + r * pitch + c,
                    seq + (size_t)(ok ? row : 0) * e + col + c, ok ? 16 : 0);
  }
}

// Entry first + i of a length-n fp32 vector into dst[i] by cp.async; zero
// past n.
__device__ __forceinline__ void stage_vec(const float* src, int n, int first,
                                          float* dst, int i) {
  const bool ok = first + i < n;
  mma::cp_async4(dst + i, src + (ok ? first + i : 0), ok ? 4 : 0);
}

// Key tile kt of song s's walk, head h, into one ring stage: the K and V
// tiles, then the 64 key-mask floats (fwd_tc_stage's layout).  The forward
// stages the same way with lambdas of its own: on an H100 these helpers
// made it 7 % slower at the training path's query shape, while the
// backward kernels ran as fast with them as with such lambdas.
__device__ __forceinline__ void stage_key_tile(const Args& a, int s, int h,
                                               int kt, unsigned char* stage) {
  using bf16 = __nv_bfloat16;
  const KeyTile t = key_tile(a, s, kt);
  const int hd = a.hd, pitch = hd + 8, e = a.nh * hd;
  bf16* sk = reinterpret_cast<bf16*>(stage);
  bf16* sv = sk + kTile * pitch;
  stage_tc(static_cast<const bf16*>(t.prefix ? a.pk : a.k) + t.base, t.n,
           t.col0, e, h * hd, hd, sk);
  stage_tc(static_cast<const bf16*>(t.prefix ? a.pv : a.v) + t.base, t.n,
           t.col0, e, h * hd, hd, sv);
  if (threadIdx.x < kTile)
    stage_vec(t.mask, t.n, t.col0, reinterpret_cast<float*>(sv + kTile * pitch),
              threadIdx.x);
}

// p = exp(s - lse) of one score entry (0 for a row past the sequence), s
// masked as the forward masks it
__device__ __forceinline__ float bwd_p(float dot, float scale,
                                       const KeyTile& t, int c, float key_ok,
                                       int r, int n_rows, float lse) {
  return r < n_rows ? expf(masked_score(dot, scale, t, c, key_ok, r) - lse)
                    : 0.0f;
}

// dq, FlashAttention-2 style on the forward's grid, walk and ring: a warp
// keeps its 16 rows of q and g as A fragments; per key tile and pass it
// forms s = q k^T and dp = g v^T (K, V read by ldmatrix), turns them into
// ds = p (dp - delta) scale in registers and feeds bf16(ds) straight back
// as the A fragment of dq += ds k (K read by ldmatrix.trans).  q and g are
// staged in the second stage's K and V tiles before the walk starts.
__global__ void __launch_bounds__(kTcThreads, 2) dq_tc_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int kMaxK = kMaxHd / 16;  // 16-deep slices of q k^T
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, pitch = hd + 8, e = a.nh * hd;
  const int nk = hd / 16;  // slices of q k^T; pairs of dq's n-fragments
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  unsigned char* stages = smem;
  const size_t stage_bytes = fwd_tc_stage(hd);
  bf16* sq = reinterpret_cast<bf16*>(stages + stage_bytes);  // stage 1
  bf16* sg = sq + kTile * pitch;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt, s = blockIdx.x / n_qt, h = blockIdx.y;
  const int row0 = qt * kTile, wrow0 = row0 + 16 * warp;
  const bool live = wrow0 < a.t;  // warp-uniform
  const int n_walk = (a.p + kTile - 1) / kTile + qt + 1;
  const size_t qbase = (size_t)s * a.t * e;

  stage_tc(static_cast<const bf16*>(a.q) + qbase, a.t, row0, e, h * hd, hd,
           sq);
  stage_tc(static_cast<const bf16*>(a.g) + qbase, a.t, row0, e, h * hd, hd,
           sg);
  stage_key_tile(a, s, h, 0, stages);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kMaxK][4], ga[kMaxK][4];  // the warp's q and g rows
  if (live) {
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk)
      if (kk < nk) {
        const int at = (16 * warp + mma::a_row(lane)) * pitch + 16 * kk +
                       mma::a_col(lane);
        mma::ldsm_x4(qa[kk], sq + at);
        mma::ldsm_x4(ga[kk], sg + at);
      }
  }
  __syncthreads();  // stage 1 is free for key tile 1
  // this thread's rows g and g + 8 of the warp's 16, their lse and delta
  const int rows[2] = {wrow0 + g, wrow0 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < a.t;
    const size_t at = ((size_t)s * a.nh + h) * a.t + (ok ? rows[i] : 0);
    lse[i] = ok ? a.lse[at] : 0.0f;
    delta[i] = ok ? a.delta[at] : 0.0f;
  }
  float dq[kMaxHd / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxHd / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dq[j][x] = 0.0f;

  for (int kt = 0; kt < n_walk; ++kt) {
    const int slot = kt % kTcStages;
    if (kt + 1 < n_walk) {
      stage_key_tile(a, s, h, kt + 1,
                     stages + (slot + 1) % kTcStages * stage_bytes);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile kt landed
    const KeyTile t = key_tile(a, s, kt);
    if (live) {
      const bf16* sk =
          reinterpret_cast<const bf16*>(stages + slot * stage_bytes);
      const bf16* sv = sk + kTile * pitch;
      const float* sm = reinterpret_cast<const float*>(sv + kTile * pitch);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = kHalf * half;  // the pass's first key in the tile
        // keys all past the sequence, or all above the warp's diagonal
        if (t.col0 + c0 >= t.n || (!t.prefix && t.col0 + c0 > wrow0 + 15))
          continue;
        // sc[j], dp[j]: q k^T and g v^T over keys c0 + 8 j .. c0 + 8 j + 7
        float sc[kHalfNf][4], dp[kHalfNf][4];
#pragma unroll
        for (int j = 0; j < kHalfNf; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[j][x] = dp[j][x] = 0.0f;
        const int boff = (c0 + mma::bn_row(lane)) * pitch + mma::bn_col(lane);
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          if (kk < nk) {
#pragma unroll
            for (int jp = 0; jp < kHalfNf / 2; ++jp) {
              uint32_t bfr[4];
              mma::ldsm_x4(bfr, sk + boff + 16 * jp * pitch + 16 * kk);
              mma::mma_bf16(sc[2 * jp], qa[kk], bfr[0], bfr[1]);
              mma::mma_bf16(sc[2 * jp + 1], qa[kk], bfr[2], bfr[3]);
              mma::ldsm_x4(bfr, sv + boff + 16 * jp * pitch + 16 * kk);
              mma::mma_bf16(dp[2 * jp], ga[kk], bfr[0], bfr[1]);
              mma::mma_bf16(dp[2 * jp + 1], ga[kk], bfr[2], bfr[3]);
            }
          }
        }
        // ds into dp (entry x of n-fragment j: row g + 8 (x / 2), key
        // c0 + 8 j + 2 t4 + x % 2 of the tile)
#pragma unroll
        for (int j = 0; j < kHalfNf; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int cl = c0 + 8 * j + 2 * t4 + (x & 1), i = x / 2;
            const float p = bwd_p(sc[j][x], a.scale, t, t.col0 + cl, sm[cl],
                                  rows[i], a.t, lse[i]);
            dp[j][x] = p * (dp[j][x] - delta[i]) * a.scale;
          }
        // dq += bf16(ds) k, 16 keys at a time
#pragma unroll
        for (int c = 0; c < kHalfNf / 2; ++c) {
          uint32_t df[4];
          mma::pack_a(df, dp[2 * c], dp[2 * c + 1]);
          const bf16* kp = sk + (c0 + 16 * c + mma::bk_row(lane)) * pitch +
                           mma::bk_col(lane);
#pragma unroll
          for (int np = 0; np < kMaxK; ++np) {
            if (np < nk) {
              uint32_t bfr[4];
              mma::ldsm_x4_trans(bfr, kp + 16 * np);
              mma::mma_bf16(dq[2 * np], df, bfr[0], bfr[1]);
              mma::mma_bf16(dq[2 * np + 1], df, bfr[2], bfr[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this slot
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= a.t) continue;
    float* out = a.dq + qbase + (size_t)rows[i] * e + h * hd + 2 * t4;
#pragma unroll
    for (int j = 0; j < kMaxHd / 8; ++j)
      if (j < 2 * nk)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(dq[j][2 * i], dq[j][2 * i + 1]);
  }
}

// Shared memory of dkv_tc_kernel: the block's K and V tiles and 64 key-mask
// floats, resident, then kTcStages stages of the Q and G tiles with their
// 64 rows' lse and delta: 105 KB at hd = 128, two blocks an SM, as many as
// the registers allow (dk and dv take 128 a thread at hd = 128).
__host__ __device__ size_t dkv_tc_stage(int hd) {
  return 2 * fwd_tc_tile(hd) + 2 * kTile * sizeof(float);
}
size_t dkv_tc_smem(int hd) {
  return 2 * fwd_tc_tile(hd) + kTile * sizeof(float) +
         kTcStages * dkv_tc_stage(hd);
}

// dk/dv on v1's grid: one block per (64-key tile, head, branch item), each
// warp owning 16 keys, keys as the M dimension.  Per query tile of the walk
// (v1's) and pass it forms s^T = k q^T and dp^T = v g^T (its K and V A
// fragments read from the resident tiles by ldmatrix at each use: as
// registers they would spill beside dk and dv), then p^T and ds^T in
// registers, packed straight into the A fragments of dv += p^T g and
// dk += ds^T q (G, Q read by ldmatrix.trans).  Q, G, lse and delta go
// through a two-stage cp.async ring; dk and dv stay in fp32 registers for
// the whole walk.
__global__ void __launch_bounds__(kTcThreads, 2) dkv_tc_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int kMaxK = kMaxHd / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, pitch = hd + 8, e = a.nh * hd;
  const int nk = hd / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_qt = (a.t + kTile - 1) / kTile;
  // blockIdx.y: items, first the B episodes' prefixes, then the S songs
  const int n_ep = a.p > 0 ? a.songs / a.q_per_ep : 0;
  const int item = blockIdx.y;
  const bool prefix = item < n_ep;
  const int n = prefix ? a.p : a.t;
  const int kt = blockIdx.x, h = blockIdx.z;
  const int col0 = kt * kTile, wk0 = col0 + 16 * warp;
  if (col0 >= n) return;
  const bool live = wk0 < n;  // warp-uniform
  const size_t kbase = (size_t)(prefix ? item : item - n_ep) * n * e;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * pitch;
  float* sm = reinterpret_cast<float*>(sv + kTile * pitch);
  unsigned char* stages = reinterpret_cast<unsigned char*>(sm + kTile);
  const size_t stage_bytes = dkv_tc_stage(hd);
  KeyTile t{};
  t.prefix = prefix;
  t.col0 = col0;
  t.n = n;
  // the walk: every query tile of the episode's Q songs (prefix), or the
  // song's own tiles from the diagonal down (self)
  const int s0 = prefix ? item * a.q_per_ep : item - n_ep;
  const int qt0 = prefix ? 0 : kt;
  const int per_song = n_qt - qt0;
  const int n_walk = (prefix ? a.q_per_ep : 1) * per_song;

  auto stage_queries = [&](int w, int slot) {
    const int s = s0 + w / per_song, first = (qt0 + w % per_song) * kTile;
    bf16* q_ = reinterpret_cast<bf16*>(stages + slot * stage_bytes);
    bf16* g_ = q_ + kTile * pitch;
    float* lse_ = reinterpret_cast<float*>(g_ + kTile * pitch);
    const size_t qbase = (size_t)s * a.t * e;
    const size_t at = ((size_t)s * a.nh + h) * a.t;
    stage_tc(static_cast<const bf16*>(a.q) + qbase, a.t, first, e, h * hd, hd,
             q_);
    stage_tc(static_cast<const bf16*>(a.g) + qbase, a.t, first, e, h * hd, hd,
             g_);
    if (threadIdx.x < kTile)
      stage_vec(a.lse + at, a.t, first, lse_, threadIdx.x);
    else  // kTcThreads = 2 kTile
      stage_vec(a.delta + at, a.t, first, lse_ + kTile, threadIdx.x - kTile);
  };

  stage_tc(static_cast<const bf16*>(prefix ? a.pk : a.k) + kbase, n, col0, e,
           h * hd, hd, sk);
  stage_tc(static_cast<const bf16*>(prefix ? a.pv : a.v) + kbase, n, col0, e,
           h * hd, hd, sv);
  if (threadIdx.x < kTile)
    stage_vec(prefix ? a.pmask + (size_t)item * a.p
                     : a.kmask + (size_t)(item - n_ep) * a.t,
              n, col0, sm, threadIdx.x);
  stage_queries(0, 0);
  mma::cp_async_commit();
  float dk[kMaxHd / 8][4], dv[kMaxHd / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxHd / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk[j][x] = dv[j][x] = 0.0f;
  // this thread's keys g and g + 8 of the warp's 16, and their masks
  const int keys[2] = {wk0 + g, wk0 + g + 8};
  const int aoff = (16 * warp + mma::a_row(lane)) * pitch + mma::a_col(lane);

  for (int w = 0; w < n_walk; ++w) {
    const int slot = w % kTcStages;
    if (w + 1 < n_walk) {
      stage_queries(w + 1, (slot + 1) % kTcStages);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // query tile w (and, at w = 0, K and V) landed
    const int row0 = (qt0 + w % per_song) * kTile;
    if (live) {
      const bf16* sq =
          reinterpret_cast<const bf16*>(stages + slot * stage_bytes);
      const bf16* sg = sq + kTile * pitch;
      const float* slse = reinterpret_cast<const float*>(sg + kTile * pitch);
      const float* sdelta = slse + kTile;
      const float key_ok[2] = {sm[keys[0] - col0], sm[keys[1] - col0]};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r0 = kHalf * half;  // the pass's first row in the tile
        // rows all past the sequence, or all before the warp's first key
        if (row0 + r0 >= a.t || (!prefix && row0 + r0 + kHalf - 1 < wk0))
          continue;
        // sc[j], dp[j]: k q^T and v g^T over rows r0 + 8 j .. r0 + 8 j + 7
        float sc[kHalfNf][4], dp[kHalfNf][4];
#pragma unroll
        for (int j = 0; j < kHalfNf; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[j][x] = dp[j][x] = 0.0f;
        const int boff = (r0 + mma::bn_row(lane)) * pitch + mma::bn_col(lane);
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          if (kk < nk) {
            uint32_t ka[4], va[4];
            mma::ldsm_x4(ka, sk + aoff + 16 * kk);
            mma::ldsm_x4(va, sv + aoff + 16 * kk);
#pragma unroll
            for (int jp = 0; jp < kHalfNf / 2; ++jp) {
              uint32_t bfr[4];
              mma::ldsm_x4(bfr, sq + boff + 16 * jp * pitch + 16 * kk);
              mma::mma_bf16(sc[2 * jp], ka, bfr[0], bfr[1]);
              mma::mma_bf16(sc[2 * jp + 1], ka, bfr[2], bfr[3]);
              mma::ldsm_x4(bfr, sg + boff + 16 * jp * pitch + 16 * kk);
              mma::mma_bf16(dp[2 * jp], va, bfr[0], bfr[1]);
              mma::mma_bf16(dp[2 * jp + 1], va, bfr[2], bfr[3]);
            }
          }
        }
        // p^T into sc, ds^T into dp (entry x of n-fragment j: key
        // g + 8 (x / 2) of the warp's, row r0 + 8 j + 2 t4 + x % 2 of the
        // tile); the self branch's causal mask is the forward's transposed
#pragma unroll
        for (int j = 0; j < kHalfNf; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int rl = r0 + 8 * j + 2 * t4 + (x & 1), i = x / 2;
            const float p = bwd_p(sc[j][x], a.scale, t, keys[i], key_ok[i],
                                  row0 + rl, a.t, slse[rl]);
            sc[j][x] = p;
            dp[j][x] = p * (dp[j][x] - sdelta[rl]) * a.scale;
          }
        // dv += bf16(p)^T g, dk += bf16(ds)^T q, 16 rows at a time
#pragma unroll
        for (int c = 0; c < kHalfNf / 2; ++c) {
          uint32_t pf[4], df[4];
          mma::pack_a(pf, sc[2 * c], sc[2 * c + 1]);
          mma::pack_a(df, dp[2 * c], dp[2 * c + 1]);
          const int off = (r0 + 16 * c + mma::bk_row(lane)) * pitch +
                          mma::bk_col(lane);
#pragma unroll
          for (int np = 0; np < kMaxK; ++np) {
            if (np < nk) {
              uint32_t bfr[4];
              mma::ldsm_x4_trans(bfr, sg + off + 16 * np);
              mma::mma_bf16(dv[2 * np], pf, bfr[0], bfr[1]);
              mma::mma_bf16(dv[2 * np + 1], pf, bfr[2], bfr[3]);
              mma::ldsm_x4_trans(bfr, sq + off + 16 * np);
              mma::mma_bf16(dk[2 * np], df, bfr[0], bfr[1]);
              mma::mma_bf16(dk[2 * np + 1], df, bfr[2], bfr[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this slot
  }

  if (!live) return;
  float* dk_out = (prefix ? a.dpk : a.dk) + kbase + h * hd + 2 * t4;
  float* dv_out = (prefix ? a.dpv : a.dv) + kbase + h * hd + 2 * t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= n) continue;
    const size_t at = (size_t)keys[i] * e;
#pragma unroll
    for (int j = 0; j < kMaxHd / 8; ++j)
      if (j < 2 * nk) {
        *reinterpret_cast<float2*>(dk_out + at + 8 * j) =
            make_float2(dk[j][2 * i], dk[j][2 * i + 1]);
        *reinterpret_cast<float2*>(dv_out + at + 8 * j) =
            make_float2(dv[j][2 * i], dv[j][2 * i + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(const Args& a) {
  return a.songs < 0 || a.t < 0 || a.p < 0 || a.nh <= 0 || a.hd <= 0 ||
         a.hd % 16 || a.q_per_ep <= 0 || a.songs % a.q_per_ep;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t st, int threads = kThreads) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// query tiles x songs, heads, column windows (v1)
dim3 query_grid(const Args& a, int windows = 1) {
  return dim3(((a.t + kTile - 1) / kTile) * a.songs, a.nh, windows);
}

// shared memory of a v1 kernel: n_tiles [64, chunk] tiles, n_scores score
// tiles
size_t v1_smem(const Args& a, int n_tiles, int n_scores) {
  return Smem::bytes(chunk_width(a.hd, 0), n_tiles, n_scores);
}

template <typename T, bool kWide>
cudaError_t fwd(const Args& a, cudaStream_t st) {
  const int windows = kWide ? n_chunks(a.hd) : 1;
  return launch(fwd_kernel<T, kWide>, query_grid(a, windows),
                v1_smem(a, 3, 1), a, st);
}

cudaError_t fwd_tc(const Args& a, cudaStream_t st) {
  return launch(fwd_tc_kernel, query_grid(a), fwd_tc_smem(a.hd), a, st,
                kTcThreads);
}

template <typename T, bool kWide>
cudaError_t bwd_dq(const Args& a, cudaStream_t st) {
  const int windows = kWide ? n_chunks(a.hd) : 1;
  return launch(dq_kernel<T, kWide>, query_grid(a, windows),
                v1_smem(a, 4, 1), a, st);
}

cudaError_t bwd_dq_tc(const Args& a, cudaStream_t st) {
  return launch(dq_tc_kernel, query_grid(a), fwd_tc_smem(a.hd), a, st,
                kTcThreads);
}

// key tiles, items (the B episodes' prefixes, then the S songs), heads x
// column windows (v1)
dim3 key_grid(const Args& a, int windows = 1) {
  const int n_ep = a.p > 0 ? a.songs / a.q_per_ep : 0;
  const int kmax = a.p > a.t ? a.p : a.t;
  return dim3((kmax + kTile - 1) / kTile, n_ep + a.songs, a.nh * windows);
}

template <typename T, bool kWide>
cudaError_t bwd_dkv(const Args& a, cudaStream_t st) {
  const int windows = kWide ? n_chunks(a.hd) : 1;
  return launch(dkv_kernel<T, kWide>, key_grid(a, windows),
                v1_smem(a, 4, 2), a, st);
}

cudaError_t bwd_dkv_tc(const Args& a, cudaStream_t st) {
  return launch(dkv_tc_kernel, key_grid(a), dkv_tc_smem(a.hd), a, st,
                kTcThreads);
}

Args make_args(const void* q, const void* k, const void* v,
               const float* kmask, const void* pk, const void* pv,
               const float* pmask, int songs, int t, int p, int q_per_ep,
               int nh, int hd, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.kmask = kmask;
  a.pk = pk;
  a.pv = pv;
  a.pmask = pmask;
  a.songs = songs;
  a.t = t;
  a.p = p;
  a.q_per_ep = q_per_ep;
  a.nh = nh;
  a.hd = hd;
  a.scale = scale;
  return a;
}

bool empty(const Args& a) { return a.songs == 0 || a.t == 0; }

}  // namespace

// dtype: 0 = fp32 streams, 1 = bf16 streams.  q, k, v [S, T, E] and
// pk, pv [B, P, E] (B = S / Q; null with P = 0) in the stream dtype, E =
// nh hd; kmask [S, T] and pmask [B, P] fp32 (> 0 = real key).
// hd a multiple of 16; scale the scores' factor (1 / sqrt of the unpadded
// head width).  Out: out [S, T, E] and lse [S, nh, T] fp32.  dtype 0 runs
// the v1 SIMT kernel, dtype 1 the tensor-core kernel (the v1 kernel past
// hd = 128).  Returns a cudaError_t code (0 = launched).
extern "C" int prefix_attn_fwd(const void* q, const void* k, const void* v,
                               const float* kmask, const void* pk,
                               const void* pv, const float* pmask, float* out,
                               float* lse, int songs, int t, int p,
                               int q_per_ep, int nh, int hd, float scale,
                               int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, pk, pv, pmask, songs, t, p, q_per_ep,
                     nh, hd, scale);
  a.out = out;
  a.lse_out = lse;
  if (bad_shape(a)) return cudaErrorInvalidValue;
  if (empty(a)) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = a.hd > kMaxHd;
  if (dtype == 0)
    return wide ? fwd<float, true>(a, st) : fwd<float, false>(a, st);
  if (dtype == 1)
    return wide ? fwd<__nv_bfloat16, true>(a, st) : fwd_tc(a, st);
  return cudaErrorInvalidValue;
}

// The forward's inputs, the cotangent g [S, T, E] in the stream dtype, the
// forward's lse and delta [S, nh, T] fp32.  Out: dq [S, T, E] fp32.  dtype 0
// runs the v1 SIMT kernel, dtype 1 the tensor-core kernel up to hd = 128
// (as does prefix_attn_bwd_dkv).
extern "C" int prefix_attn_bwd_dq(const void* q, const void* k, const void* v,
                                  const float* kmask, const void* pk,
                                  const void* pv, const float* pmask,
                                  const void* g, const float* lse,
                                  const float* delta, float* dq, int songs,
                                  int t, int p, int q_per_ep, int nh, int hd,
                                  float scale, int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, pk, pv, pmask, songs, t, p, q_per_ep,
                     nh, hd, scale);
  a.g = g;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  if (bad_shape(a)) return cudaErrorInvalidValue;
  if (empty(a)) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = a.hd > kMaxHd;
  if (dtype == 0)
    return wide ? bwd_dq<float, true>(a, st) : bwd_dq<float, false>(a, st);
  if (dtype == 1)
    return wide ? bwd_dq<__nv_bfloat16, true>(a, st) : bwd_dq_tc(a, st);
  return cudaErrorInvalidValue;
}

// As prefix_attn_bwd_dq.  Out: dk, dv [S, T, E] and (P > 0) dpk, dpv
// [B, P, E] fp32, every entry written.
extern "C" int prefix_attn_bwd_dkv(const void* q, const void* k,
                                   const void* v, const float* kmask,
                                   const void* pk, const void* pv,
                                   const float* pmask, const void* g,
                                   const float* lse, const float* delta,
                                   float* dk, float* dv, float* dpk,
                                   float* dpv, int songs, int t, int p,
                                   int q_per_ep, int nh, int hd,
                                   float scale, int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, pk, pv, pmask, songs, t, p, q_per_ep,
                     nh, hd, scale);
  a.g = g;
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.dpk = dpk;
  a.dpv = dpv;
  if (bad_shape(a)) return cudaErrorInvalidValue;
  if (empty(a)) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = a.hd > kMaxHd;
  if (dtype == 0)
    return wide ? bwd_dkv<float, true>(a, st) : bwd_dkv<float, false>(a, st);
  if (dtype == 1)
    return wide ? bwd_dkv<__nv_bfloat16, true>(a, st) : bwd_dkv_tc(a, st);
  return cudaErrorInvalidValue;
}
