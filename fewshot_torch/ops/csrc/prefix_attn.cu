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
// Design.  A TPU grid runs in order and carries the softmax state and the
// dk/dv accumulators from one grid step to the next; blocks here run in no
// order, so each block owns its outputs and loops over what they need:
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
// columns tx + 16 j) and 4 rows x hd / 16 columns of a [64, hd] accumulator.
// Masked keys carry the finite -1e30, never -inf, and l == 0 -> 1 and
// log(max(l, 1e-30)) guard the division and the log, so a row whose every
// key is masked stays finite; keys past the end of a sequence (the partial
// last tile) are excluded outright.  hd is a multiple of 16, at most 128.
//
// Bound.  At the training shape (S = 160 songs of T = 95 rows, P = 480, E =
// 256, bf16) the forward reads ~39 MB (q, k, v, the prefix k, v) and writes
// 15.6 MB of fp32 output against ~4 GFLOP over the real (row, key) pairs,
// so it is bound by bytes on this card (~16 us at 3.35 TB/s, ~4 us of bf16
// tensor-core operations); dq and dk/dv move about as many bytes for 1.5x
// and 2x the operations.  This first version multiplies on the fp32 SIMT
// units (67 TFLOP/s peak) and rereads the prefix tiles once per song, far
// from both bounds; tensor-core tiles (mma / wgmma), TMA stages and one
// fused backward are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // query rows and keys of a score tile
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kSPitch = kTile + 1;    // floats per row of a score tile
constexpr int kMaxHd = 128;
constexpr int kMaxCols = kMaxHd / 16;  // accumulator columns per thread
constexpr float kNeg = -1e30f;
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

// x rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
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

template <typename T>
struct Smem {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16 B
  // elements per tile row
  static __host__ __device__ int pitch(int hd) { return hd + kVec; }
  static size_t tile_bytes(int hd) {
    return (size_t)kTile * pitch(hd) * sizeof(T);
  }
  // n_tiles [64, hd] operand tiles, n_scores [64, 65] fp32 tiles, and 3
  // per-row (or per-key) fp32 vectors of 64
  static size_t bytes(int hd, int n_tiles, int n_scores) {
    return n_tiles * tile_bytes(hd) +
           (size_t)n_scores * kTile * kSPitch * sizeof(float) +
           3 * kTile * sizeof(float);
  }
};

// Rows [row0, row0 + 64) x columns [col0, col0 + hd) of a row-major [n, ld]
// matrix into dst (pitch elements per row), 16 bytes a thread at a time;
// rows past n read as zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int n,
                                           int ld, int row0, int col0, int hd,
                                           T* dst, int pitch) {
  constexpr int kVec = Smem<T>::kVec;
  const int per = hd / kVec;
  for (int e = threadIdx.x; e < kTile * per; e += kThreads) {
    const int r = e / per, c = (e % per) * kVec;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

// acc[i][j] = sum over d < hd of A[ty + 16 i][d] B[tx + 16 j][d], fp32 sums
// of the staged operands (both [64, hd] tiles with the same pitch).
template <typename T>
__device__ __forceinline__ void dot_tile(const T* A, const T* B, int pitch,
                                         int hd, float (&acc)[4][4]) {
  constexpr int kVec = Smem<T>::kVec;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int kk = 0; kk < hd; kk += kVec) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, pitch = Smem<T>::pitch(hd), e = a.nh * hd;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + kTile * pitch;
  T* sv = sk + kTile * pitch;
  float* sp = reinterpret_cast<float*>(sv + kTile * pitch);  // [64][65]
  float* smask = sp + kTile * kSPitch;                         // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt, s = blockIdx.x / n_qt, h = blockIdx.y;
  const int row0 = qt * kTile;
  const int ncol = hd / 16;

  stage_rows(static_cast<const T*>(a.q) + (size_t)s * a.t * e, a.t, e, row0,
             h * hd, hd, sq, pitch);
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
    stage_rows(kp, t.n, e, t.col0, h * hd, hd, sk, pitch);
    stage_rows(vp, t.n, e, t.col0, h * hd, hd, sv, pitch);
    if (threadIdx.x < kTile) {
      const int c = t.col0 + threadIdx.x;
      smask[threadIdx.x] = c < t.n ? t.mask[c] : 0.0f;
    }
    __syncthreads();
    float sc[4][4];
    dot_tile<T>(sq, sk, pitch, hd, sc);
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
          const float y = to_float(sv[c * pitch + tx + 16 * j]);
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
    float* out = a.out + ((size_t)s * a.t + r) * e + h * hd;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncol) out[tx + 16 * j] = o[i][j] * inv;
    if (tx == 0)
      a.lse_out[((size_t)s * a.nh + h) * a.t + r] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// backward: dq
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, pitch = Smem<T>::pitch(hd), e = a.nh * hd;
  T* sq = reinterpret_cast<T*>(smem);
  T* sg = sq + kTile * pitch;
  T* sk = sg + kTile * pitch;
  T* sv = sk + kTile * pitch;
  float* sds = reinterpret_cast<float*>(sv + kTile * pitch);  // [64][65]
  float* smask = sds + kTile * kSPitch;                         // [64]
  float* slse = smask + kTile;                                  // [64]
  float* sdelta = slse + kTile;                                 // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_qt = (a.t + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt, s = blockIdx.x / n_qt, h = blockIdx.y;
  const int row0 = qt * kTile;
  const int ncol = hd / 16;
  const size_t qbase = (size_t)s * a.t * e;

  stage_rows(static_cast<const T*>(a.q) + qbase, a.t, e, row0, h * hd, hd,
             sq, pitch);
  stage_rows(static_cast<const T*>(a.g) + qbase, a.t, e, row0, h * hd, hd,
             sg, pitch);
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
    stage_rows(kp, t.n, e, t.col0, h * hd, hd, sk, pitch);
    stage_rows(vp, t.n, e, t.col0, h * hd, hd, sv, pitch);
    if (threadIdx.x < kTile) {
      const int c = t.col0 + threadIdx.x;
      smask[threadIdx.x] = c < t.n ? t.mask[c] : 0.0f;
    }
    __syncthreads();
    float sc[4][4], dp[4][4];
    dot_tile<T>(sq, sk, pitch, hd, sc);
    dot_tile<T>(sg, sv, pitch, hd, dp);
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
          const float y = to_float(sk[c * pitch + tx + 16 * j]);
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
    float* out = a.dq + qbase + (size_t)r * e + h * hd;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncol) out[tx + 16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// backward: dk / dv per branch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd, pitch = Smem<T>::pitch(hd), e = a.nh * hd;
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kTile * pitch;
  T* sq = sv + kTile * pitch;
  T* sg = sq + kTile * pitch;
  float* sp = reinterpret_cast<float*>(sg + kTile * pitch);  // [64][65]
  float* sds = sp + kTile * kSPitch;                           // [64][65]
  float* smask = sds + kTile * kSPitch;                        // [64]
  float* slse = smask + kTile;                                 // [64]
  float* sdelta = slse + kTile;                                // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ncol = hd / 16;
  const int n_qt = (a.t + kTile - 1) / kTile;
  // blockIdx.y: items, first the B episodes' prefixes, then the S songs
  const int n_ep = a.p > 0 ? a.songs / a.q_per_ep : 0;
  const int item = blockIdx.y;
  const bool prefix = item < n_ep;
  const int n = prefix ? a.p : a.t;
  const int kt = blockIdx.x, h = blockIdx.z;
  const int col0 = kt * kTile;
  if (col0 >= n) return;
  const size_t kbase = (size_t)(prefix ? item : item - n_ep) * n * e;
  const T* kp = static_cast<const T*>(prefix ? a.pk : a.k) + kbase;
  const T* vp = static_cast<const T*>(prefix ? a.pv : a.v) + kbase;
  const float* mk = prefix ? a.pmask + (size_t)item * a.p
                           : a.kmask + (size_t)(item - n_ep) * a.t;

  stage_rows(kp, n, e, col0, h * hd, hd, sk, pitch);
  stage_rows(vp, n, e, col0, h * hd, hd, sv, pitch);
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
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int row0 = qt * kTile;
      __syncthreads();  // the previous tile's sq, sg, sp, sds are read
      stage_rows(static_cast<const T*>(a.q) + qbase, a.t, e, row0, h * hd, hd,
                 sq, pitch);
      stage_rows(static_cast<const T*>(a.g) + qbase, a.t, e, row0, h * hd, hd,
                 sg, pitch);
      if (threadIdx.x < kTile) {
        const int r = row0 + threadIdx.x;
        const size_t at = ((size_t)s * a.nh + h) * a.t + r;
        slse[threadIdx.x] = r < a.t ? a.lse[at] : 0.0f;
        sdelta[threadIdx.x] = r < a.t ? a.delta[at] : 0.0f;
      }
      __syncthreads();
      float sc[4][4], dp[4][4];
      dot_tile<T>(sq, sk, pitch, hd, sc);
      dot_tile<T>(sg, sv, pitch, hd, dp);
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
            const float yg = to_float(sg[r * pitch + tx + 16 * j]);
            const float yq = to_float(sq[r * pitch + tx + 16 * j]);
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
        dk_out[(size_t)c * e + h * hd + tx + 16 * j] = dk[i][j];
        dv_out[(size_t)c * e + h * hd + tx + 16 * j] = dv[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(const Args& a) {
  return a.songs < 0 || a.t < 0 || a.p < 0 || a.nh <= 0 || a.hd <= 0 ||
         a.hd % 16 || a.hd > kMaxHd || a.q_per_ep <= 0 ||
         a.songs % a.q_per_ep;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t st) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// query tiles x songs, heads
dim3 query_grid(const Args& a) {
  return dim3(((a.t + kTile - 1) / kTile) * a.songs, a.nh);
}

template <typename T>
cudaError_t fwd(const Args& a, cudaStream_t st) {
  return launch(fwd_kernel<T>, query_grid(a), Smem<T>::bytes(a.hd, 3, 1), a,
                st);
}

template <typename T>
cudaError_t bwd_dq(const Args& a, cudaStream_t st) {
  return launch(dq_kernel<T>, query_grid(a), Smem<T>::bytes(a.hd, 4, 1), a,
                st);
}

template <typename T>
cudaError_t bwd_dkv(const Args& a, cudaStream_t st) {
  const int n_ep = a.p > 0 ? a.songs / a.q_per_ep : 0;
  const int kmax = a.p > a.t ? a.p : a.t;
  const dim3 grid((kmax + kTile - 1) / kTile, n_ep + a.songs, a.nh);
  return launch(dkv_kernel<T>, grid, Smem<T>::bytes(a.hd, 4, 2), a, st);
}

Args make_args(const void* q, const void* k, const void* v,
               const float* kmask, const void* pk, const void* pv,
               const float* pmask, int songs, int t, int p, int q_per_ep,
               int nh, int hd) {
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
  a.scale = (float)(1.0 / sqrt((double)hd));
  return a;
}

bool empty(const Args& a) { return a.songs == 0 || a.t == 0; }

}  // namespace

// dtype: 0 = fp32 streams, 1 = bf16 streams.  q, k, v [S, T, E] and
// pk, pv [B, P, E] (B = S / Q; null with P = 0) in the stream dtype, E =
// nh hd; kmask [S, T] and pmask [B, P] fp32 (> 0 = real key).
// Out: out [S, T, E] and lse [S, nh, T] fp32.  Returns a cudaError_t code
// (0 = launched).
extern "C" int prefix_attn_fwd(const void* q, const void* k, const void* v,
                               const float* kmask, const void* pk,
                               const void* pv, const float* pmask, float* out,
                               float* lse, int songs, int t, int p,
                               int q_per_ep, int nh, int hd, int dtype,
                               void* stream) {
  Args a = make_args(q, k, v, kmask, pk, pv, pmask, songs, t, p, q_per_ep,
                     nh, hd);
  a.out = out;
  a.lse_out = lse;
  if (bad_shape(a)) return cudaErrorInvalidValue;
  if (empty(a)) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(a, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

// The forward's inputs, the cotangent g [S, T, E] in the stream dtype, the
// forward's lse and delta [S, nh, T] fp32.  Out: dq [S, T, E] fp32.
extern "C" int prefix_attn_bwd_dq(const void* q, const void* k, const void* v,
                                  const float* kmask, const void* pk,
                                  const void* pv, const float* pmask,
                                  const void* g, const float* lse,
                                  const float* delta, float* dq, int songs,
                                  int t, int p, int q_per_ep, int nh, int hd,
                                  int dtype, void* stream) {
  Args a = make_args(q, k, v, kmask, pk, pv, pmask, songs, t, p, q_per_ep,
                     nh, hd);
  a.g = g;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  if (bad_shape(a)) return cudaErrorInvalidValue;
  if (empty(a)) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dq<float>(a, st);
  if (dtype == 1) return bwd_dq<__nv_bfloat16>(a, st);
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
                                   int q_per_ep, int nh, int hd, int dtype,
                                   void* stream) {
  Args a = make_args(q, k, v, kmask, pk, pv, pmask, songs, t, p, q_per_ep,
                     nh, hd);
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
  if (dtype == 0) return bwd_dkv<float>(a, st);
  if (dtype == 1) return bwd_dkv<__nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}
