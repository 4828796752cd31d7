// Decode attention over a KV cache for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The JAX package leaves one decode step's
// attention to XLA (fewshot/models/transformer.py `_attend`: two einsums
// and a softmax over the whole cache).  The port ran the same einsums in
// PyTorch, which upcast the bf16 cache to fp32 and laid it out again for a
// batched product with one query row, every step and layer: about 9 GB of
// traffic a layer at the sampling benchmark's shape (tfm_cache.sample:
// B = 2048 rows, T = 609 cache positions, nh = 2 heads of hd = 128, bf16),
// 13.4 of the step's 14.8 ms.  This kernel reads the cache in place, once.
//
// One decode step, per row b and head h, over the keys admitted,
// ok[j] = valid[b, j] && j <= idx:
//   s_j = (q . k_j) / sqrt(hd)        fp32 sums of products exact in fp32
//   p_j = exp(s_j - max s) / sum exp  fp32 against the row's final maximum,
//                                     rounded to the cache dtype
//   out = sum_j p_j v_j               fp32
// Rounding points are the einsum path's (the plain twin in
// ops/decode_attention.py, and the JAX package's); only the order of the
// fp32 sums differs.  A masked key's p is exactly 0 there (its score is
// -1e30 below a real one), so masked keys are not read: positions past
// idx and the pad slots of the prefix.  A row with no admitted key gets
// the twin's answer, p = 1/T on every position (all T scores are -1e30).
//
// Bound: bytes, at about one operation a byte.  At the benchmark's shape a
// step reads at most 2 layers x 2 (K, V) x 2048 x 544.5 (mean positions
// <= idx) x 512 B = 2.28 GB, 0.68 ms at 3.35 TB/s; the prefix's pad slots,
// which are skipped, lower that.  So the design is about bytes in flight:
//   * one block of 128 threads per (row, head): B nh blocks (4096 there)
//     fill the 132 SMs many times over;
//   * a position's head slice is hd contiguous elements; a group of tp
//     lanes of one warp takes a position, each lane a 16-byte chunk (8 bf16
//     or 4 fp32; one element where hd is not a multiple of 16 bytes),
//     neighbouring lanes on neighbouring addresses; q stays in registers;
//   * 0. the admitted flags of positions <= idx into shared memory;
//     1. one pass over K, each lane with kLoads chunk loads in flight,
//        masked keys skipped; a segmented shuffle sums a group's products;
//        the scores stay in shared memory (2.4 KB at T = 609);
//     2. the block's max, the exps and their sum, p rounded;
//     3. one pass over V (keys with p == 0 skipped), each lane summing its
//        chunk of p v in fp32 registers;
//     4. the groups' partial sums through shared memory, added in a fixed
//        order: no atomics, the same bits on every launch.
// Splitting a row's keys over several blocks would pay only at small
// batches, and would move the softmax's rounding point; it is not done.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;       // chunk loads in flight a lane, in each pass
constexpr int kMaxSmem = 232448;

// A chunk of CH elements of T, loaded raw (read-only path) and read as
// floats; bf16 -> fp32 is exact.
template <typename T, int CH>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 w;
  __device__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void zero() { w = make_uint4(0u, 0u, 0u, 0u); }
  __device__ float get(int e) const {
    const uint32_t x = e < 2 ? w.x : e < 4 ? w.y : e < 6 ? w.z : w.w;
    return __uint_as_float(e & 1 ? x & 0xffff0000u : x << 16);
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  unsigned short w;
  __device__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ void zero() { w = 0; }
  __device__ float get(int) const { return __uint_as_float(uint32_t(w) << 16); }
};

template <>
struct Chunk<float, 4> {
  float4 w;
  __device__ void load(const float* p) {
    w = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ void zero() { w = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ float get(int e) const {
    return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
  }
};

template <>
struct Chunk<float, 1> {
  float w;
  __device__ void load(const float* p) { w = __ldg(p); }
  __device__ void zero() { w = 0.f; }
  __device__ float get(int) const { return w; }
};

// p rounded to the cache dtype (round to nearest even, as torch's .to()).
template <typename T>
__device__ float rounded(float x);
template <>
__device__ float rounded<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ float rounded<float>(float x) { return x; }

// The sum of d over a group of tp consecutive lanes (tp <= 32, groups not
// straddling warps), in the group's first lane: after the step of offset
// 2^i a lane holds the sum of the next 2^(i+1) lanes of its group.  Every
// lane of the warp takes part.
__device__ __forceinline__ float group_sum(float d, int c0, int tp) {
  for (int off = 1; off < tp; off <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, d, off);
    if (c0 + off < tp) d += o;
  }
  return d;
}

// The block's max (sum) of x, in every thread; the warps' partials are
// combined in a fixed order.
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  for (int off = 16; off; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, o) : x + o;
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

struct Plan {
  int ch;       // elements a chunk
  int nc;       // chunks a lane holds (1, 2, 4)
  int tp;       // lanes a position
  int groups;   // positions a block takes at once
  long long smem;
};

// The kernel's shape for T positions of heads hd wide; false where no
// instance takes hd (wider than 4 chunks a lane: hd > 1024 bf16, 512 fp32,
// or 128 where hd is not a multiple of 16 bytes).
bool make_plan(int t, int hd, int dtype, Plan* p) {
  if (t < 1 || hd < 1 || (dtype != 0 && dtype != 1)) return false;
  const int vec = dtype == 1 ? 8 : 4;
  p->ch = hd % vec == 0 ? vec : 1;
  const int chunks = hd / p->ch;
  const int need = (chunks + 31) / 32;
  p->nc = need == 1 ? 1 : need == 2 ? 2 : need <= 4 ? 4 : 0;
  if (!p->nc) return false;
  p->tp = chunks < 32 ? chunks : 32;
  p->groups = kWarps * (32 / p->tp);
  // scores [t] f32, partial sums [groups, hd] f32, scratch [kWarps] f32,
  // admitted flags [t] u8
  p->smem = 4LL * t + 4LL * p->groups * hd + 4LL * kWarps + t;
  return true;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  float* out;
  int b, t, nh, hd, idx;
  float sqrt_hd;
};

template <typename T, int CH, int NC>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ out, int t, int nh, int hd, int idx,
                       float sqrt_hd, int tp, int groups) {
  constexpr int U = kLoads / NC > 0 ? kLoads / NC : 1;   // positions in flight
  extern __shared__ float smem[];
  float* s = smem;                      // [t]: scores, then p
  float* red = s + t;                   // [groups, hd]
  float* scratch = red + groups * hd;   // [kWarps]
  uint8_t* ok = reinterpret_cast<uint8_t*>(scratch + kWarps);   // [t]

  const int bh = blockIdx.x;            // row * nh + head
  const int row = bh / nh;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / tp;
  const int c0 = lane % tp;             // lane within its group
  const bool on = lane / tp < per_warp;
  const int g = (threadIdx.x >> 5) * per_warp + lane / tp;
  const int chunks = hd / CH;
  const int n = idx + 1;
  const size_t stride = size_t(nh) * hd;   // elements from a position to the next
  const size_t head0 = size_t(row) * t * stride + size_t(bh - row * nh) * hd;
  const T* kh = k + head0;
  const T* vh = v + head0;

  for (int j = threadIdx.x; j < n; j += kThreads) ok[j] = valid[size_t(row) * t + j];
  Chunk<T, CH> qc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + i * tp;
    if (on && c < chunks) qc[i].load(q + size_t(bh) * hd + c * CH);
    else qc[i].zero();
  }
  __syncthreads();

  // 1. the scores, one pass over the admitted keys
  for (int base = 0; base < n; base += groups * U) {
    Chunk<T, CH> kc[U][NC];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * groups + g;
      live[u] = on && j < n && ok[j];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = c0 + i * tp;
        if (live[u] && c < chunks) kc[u][i].load(kh + j * stride + c * CH);
        else kc[u][i].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < CH; ++e) d = fmaf(qc[i].get(e), kc[u][i].get(e), d);
      d = group_sum(d, c0, tp);
      const int j = base + u * groups + g;
      if (on && c0 == 0 && j < n) s[j] = live[u] ? d / sqrt_hd : -INFINITY;
    }
  }
  __syncthreads();

  // 2. softmax against the row's final maximum, p rounded
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) m = fmaxf(m, s[j]);
  m = block_reduce<true>(m, scratch);
  int n_p = n;
  if (m == -INFINITY) {   // no admitted key: every score -1e30 in the twin
    const float pu = rounded<T>(1.f / t);
    for (int j = threadIdx.x; j < t; j += kThreads) s[j] = pu;
    n_p = t;
  } else {
    float l = 0.f;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float e = expf(s[j] - m);
      s[j] = e;
      l += e;
    }
    l = block_reduce<false>(l, scratch);
    for (int j = threadIdx.x; j < n; j += kThreads) s[j] = rounded<T>(s[j] / l);
  }
  __syncthreads();

  // 3. sum p v, one pass over the keys whose p is not 0
  float acc[NC][CH];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[i][e] = 0.f;
  for (int base = 0; base < n_p; base += groups * U) {
    Chunk<T, CH> vc[U][NC];
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * groups + g;
      p[u] = on && j < n_p ? s[j] : 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = c0 + i * tp;
        if (p[u] != 0.f && c < chunks) vc[u][i].load(vh + j * stride + c * CH);
        else vc[u][i].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[i][e] = fmaf(p[u], vc[u][i].get(e), acc[i][e]);
  }

  // 4. the groups' partial sums, added in group order
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + i * tp;
    if (on && c < chunks) {
#pragma unroll
      for (int e = 0; e < CH; ++e) red[g * hd + c * CH + e] = acc[i][e];
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += red[gg * hd + d];
    out[size_t(bh) * hd + d] = o;
  }
}

template <typename T, int CH, int NC>
int launch(const Args& a, const Plan& p, cudaStream_t st) {
  auto kernel = decode_attn_kernel<T, CH, NC>;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(p.smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.b * a.nh, kThreads, size_t(p.smem), st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.valid, a.out, a.t, a.nh, a.hd, a.idx,
      a.sqrt_hd, p.tp, p.groups);
  return cudaGetLastError();
}

template <typename T, int CH>
int by_chunks(const Args& a, const Plan& p, cudaStream_t st) {
  switch (p.nc) {
    case 1: return launch<T, CH, 1>(a, p, st);
    case 2: return launch<T, CH, 2>(a, p, st);
    case 4: return launch<T, CH, 4>(a, p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared memory (bytes) that one block needs for T positions of heads hd
// wide in dtype (0 fp32, 1 bf16); -1 where no instance takes hd.  The
// launch refuses a plan past 232,448 bytes.
extern "C" int decode_attn_smem(int t, int hd, int dtype) {
  Plan p;
  if (!make_plan(t, hd, dtype, &p)) return -1;
  return p.smem > 0x7fffffffLL ? 0x7fffffff : int(p.smem);
}

// q [B, 1, nh, hd] and one layer's cache k, v [B, T, nh, hd] in dtype (0
// fp32, 1 bf16), contiguous, read in place; valid [B, T] bool (one byte an
// entry); idx: the decode position (0 <= idx < T).  Out: [B, 1, nh hd]
// fp32, every entry written.  sqrt_hd: the scores' divisor.  Launches on
// `stream` and returns its CUDA error code.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* valid, float* out, int b, int t, int nh,
                           int hd, int idx, float sqrt_hd, int dtype,
                           void* stream) {
  Plan p;
  if (b < 0 || nh < 1 || idx < 0 || idx >= t || !make_plan(t, hd, dtype, &p) ||
      p.smem > kMaxSmem || (long long)b * nh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const uintptr_t align = uintptr_t(p.ch) * (dtype == 1 ? 2 : 4);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % align)
    return cudaErrorMisalignedAddress;
  const Args a{q, k, v, static_cast<const uint8_t*>(valid), out, b, t, nh, hd,
               idx, sqrt_hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return p.ch == 8 ? by_chunks<__nv_bfloat16, 8>(a, p, st)
                     : by_chunks<__nv_bfloat16, 1>(a, p, st);
  return p.ch == 4 ? by_chunks<float, 4>(a, p, st) : by_chunks<float, 1>(a, p, st);
}
