// Tensor-core building blocks for Hopper (sm_90a) shared by the bf16
// kernels of head_ce.cu and prefix_attn.cu: asynchronous copies into
// shared memory, ldmatrix fragment loads and the warp-wide
// mma.sync.m16n8k16 bf16 product with fp32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), for lane l of a warp, with
// g = l / 4 and t = l % 4:
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1],     a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9],   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):             b0 = B[2t, 2t+1][g],     b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, fp32):    c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// (each 32-bit register holds two bf16, the lower index in the low half).
// So the accumulators of two neighbouring n-fragments, rounded and packed,
// are the A fragment of one 16-deep slice of the next product
// (`pack_a`): the FlashAttention-2 register reuse.
//
// The loaders below take tiles stored row-major in shared memory with a
// pitch of (width + 8) bf16: rows 16 x (odd) bytes apart, so the 8 rows
// one ldmatrix reads fall in 8 different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; the first `bytes` of them read,
// the rest zero-filled (bytes = 0: all zero, src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes, zero-filled when bytes = 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lanes 8j..8j+7 give the row addresses of
// matrix j, which lands in r[j].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16-deep slice from the fp32 accumulators of the two
// n-fragments that cover it (columns 0-7 and 8-15 of the slice).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane offsets (row, column) into a row-major tile for the loaders:
//   A operand, 16 rows x 16 deep at (0, 0):     a_row(), a_col()
//   B operand stored [n][k] (k contiguous), two n-fragments (16 n) x 16
//   deep, ldsm_x4 -> {b0, b1} of n 0-7, {b0, b1} of n 8-15: bn_row(), bn_col()
//   B operand stored [k][n] (n contiguous), 16 deep x two n-fragments,
//   ldsm_x4_trans -> the same registers: bk_row(), bk_col()
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return (lane / 16) * 8; }
__device__ __forceinline__ int bn_row(int lane) {
  return lane % 8 + (lane / 16) * 8;
}
__device__ __forceinline__ int bn_col(int lane) { return (lane / 8) % 2 * 8; }
__device__ __forceinline__ int bk_row(int lane) {
  return lane % 8 + (lane / 8) % 2 * 8;
}
__device__ __forceinline__ int bk_col(int lane) { return (lane / 16) * 8; }

}  // namespace mma
