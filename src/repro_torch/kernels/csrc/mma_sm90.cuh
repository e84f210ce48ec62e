// Warp-level tensor-core helpers in inline PTX: cp.async staging, ldmatrix
// and mma.sync m16n8k16 with fp32 accumulation, for bfloat16 and float16
// operands. Header-only, no CuTe or CUTLASS, so a source that includes it
// still builds in seconds.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * gr + tq, gr = lane / 4,
// tq = lane % 4), each 32-bit register holding two 16-bit values, the lower
// column (or k) in the low half:
//  - A (16 x 16, row-major): a[0] (row gr, k 2tq..2tq+1), a[1] (row gr+8,
//    same k), a[2] (row gr, k 2tq+8..), a[3] (row gr+8, k 2tq+8..);
//  - B (16 x 8, k by n): b[0] (k 2tq..2tq+1, col gr), b[1] (k 2tq+8.., col gr);
//  - C (16 x 8, fp32): c[0], c[1] (row gr, cols 2tq, 2tq+1), c[2], c[3]
//    (row gr+8, the same cols).
// So the C fragments of two adjacent n8 tiles, rounded and packed in pairs,
// are the A fragment of one k16 step: C of tile 2j gives a[0], a[1], C of
// tile 2j+1 gives a[2], a[3] (pack_a below).
//
// The three ldmatrix addressings used with a shared tile X stored row-major
// with a row stride of ld elements (16-byte aligned rows):
//  - A of rows m0.., k0..: lane -> &X[m0 + lane % 16][k0 + (lane / 16) * 8];
//  - B = X^T where X holds n rows of k (S = Q K^T): lane ->
//    &X[n0 + lane % 8 + (lane / 16) * 8][k0 + ((lane / 8) % 2) * 8];
//  - B = X where X holds k rows of n (dQ += dS K): the same lane -> row
//    mapping as A, read with .trans.
// Both B forms return b[0], b[1] of the n8 tile n0 in r[0], r[1] and of the
// tile n0 + 8 in r[2], r[3].

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until waited for; zeros if !full
// (then nothing is read from src)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zeros if !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b, one m16n8k16 product of T operands, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                                  uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest-even in T, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of one k16 step from the C fragments of the n8 tiles 2j
// (c_lo) and 2j+1 (c_hi), each value rounded to T
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c_lo)[4], const float (&c_hi)[4]) {
  a[0] = pack2<T>(c_lo[0], c_lo[1]);
  a[1] = pack2<T>(c_lo[2], c_lo[3]);
  a[2] = pack2<T>(c_hi[0], c_hi[1]);
  a[3] = pack2<T>(c_hi[2], c_hi[3]);
}

}  // namespace mma_sm90
