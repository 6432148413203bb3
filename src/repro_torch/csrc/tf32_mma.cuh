// Float32 products on Hopper's tensor cores, and cp.async copies, shared by
// flash_attn.cu and draft_decode.cu.
//
// The tensor cores take float32 only as TF32 (10 mantissa bits), which
// misses the port's 1e-4 contracts, so a product runs as three TF32
// products (3xTF32): a_lo b_hi + a_hi b_lo + a_hi b_hi into one float32
// accumulator, with hi = tf32(x) and lo = x - hi.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wsfm {

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) done with two
// integer operations: the same bits as the conversion instruction, which
// is slower here.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x) and lo = x - hi (exact). The tensor core reads a TF32
// operand's top 19 bits, so lo is passed as it is and truncated there
// (CUTLASS's 3xTF32 rounds its small part toward zero the same way). That
// costs at most 2^-21 |x| an operand, beside 2^-22 for the dropped
// a_lo b_lo term, and saves a conversion on every operand.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// mma.sync.m16n8k8, with g = lane / 4 and t = lane % 4: A holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k = t, n = g), (t + 4, g);
// C holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a_lo b_hi + a_hi b_lo + a_hi b_hi; a_lo b_lo (~2^-22 relative) is dropped.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// 16 bytes from global to shared memory, bypassing L1; zeros when !valid
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// The same for 4 bytes, for pointers or strides that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace wsfm
