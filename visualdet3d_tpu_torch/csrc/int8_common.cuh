// Pieces shared by the int8 kernels (int8_conv.cu, int8_block.cu): asynchronous
// copies into shared memory with zero fill, and the s8 x s8 -> s32 tensor-core
// product mma.sync.m16n8k32.
//
// Fragments of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 32, row-major): a0 = A[g][4t..4t+3],     a1 = A[g+8][4t..4t+3],
//                           a2 = A[g][16+4t..],      a3 = A[g+8][16+4t..]
//   B (32 x 8, by column):  b0 = B[4t..4t+3][g],     b1 = B[16+4t..][g]
//   C (16 x 8):             c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// so an A tile stored row by row with k contiguous and a B tile stored column
// by column (an output channel's weights, k contiguous) give every fragment
// register as one aligned 32-bit shared-memory load.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vd3d_int8 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) from global to shared memory; with pred false
// nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool pred) {
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int lds32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

}  // namespace vd3d_int8
