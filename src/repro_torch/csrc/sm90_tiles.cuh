// Device helpers shared by block_matmul.cu and flash_attention.cu:
// 16-byte cp.async copies into a shared-memory ring, ldmatrix fragment
// loads, the bf16 mma.sync m16n8k16 product, and the partition of a run
// of tiles among the blocks of a split.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + c):
//   A (16 x 16, row-major): a0 = A[g][2c..2c+1],   a1 = A[g+8][2c..2c+1],
//                           a2 = A[g][2c+8..2c+9], a3 = A[g+8][2c+8..2c+9]
//   B (16 x 8, k x n):      b0 = B[2c..2c+1][g],   b1 = B[2c+8..2c+9][g]
//   C (16 x 8, fp32):       c0,c1 = C[g][2c..2c+1], c2,c3 = C[g+8][2c..2c+1]
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; src_bytes = 0 writes 16 zero bytes and reads nothing (the
// ragged edge of a tile, or a row outside the problem).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a * b, bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Part `rank` of `n` tiles split into `parts` contiguous runs: ranks
// below min(parts, n) get [begin, end), non-empty, in order; the rest get
// nothing.  The same partition as `split_ranges` in
// kernels/block_matmul.py.
__device__ __forceinline__ void split_range(int n, int parts, int rank,
                                            int& begin, int& end) {
  const int used = min(parts, n);
  if (rank >= used) {
    begin = end = 0;
    return;
  }
  begin = (int)((long long)rank * n / used);
  end = (int)((long long)(rank + 1) * n / used);
}

}  // namespace sm90
