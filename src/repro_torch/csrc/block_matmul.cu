// block_matmul: out (M,N) = x (M,K) @ w (K,N), bf16 in, fp32 accumulate,
// bf16 out.
//
// Replaces the TPU kernel `_matmul_kernel` / `block_matmul_2d`
// (src/repro/kernels/block_matmul.py:25,46).  The TPU version walks a
// sequential (M/bm, N/bn, K/bk) grid with K innermost and carries an fp32
// accumulator in VMEM scratch across the K steps; its operands are
// zero-padded to tile multiples and the result sliced back.
//
// What bounds it on an H100: on the serving path M is the number of batch
// slots in decode (4) and at most 16 in a prefill chunk, so the product
// does ~2*M FLOPs per weight byte, far below the ~295 FLOP/byte at which
// the tensor cores rather than HBM become the limit.  It is bound by the
// bytes of w: the gate and up GEMMs at M=4 read 67.1 MB, 20.0 us at
// 3.35 TB/s.
//
// What the design does about it: one block per (bm, bn) output tile and a
// loop over K inside the block in place of the TPU's sequential K axis; the
// fp32 accumulator lives in registers.  Each K step stages a bf16 x tile
// and a bf16 w tile in shared memory (16-byte vector loads on the aligned
// interior, masked scalar loads on the ragged edge, so no padding copy is
// ever made) and four warps run mma.sync m16n8k16 bf16 products on them.
// bm is clamped to the problem by the wrapper (16 rows in decode), so the
// masked rows of a decode tile cost neither bytes nor tensor-core work
// beyond one 16-row fragment.  The tile (bm, bn, bk) is the per-level code
// version and is a template parameter; the entry point instantiates every
// tile of the port's level table.  Not yet done: cp.async/TMA pipelining
// and split-K, which a down projection at M=4 (16 blocks of bn=128 on 132
// SMs) needs to approach the byte bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(&lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(&hi);
  return l | (h << 16);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy one 8-element row chunk of a row-major (rows, cols) bf16 matrix
// into shared memory, zero-filling outside the matrix.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row, int col, int rows,
                                           int cols, bool vec) {
  if (vec && row < rows && col + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + (size_t)row * cols + col);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    dst[e] = (row < rows && col + e < cols)
                 ? src[(size_t)row * cols + col + e]
                 : __float2bfloat16(0.0f);
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    block_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, int M, int N, int K,
                        int vec_x, int vec_w) {
  // padded row strides keep fragment reads free of bank conflicts and
  // every row 16-byte aligned
  constexpr int SA = BK + 8;
  constexpr int SB = BN + 8;
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  static_assert(MI >= 1 && NI >= 1 && BK % 16 == 0, "unsupported tile");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // BM x SA
  __nv_bfloat16* sB = sA + BM * SA;                             // BK x SB

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK / 8; idx += kThreads) {
      const int r = idx / (BK / 8), cc = (idx % (BK / 8)) * 8;
      load_chunk(sA + r * SA + cc, x, m0 + r, k0 + cc, M, K, vec_x);
    }
    for (int idx = tid; idx < BK * BN / 8; idx += kThreads) {
      const int r = idx / (BN / 8), cc = (idx % (BN / 8)) * 8;
      load_chunk(sB + r * SB + cc, w, k0 + r, n0 + cc, K, N, vec_w);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4];
      uint32_t bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const __nv_bfloat16* p =
            sA + (wm * WM + i * 16 + g) * SA + kk + 2 * c;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SA);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SA + 8);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const __nv_bfloat16* p = sB + (kk + 2 * c) * SB + wn * WN + j * 8 + g;
        bf[j][0] = pack_bf16(p[0], p[SB]);
        bf[j][1] = pack_bf16(p[8 * SB], p[9 * SB]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16_16816(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int row = m0 + wm * WM + i * 16 + g;
      const int col = n0 + wn * WN + j * 8 + 2 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >= 2 ? 8 : 0);
        const int cl = col + (e & 1);
        if (r < M && cl < N)
          out[(size_t)r * N + cl] = __float2bfloat16(acc[i][j][e]);
      }
    }
  }
}

template <int BM, int BN, int BK>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N,
                   int K, int vec_x, int vec_w, cudaStream_t stream) {
  const int smem = (BM * (BK + 8) + BK * (BN + 8)) * 2;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  block_matmul_kernel<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      M, N, K, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// Tiles: bm in {16, 32, 64, 128}, bn in {32, 64, 128}, bk in {32, 64}.
// Returns cudaErrorInvalidValue for any other tile.
int block_matmul_bf16(const void* x, const void* w, void* out, int M, int N,
                      int K, int bm, int bn, int bk, int vec_x, int vec_w,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TILE(BM_, BN_, BK_)                                      \
  if (bm == BM_ && bn == BN_ && bk == BK_)                             \
    return (int)launch<BM_, BN_, BK_>(x, w, out, M, N, K, vec_x, vec_w, s);
#define REPRO_BK(BM_, BN_) REPRO_TILE(BM_, BN_, 32) REPRO_TILE(BM_, BN_, 64)
#define REPRO_BN(BM_) REPRO_BK(BM_, 32) REPRO_BK(BM_, 64) REPRO_BK(BM_, 128)
  REPRO_BN(16)
  REPRO_BN(32)
  REPRO_BN(64)
  REPRO_BN(128)
#undef REPRO_BN
#undef REPRO_BK
#undef REPRO_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
