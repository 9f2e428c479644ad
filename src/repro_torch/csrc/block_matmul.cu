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
// does 2*M FLOPs per weight element, far below the ~295 FLOP/byte at which
// the tensor cores rather than HBM become the limit.  It is bound by the
// bytes of w: gemma-2b's gate/up (2048 x 16384) and down (16384 x 2048)
// weights are 67.1 MB each, 20.0 us at 3.35 TB/s for M = 4 and for
// M = 16 alike (x and out add 0.2-0.6 MB).  Reaching that rate needs a few
// MB of w in flight across the card (HBM latency times its rate).
//
// What the design does about it:
// - A ring of STAGES shared-memory stages (4 to 8, enough for >= 32 KB of
//   w in flight per block) filled by 16-byte cp.async.cg copies, so the
//   loads of the next stages overlap the tensor-core products of the
//   current one; one __syncthreads per K tile.  Fragments come from shared
//   memory through ldmatrix (.trans for w); rows are padded by 16 bytes so
//   the eight row addresses of each 8x8 matrix hit distinct banks.
// - 8 warps a block (4 for the 16 x 32 tile), and a copy loop of constant
//   trip count that steps one pointer per chunk: with one block on an SM
//   (the down projection), issuing the copies, not HBM, was the limit of
//   a 4-warp block whose every copy recomputed its address.
// - Split-K across a thread-block cluster when the output tiles are too
//   few to fill the card (`split_k` in kernels/block_matmul.py picks the
//   size, up to 8).  The blocks of a cluster share one (bm, bn) tile and
//   each walks a contiguous run of K tiles; their fp32 partial tiles meet
//   in distributed shared memory, where rank 0 adds them in rank order,
//   rounds to bf16 once and writes.  One launch, no atomics, no workspace:
//   the result is the same bit for bit from launch to launch.  The
//   level-0 down projection at decode goes from 16 blocks to 16 x 8.
// - Masks instead of padding: a copy outside the problem zero-fills its
//   16 bytes (cp.async with a source size of 0); a ragged row that is not
//   a whole 16-byte chunk (K or N not a multiple of 8, or a misaligned
//   base) is loaded element by element.  bm is clamped to the problem by
//   the wrapper (16 rows in decode).
// The tile (bm, bn, bk) is the per-level code version and a template
// parameter; the entry point instantiates every tile of the port's table.
// Not yet done: wgmma/TMA for prefill-sized M, persistent blocks.
#include <cooperative_groups.h>

#include "sm90_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;

// Threads of a block: 8 warps, or 4 for the (16, 32) tile, whose 16 x 32
// output has no work for more (each warp owns >= one 16 x 8 fragment).
__host__ __device__ constexpr int block_threads(int bm, int bn) {
  return (bm == 16 && bn == 32) ? 128 : 256;
}

// Ring depth: enough stages that STAGES - 1 of them hold >= 32 KB of w,
// between 4 and 8.
__host__ __device__ constexpr int ring_stages(int bk, int bn) {
  const int w_bytes = bk * bn * 2;
  const int s = 1 + (32768 + w_bytes - 1) / w_bytes;
  return s < 4 ? 4 : (s > 8 ? 8 : s);
}

// Dynamic shared memory: the ring of row-padded x and w tiles, or the
// fp32 partial tile of a split, whichever is larger (exported as
// block_matmul_smem_bytes for `smem_bytes` in kernels/block_matmul.py).
__host__ __device__ constexpr int smem_size(int bm, int bn, int bk) {
  const int ring = ring_stages(bk, bn) * (bm * (bk + 8) + bk * (bn + 8)) * 2;
  const int part = bm * bn * 4;
  return ring > part ? ring : part;
}

// One thread's share of an (R, C) bf16 tile at (row0, col0) of a
// row-major (rows, cols) matrix, into shared memory of row stride SD,
// zero-filling outside the matrix.  The tile's 8-element chunks are dealt
// to the threads in order, so a thread's chunks share one column and
// step down the rows by THREADS / (C / 8): the loop has a constant trip
// count and advances one pointer.  With `vec` (cols a multiple of 8 and a
// 16-byte aligned base) a chunk is wholly inside or outside the matrix
// and goes by cp.async; otherwise element by element (a ragged edge).
template <int R, int C, int SD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int col0, int rows, int cols,
                                          int vec, int tid) {
  constexpr int CPR = C / 8;  // chunks per tile row
  constexpr int CHUNKS = R * CPR;
  constexpr int STEP = THREADS / CPR;  // rows between a thread's chunks
  static_assert(THREADS % CPR == 0, "chunk layout");
  const int r0 = tid / CPR, cc = (tid % CPR) * 8;
  const int col = col0 + cc;
  if (vec) {
    const bool col_in = col < cols;
    const __nv_bfloat16* p = src + (size_t)(row0 + r0) * cols + col;
    const size_t p_step = (size_t)STEP * cols;
#pragma unroll
    for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int r = r0 + it * STEP;
      if (CHUNKS % THREADS == 0 || r < R) {
        const bool in = col_in && row0 + r < rows;
        sm90::cp_async16(dst + r * SD + cc, in ? p : src, in ? 16 : 0);
      }
      p += p_step;
    }
    return;
  }
  for (int r = r0; r < R; r += STEP) {
    const int row = row0 + r;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[r * SD + cc + e] = (row < rows && col + e < cols)
                                 ? src[(size_t)row * cols + col + e]
                                 : __float2bfloat16(0.0f);
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(block_threads(BM, BN))
    block_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, int M, int N, int K,
                        int vec_x, int vec_w, int split) {
  constexpr int kThreads = block_threads(BM, BN);
  constexpr int STAGES = ring_stages(BK, BN);
  constexpr int SA = BK + 8;  // padded row strides (bf16 elements)
  constexpr int SB = BN + 8;
  constexpr int A_ELEMS = BM * SA;
  constexpr int STAGE_ELEMS = A_ELEMS + BK * SB;
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = (kThreads / 32) / WARPS_M;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int MI = WM / 16;
  constexpr int NI = WN / 8;
  static_assert(MI >= 1 && NI >= 1 && BK % 16 == 0, "unsupported tile");
  static_assert(MI * NI * kThreads * 16 <= smem_size(BM, BN, BK),
                "the partial tile must fit the block's shared memory");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, c = lane & 3;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * BN, m0 = blockIdx.y * BM;
  int kt0, kt1;
  sm90::split_range((K + BK - 1) / BK, split, rank, kt0, kt1);
  const int nk = kt1 - kt0;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto load_stage = [&](int slot, int kt) {
    __nv_bfloat16* sA = ring + slot * STAGE_ELEMS;
    __nv_bfloat16* sB = sA + A_ELEMS;
    const int k0 = kt * BK;
    load_tile<BM, BK, SA, kThreads>(sA, x, m0, k0, M, K, vec_x, tid);
    load_tile<BK, BN, SB, kThreads>(sB, w, k0, n0, K, N, vec_w, tid);
  };

  // prologue: STAGES - 1 tiles in flight (empty groups past the run keep
  // the group count, and so the wait below, uniform)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kt0 + s);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    sm90::cp_async_wait<STAGES - 2>();  // tile i has landed (this thread)
    __syncthreads();  // ... for every thread; slot (i-1) % STAGES is free
    const int nxt = i + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, kt0 + nxt);
    sm90::cp_async_commit();

    const __nv_bfloat16* sA = ring + (i % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* sB = sA + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        sm90::ldmatrix_x4(af[mi], sA + (wm * WM + mi * 16 + (lane & 15)) * SA +
                                      kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        const __nv_bfloat16* p = sB + (kk + (lane & 15)) * SB + wn * WN + j * 8;
        if (j + 1 < NI) {
          uint32_t b[4];
          sm90::ldmatrix_x4_trans(b, p + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            sm90::mma_bf16_16816(acc[mi][j], af[mi], b[0], b[1]);
            sm90::mma_bf16_16816(acc[mi][j + 1], af[mi], b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          sm90::ldmatrix_x2_trans(b, p);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            sm90::mma_bf16_16816(acc[mi][j], af[mi], b[0], b[1]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partial tile below

  if (split > 1) {
    // every rank stores its fp32 partial tile in its own shared memory,
    // one float4 per (fragment, thread); rank 0 reads the same positions
    // of ranks 1..split-1 in order and adds them to its registers
    cg::cluster_group cluster = cg::this_cluster();
    float4* part = reinterpret_cast<float4*>(smem);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        part[(i * NI + j) * kThreads + tid] =
            make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                        acc[i][j][3]);
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r) {
        const float4* rp = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const float4 v = rp[(i * NI + j) * kThreads + tid];
            acc[i][j][0] += v.x;
            acc[i][j][1] += v.y;
            acc[i][j][2] += v.z;
            acc[i][j][3] += v.w;
          }
      }
    }
    cluster.sync();  // ranks 1.. keep their shared memory until read
    if (rank != 0) return;
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
                   int K, int vec_x, int vec_w, int split,
                   cudaStream_t stream) {
  auto kernel = block_matmul_kernel<BM, BN, BK>;
  constexpr int smem = smem_size(BM, BN, BK);
  constexpr int threads = block_threads(BM, BN);
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + BN - 1) / BN) * split, (M + BM - 1) / BM);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel,
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<__nv_bfloat16*>(out), M, N, K, vec_x,
                            vec_w, split);
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// Tiles: bm in {16, 32, 64, 128}, bn in {32, 64, 128}, bk in {32, 64};
// split (the cluster size) in 1..8.  Returns cudaErrorInvalidValue for
// anything else.
int block_matmul_bf16(const void* x, const void* w, void* out, int M, int N,
                      int K, int bm, int bn, int bk, int vec_x, int vec_w,
                      int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || split > kMaxSplit) return (int)cudaErrorInvalidValue;
#define REPRO_TILE(BM_, BN_, BK_)                                           \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                  \
    return (int)launch<BM_, BN_, BK_>(x, w, out, M, N, K, vec_x, vec_w,     \
                                      split, s);
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

// Dynamic shared memory of the block block_matmul_bf16 launches for a
// tile, or -1 for a tile it is not built for.
int block_matmul_smem_bytes(int bm, int bn, int bk) {
  const bool built = (bm == 16 || bm == 32 || bm == 64 || bm == 128) &&
                     (bn == 32 || bn == 64 || bn == 128) &&
                     (bk == 32 || bk == 64);
  return built ? smem_size(bm, bn, bk) : -1;
}

}  // extern "C"
