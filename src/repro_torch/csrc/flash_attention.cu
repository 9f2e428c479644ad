// flash_attention: causal GQA/MQA attention with an online softmax,
// q (B,S,H,D), k/v (B,T,KH,D) bf16 -> out (B,S,H,D) bf16.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention`
// (src/repro/kernels/flash_attention.py:31,81).  The TPU version walks a
// sequential (B, H, S/bq, T/bkv) grid with the KV axis innermost and keeps
// the running max m, denominator l and fp32 output accumulator in VMEM
// scratch across the KV steps.  Query i of row b sits at absolute position
// offset[b] + i; key j is visible when j <= q_pos, j < kv_valid[b] and,
// with a window w, j > q_pos - w.
//
// What bounds it on an H100: on the serving path it reads each row's
// visible K/V once per KV group (decode: S = 1, 4*D FLOPs per key and
// query head against 4*D bytes of K and V; a 16-token chunk: 16x that),
// so the bytes of the KV cache bound it, and at the serve's sizes (a few
// hundred keys per row, under 1 MB in all) the launch and the latency of
// one tile's load are most of the time.
//
// What the design does about it (the block is `flash::attend_block` in
// flash_block.cuh, shared with flash_attention_paged.cu):
// - One block per (KV head, batch row, query tile) holding every query
//   head of the KV group: the tile runs over the flattened (S x G) axis,
//   row r = s*G + g at position offset[b] + s, so each K/V byte crosses HBM
//   once per group (gemma-2b: 8 query heads on one KV head), not once per
//   head.  bq counts flattened rows (16, 32 or 64 after padding).
// - Tensor cores: Q.K^T by mma.sync m16n8k16 (bf16 in, fp32 sums), the
//   scale D**-0.5 applied to the fp32 scores (exact at D = 256: 1/16).
//   P.V too: P is split into bf16 hi + lo and both products are summed,
//   so the probabilities keep ~2^-17 relative precision (the plain
//   version's fp32 contract).  Fragments come by ldmatrix (.trans for V).
// - A warp per softmax row with shuffles; the reference's masking:
//   masked scores at -2.3819763e38, masked probabilities zeroed, the
//   denominator clamped at 1e-30 so a fully masked row writes 0.
// - K/V tiles double-buffered by 16-byte cp.async copies, over only the
//   tiles that hold a key some row of the tile can see ([lo, hi): the
//   window's first key to min(kv_valid, last query position + 1)); keys
//   outside [lo, hi) are zero-filled, never read, so garbage past
//   kv_valid cannot reach the output through 0 * inf.
// - Split-KV across a thread-block cluster of up to 8 blocks
//   (`split_kv` in kernels/flash_attention.py): each takes a contiguous
//   run of the visible KV tiles, and rank 0 combines the partial (m, l,
//   acc) through distributed shared memory in rank order with the exact
//   rescale algebra.  One launch, deterministic.
// - The fp32 accumulator (padded rows x D) is split over the 8 warps by
//   16-row group and D slice (at most 64 floats a thread at D = 256).
// The row-group count, the key tile bkv and D are template parameters:
// D in {32, 64, 128, 256}, bkv in {16, 32, 64}.  At D = 256, 64 rows and a
// 64-key tile a block needs 205,568 bytes of dynamic shared memory.
#include "flash_block.cuh"

namespace {

using flash::kThreads;
using flash::kMaxSplit;
using flash::Layout;

template <int D, int RG, int BKV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           const int* __restrict__ offset,
                           const int* __restrict__ kv_valid, int S, int H,
                           int T, int KH, int bq, int window, float softcap,
                           float scale, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  flash::attend_block<D, RG, BKV>(smem, q, k, v, out, offset, kv_valid, S, H,
                                  T, KH, bq, window, softcap, scale, split,
                                  flash::DenseKeys{(int)blockIdx.z, T});
}

template <int D, int RG, int BKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* offset, const void* kv_valid, int B, int S,
                   int H, int T, int KH, int bq, int window, float softcap,
                   float scale, int split, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D, RG, BKV>;
  constexpr int smem = Layout<D, RG, BKV>::BYTES;
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int q_tiles = (S * (H / KH) + bq - 1) / bq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_tiles * split, KH, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(offset), static_cast<const int*>(kv_valid), S,
      H, T, KH, bq, window, softcap, scale, split);
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// offset and kv_valid are (B,) int32 on the device.  bq is the number of
// flattened (query, head-of-group) rows per block, at most 64; bkv in
// {16, 32, 64}; D in {32, 64, 128, 256}; split (the cluster size) in 1..8.
// window <= 0 means no window, softcap <= 0 no softcap.  Returns
// cudaErrorInvalidValue for anything else.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, const void* offset, const void* kv_valid,
                         int B, int S, int H, int T, int KH, int D, int bq,
                         int bkv, int window, float softcap, float scale,
                         int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || split > kMaxSplit || bq < 1 || bq > 64)
    return (int)cudaErrorInvalidValue;
  const int rg = bq <= 16 ? 1 : (bq <= 32 ? 2 : 4);
#define REPRO_CASE(D_, RG_, BKV_)                                            \
  if (D == D_ && rg == RG_ && bkv == BKV_)                                   \
    return (int)launch<D_, RG_, BKV_>(q, k, v, out, offset, kv_valid, B, S, \
                                      H, T, KH, bq, window, softcap, scale,  \
                                      split, s);
#define REPRO_BKV(D_, RG_) \
  REPRO_CASE(D_, RG_, 16) REPRO_CASE(D_, RG_, 32) REPRO_CASE(D_, RG_, 64)
#define REPRO_RG(D_) REPRO_BKV(D_, 1) REPRO_BKV(D_, 2) REPRO_BKV(D_, 4)
  REPRO_RG(32)
  REPRO_RG(64)
  REPRO_RG(128)
  REPRO_RG(256)
#undef REPRO_RG
#undef REPRO_BKV
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the block flash_attention_bf16 launches for
// (bq, bkv, D) (`smem_bytes` in kernels/flash_attention.py), or -1 for
// a block it is not built for.
int flash_attention_smem_bytes(int bq, int bkv, int D) {
  if (bq < 1 || bq > 64) return -1;
  const int rg = bq <= 16 ? 1 : (bq <= 32 ? 2 : 4);
#define REPRO_CASE(D_, RG_, BKV_) \
  if (D == D_ && rg == RG_ && bkv == BKV_) return Layout<D_, RG_, BKV_>::BYTES;
#define REPRO_BKV(D_, RG_) \
  REPRO_CASE(D_, RG_, 16) REPRO_CASE(D_, RG_, 32) REPRO_CASE(D_, RG_, 64)
#define REPRO_RG(D_) REPRO_BKV(D_, 1) REPRO_BKV(D_, 2) REPRO_BKV(D_, 4)
  REPRO_RG(32)
  REPRO_RG(64)
  REPRO_RG(128)
  REPRO_RG(256)
#undef REPRO_RG
#undef REPRO_BKV
#undef REPRO_CASE
  return -1;
}

}  // extern "C"
