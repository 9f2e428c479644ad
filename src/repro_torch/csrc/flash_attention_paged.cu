// flash_attention_paged: decode attention read through a per-slot page
// table, q (B,S,H,D) bf16, k/v pools (P,ps,KH,D) bf16, page_table
// (B,n_slot) int32 -> out (B,S,H,D) bf16.
//
// Replaces the TPU kernel `_paged_flash_kernel` / `flash_attention_paged`
// (src/repro/kernels/flash_attention.py:141,149).  The TPU version walks a
// sequential (B, H, 1, n_slot) grid: the page table is a scalar-prefetch
// operand, the KV BlockSpec index map reads table[b, ki], so each grid step
// DMAs exactly one physical page into VMEM and runs the dense flash body on
// it (the KV block is the page).  Query i of row b sits at absolute position
// offset[b] + i; key j lives at pool[table[b, j / ps], j % ps] and is
// visible when j <= q_pos, j < min(kv_valid[b], n_slot * ps) and, with a
// window w, j > q_pos - w.
//
// What bounds it on an H100: decode (S = 1) reads each row's visible keys
// once, 4*D bytes of K and V per key, for 4*D FLOPs per key and query head;
// even with all H/KH query heads of a group sharing one read that is under
// 8 FLOPs per byte, so the bytes of the visible pages bound it, and at the
// serve's sizes (a few hundred keys per row, under 1 MB in all) the launch
// and the latency of one tile's loads are most of the time.
//
// What the design does about it: the dense kernel's block
// (`flash::attend_block` in flash_block.cuh) over keys gathered through
// the table, so a 64-key tile is ceil(64 / ps) page runs of D contiguous
// bf16 per key, copied by 16-byte cp.async:
// - one block per (KV head, batch row, tile of up to 64 flattened S x G
//   query rows), every query head of the group in it, so each page's K and
//   V cross HBM once;
// - the row's page-table entries that address the block's keys are staged
//   in shared memory once, before the first tile: a key's address is one
//   shared-memory read, not a global load the tile's copy waits on;
// - double-buffered tile copies, tensor-core Q.K^T and P.V (P as bf16 hi +
//   lo), a warp per softmax row;
// - split-KV across a cluster of up to 8 blocks (`launch_geometry` in
//   kernels/flash_attention_paged.py, from the static shapes only: the
//   visible keys are on the device), combined by rank 0 in rank order;
//   4 rows x 1 KV head at the serve's decode get 32 blocks, not 4.
// Only keys in [lo, hi) are copied; the rest of a tile (a tile straddling
// hi or lo, the trash page, unmapped entries) is zero-filled and never
// read, so garbage of any value cannot reach the output through 0 * NaN.
// D in {32, 64, 128, 256}; the key tile is 64.  Shared memory is the dense
// kernel's layout plus the staged entries (n_slot int32, 16-byte aligned).
#include "flash_block.cuh"

namespace {

using flash::kThreads;
using flash::kMaxSplit;
using flash::Layout;

constexpr int kTile = 64;  // keys per shared-memory KV tile
constexpr int kMaxSmem = 227 * 1024;

int table_bytes(int n_slot) { return (n_slot * 4 + 15) / 16 * 16; }

template <int D, int RG>
__global__ void __launch_bounds__(kThreads, 1)
    paged_flash_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ page_table,
                       const int* __restrict__ offset,
                       const int* __restrict__ kv_valid, int S, int H, int KH,
                       int ps, int n_slot, int bq, int window, float softcap,
                       float scale, int split) {
  extern __shared__ __align__(16) unsigned char smem[];
  flash::PagedKeys keys{
      page_table + (size_t)blockIdx.z * n_slot,
      reinterpret_cast<int*>(smem + Layout<D, RG, kTile>::BYTES), ps, n_slot,
      0};
  flash::attend_block<D, RG, kTile>(smem, q, k_pool, v_pool, out, offset,
                                    kv_valid, S, H, n_slot * ps, KH, bq,
                                    window, softcap, scale, split, keys);
}

template <int D, int RG>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* table, const void* offset, const void* kv_valid,
                   int B, int S, int H, int KH, int ps, int n_slot, int bq,
                   int window, float softcap, float scale, int split,
                   cudaStream_t stream) {
  auto kernel = paged_flash_kernel<D, RG>;
  const int smem = Layout<D, RG, kTile>::BYTES + table_bytes(n_slot);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
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
      static_cast<const int*>(table), static_cast<const int*>(offset),
      static_cast<const int*>(kv_valid), S, H, KH, ps, n_slot, bq, window,
      softcap, scale, split);
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// page_table is (B, n_slot) int32, offset and kv_valid are (B,) int32, all
// on the device.  bq is the number of flattened (query, head-of-group) rows
// per block, at most 64; D in {32, 64, 128, 256}; split (the cluster size)
// in 1..8.  window <= 0 means no window, softcap <= 0 no softcap.  Returns
// cudaErrorInvalidValue for anything else, or for a block whose shared
// memory exceeds the card's.
int flash_attention_paged_bf16(const void* q, const void* k_pool,
                               const void* v_pool, void* out,
                               const void* page_table, const void* offset,
                               const void* kv_valid, int B, int S, int H,
                               int KH, int D, int ps, int n_slot, int bq,
                               int window, float softcap, float scale,
                               int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || split > kMaxSplit || bq < 1 || bq > 64 || ps < 1 ||
      n_slot < 1)
    return (int)cudaErrorInvalidValue;
  const int rg = bq <= 16 ? 1 : (bq <= 32 ? 2 : 4);
#define REPRO_CASE(D_, RG_)                                                  \
  if (D == D_ && rg == RG_)                                                  \
    return (int)launch<D_, RG_>(q, k_pool, v_pool, out, page_table, offset, \
                                kv_valid, B, S, H, KH, ps, n_slot, bq,       \
                                window, softcap, scale, split, s);
#define REPRO_RG(D_) REPRO_CASE(D_, 1) REPRO_CASE(D_, 2) REPRO_CASE(D_, 4)
  REPRO_RG(32)
  REPRO_RG(64)
  REPRO_RG(128)
  REPRO_RG(256)
#undef REPRO_RG
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the block flash_attention_paged_bf16 launches
// for bq flattened rows at head_dim D over n_slot table entries a row
// (`smem_bytes` in kernels/flash_attention_paged.py), or -1 for a block it
// is not built for.
int flash_attention_paged_smem_bytes(int bq, int D, int n_slot) {
  if (bq < 1 || bq > 64 || n_slot < 1) return -1;
  const int rg = bq <= 16 ? 1 : (bq <= 32 ? 2 : 4);
#define REPRO_CASE(D_, RG_) \
  if (D == D_ && rg == RG_) \
    return Layout<D_, RG_, kTile>::BYTES + table_bytes(n_slot);
#define REPRO_RG(D_) REPRO_CASE(D_, 1) REPRO_CASE(D_, 2) REPRO_CASE(D_, 4)
  REPRO_RG(32)
  REPRO_RG(64)
  REPRO_RG(128)
  REPRO_RG(256)
#undef REPRO_RG
#undef REPRO_CASE
  return -1;
}

}  // extern "C"
