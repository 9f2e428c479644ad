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
// What the design does about it:
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
#include <cooperative_groups.h>

#include "sm90_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ bool visible(int kpos, int qpos, int kv_valid,
                                        int window) {
  return kpos <= qpos && kpos < kv_valid &&
         (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory layout in bytes (`smem_bytes` in
// kernels/flash_attention.py): bf16 Q tile, fp32 scores, bf16 P hi and lo,
// fp32 m / l / alpha per row, then the double-buffered K and V tiles,
// whose room holds the fp32 partial accumulator of a split at the end.
// Row strides are padded by 16 bytes (bf16) so ldmatrix is free of bank
// conflicts.
template <int D, int RG, int BKV>
struct Layout {
  static constexpr int BQ = RG * 16;  // padded query rows
  static constexpr int SQ = D + 8;
  static constexpr int SS = BKV + 4;
  static constexpr int SP = BKV + 8;
  static constexpr int SKV = D + 8;
  static constexpr int S = BQ * SQ * 2;
  static constexpr int PH = S + BQ * SS * 4;
  static constexpr int PL = PH + BQ * SP * 2;
  static constexpr int M = PL + BQ * SP * 2;
  static constexpr int L = M + BQ * 4;
  static constexpr int ALPHA = L + BQ * 4;
  static constexpr int KV = ALPHA + BQ * 4;
  static constexpr int KV_ELEMS = BKV * SKV;  // one K or V tile
  static constexpr int RING = 2 * 2 * KV_ELEMS * 2;
  // the partial: one float4 per (fragment, accumulator thread), exactly
  // BQ x D fp32 however many warps hold the accumulator
  static constexpr int PART = BQ * D * 4;
  static constexpr int BYTES = KV + (RING > PART ? RING : PART);
};

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
  using Lay = Layout<D, RG, BKV>;
  constexpr int BQ = Lay::BQ;
  // accumulator split: RG row groups x WD slices of DW columns
  constexpr int WD = (kWarps / RG) < (D / 16) ? (kWarps / RG) : (D / 16);
  constexpr int DW = D / WD;
  constexpr int NI = DW / 8;
  constexpr int kAccThreads = RG * WD * 32;  // threads holding acc
  static_assert(NI % 2 == 0 && RG * WD <= kWarps && D % 32 == 0,
                "unsupported head_dim / row tile");
  static_assert(NI * kAccThreads * 16 == Lay::PART, "partial layout");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sS = reinterpret_cast<float*>(smem + Lay::S);
  __nv_bfloat16* sPh = reinterpret_cast<__nv_bfloat16*>(smem + Lay::PH);
  __nv_bfloat16* sPl = reinterpret_cast<__nv_bfloat16*>(smem + Lay::PL);
  float* sM = reinterpret_cast<float*>(smem + Lay::M);
  float* sL = reinterpret_cast<float*>(smem + Lay::L);
  float* sAlpha = reinterpret_cast<float*>(smem + Lay::ALPHA);
  __nv_bfloat16* sKV = reinterpret_cast<__nv_bfloat16*>(smem + Lay::KV);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int rank = blockIdx.x % split;
  const int q0 = (blockIdx.x / split) * bq;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int rows = min(bq, S * G - q0);  // real flattened rows of the tile
  const int off = offset[b];
  const int kvl = min(kv_valid[b], T);

  for (int r = tid; r < BQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  // keys some row of this tile can see: [lo, hi), in KV tiles [t_first,
  // t_first + n_tiles); this rank takes [tb, te) of them
  const int qlo = off + q0 / G, qhi = off + (q0 + rows - 1) / G;
  const int hi = min(kvl, qhi + 1);
  const int lo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int t_first = lo / BKV;
  const int n_tiles = hi > lo ? (hi + BKV - 1) / BKV - t_first : 0;
  int tb, te;
  sm90::split_range(n_tiles, split, rank, tb, te);
  const int n = te - tb;

  // Q rows: row r is query (q0 + r) / G of head kvh * G + (q0 + r) % G
  // (a rank with no KV tile needs none)
  for (int idx = tid; n > 0 && idx < BQ * D / 8; idx += kThreads) {
    const int r = idx / (D / 8), cc = (idx % (D / 8)) * 8;
    const int fr = q0 + r;
    const bool in = r < rows;
    const __nv_bfloat16* src =
        in ? q + ((size_t)(b * S + fr / G) * H + kvh * G + fr % G) * D + cc
           : q;
    sm90::cp_async16(sQ + r * Lay::SQ + cc, src, in ? 16 : 0);
  }

  auto load_kv = [&](int slot, int tile) {
    __nv_bfloat16* sK = sKV + slot * 2 * Lay::KV_ELEMS;
    __nv_bfloat16* sV = sK + Lay::KV_ELEMS;
    const int t0 = (t_first + tile) * BKV;
    for (int idx = tid; idx < BKV * D / 8; idx += kThreads) {
      const int j = idx / (D / 8), cc = (idx % (D / 8)) * 8;
      const int kpos = t0 + j;
      const bool in = kpos >= lo && kpos < hi;
      const size_t src = ((size_t)(b * T + kpos) * KH + kvh) * D + cc;
      sm90::cp_async16(sK + j * Lay::SKV + cc, in ? k + src : k,
                       in ? 16 : 0);
      sm90::cp_async16(sV + j * Lay::SKV + cc, in ? v + src : v,
                       in ? 16 : 0);
    }
  };

  float acc[NI][4];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const bool o_warp = warp < RG * WD;
  const int rg = warp / WD, wd = warp % WD;  // this warp's slice of acc

  if (n > 0) load_kv(0, tb);
  sm90::cp_async_commit();  // Q and the first tile
  for (int i = 0; i < n; ++i) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile i landed; iteration i-1 is done with the
                      // other buffer, the scores and the probabilities
    if (i + 1 < n) load_kv((i + 1) & 1, tb + i + 1);
    sm90::cp_async_commit();
    const __nv_bfloat16* sK = sKV + (i & 1) * 2 * Lay::KV_ELEMS;
    const __nv_bfloat16* sV = sK + Lay::KV_ELEMS;
    const int t0 = (t_first + tb + i) * BKV;

    // scores: 16 rows x 8 keys per unit, D/32 double k-steps each
    for (int u = warp; u < RG * (BKV / 8); u += kWarps) {
      const int ur = u / (BKV / 8), nb = u % (BKV / 8);
      float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat16* qa =
          sQ + (ur * 16 + (lane & 15)) * Lay::SQ + (lane >> 4) * 8;
      const __nv_bfloat16* kb =
          sK + (nb * 8 + (lane & 7)) * Lay::SKV + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < D; kk += 32) {
        uint32_t a0[4], a1[4], bk[4];
        sm90::ldmatrix_x4(a0, qa + kk);
        sm90::ldmatrix_x4(a1, qa + kk + 16);
        sm90::ldmatrix_x4(bk, kb + kk);
        sm90::mma_bf16_16816(sc, a0, bk[0], bk[1]);
        sm90::mma_bf16_16816(sc, a1, bk[2], bk[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[e] *= scale;
        if (softcap > 0.0f) sc[e] = tanhf(sc[e] / softcap) * softcap;
      }
      float* s0 = sS + (ur * 16 + g) * Lay::SS + nb * 8 + 2 * c;
      *reinterpret_cast<float2*>(s0) = make_float2(sc[0], sc[1]);
      *reinterpret_cast<float2*>(s0 + 8 * Lay::SS) =
          make_float2(sc[2], sc[3]);
    }
    __syncthreads();

    // online softmax, a warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = off + (q0 + r) / G;
      const bool real = r < rows;
      const float m_prev = sM[r];
      float sv[(BKV + 31) / 32];
      float m_cur = m_prev;
#pragma unroll
      for (int jj = 0; jj < (BKV + 31) / 32; ++jj) {
        const int j = lane + 32 * jj;
        const bool vis = real && j < BKV && visible(t0 + j, qpos, kvl, window);
        sv[jj] = vis ? sS[r * Lay::SS + j] : kNegInf;
        m_cur = fmaxf(m_cur, sv[jj]);
      }
      m_cur = warp_max(m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < (BKV + 31) / 32; ++jj) {
        const int j = lane + 32 * jj;
        const bool vis = real && j < BKV && visible(t0 + j, qpos, kvl, window);
        const float p = vis ? expf(sv[jj] - m_cur) : 0.0f;
        sum += p;
        if (j < BKV) {
          const __nv_bfloat16 ph = __float2bfloat16(p);
          sPh[r * Lay::SP + j] = ph;
          sPl[r * Lay::SP + j] = __float2bfloat16(p - __bfloat162float(ph));
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_cur;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + (P_hi + P_lo) . V on this warp's slice
    if (o_warp) {
      const float a_lo = sAlpha[rg * 16 + g], a_hi = sAlpha[rg * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        acc[j][0] *= a_lo;
        acc[j][1] *= a_lo;
        acc[j][2] *= a_hi;
        acc[j][3] *= a_hi;
      }
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        uint32_t ph[4], pl[4];
        const int po = (rg * 16 + (lane & 15)) * Lay::SP + kk + (lane >> 4) * 8;
        sm90::ldmatrix_x4(ph, sPh + po);
        sm90::ldmatrix_x4(pl, sPl + po);
#pragma unroll
        for (int j = 0; j < NI; j += 2) {
          uint32_t bv[4];
          sm90::ldmatrix_x4_trans(bv, sV + (kk + (lane & 15)) * Lay::SKV +
                                          wd * DW + j * 8 + (lane >> 4) * 8);
          sm90::mma_bf16_16816(acc[j], ph, bv[0], bv[1]);
          sm90::mma_bf16_16816(acc[j], pl, bv[0], bv[1]);
          sm90::mma_bf16_16816(acc[j + 1], ph, bv[2], bv[3]);
          sm90::mma_bf16_16816(acc[j + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the K/V room is free: it holds the partial below

  const int ra = rg * 16 + g, rb = ra + 8;  // this thread's two rows
  float l_a = o_warp ? sL[ra] : 0.0f, l_b = o_warp ? sL[rb] : 0.0f;
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    float4* part = reinterpret_cast<float4*>(smem + Lay::KV);
    if (o_warp) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
        part[j * kAccThreads + tid] =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    cluster.sync();
    if (rank == 0 && o_warp) {
      // m = max over ranks; each rank's l and acc scaled by exp(m_r - m)
      // and summed in rank order
      float m_a = kNegInf, m_b = kNegInf;
      for (int r = 0; r < split; ++r) {
        const float* rm = cluster.map_shared_rank(sM, r);
        m_a = fmaxf(m_a, rm[ra]);
        m_b = fmaxf(m_b, rm[rb]);
      }
      const float f_a = expf(sM[ra] - m_a), f_b = expf(sM[rb] - m_b);
      l_a *= f_a;
      l_b *= f_b;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        acc[j][0] *= f_a;
        acc[j][1] *= f_a;
        acc[j][2] *= f_b;
        acc[j][3] *= f_b;
      }
      for (int r = 1; r < split; ++r) {
        // l = 0: no key of rank r's run is visible to these rows, so its
        // l and acc are exactly 0 and adding them changes nothing
        const float* rl = cluster.map_shared_rank(sL, r);
        const float lr_a = rl[ra], lr_b = rl[rb];
        if (lr_a == 0.0f && lr_b == 0.0f) continue;
        const float* rm = cluster.map_shared_rank(sM, r);
        const float4* rp = cluster.map_shared_rank(part, r);
        const float fa = expf(rm[ra] - m_a), fb = expf(rm[rb] - m_b);
        l_a += lr_a * fa;
        l_b += lr_b * fb;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float4 p = rp[j * kAccThreads + tid];
          acc[j][0] += p.x * fa;
          acc[j][1] += p.y * fa;
          acc[j][2] += p.z * fb;
          acc[j][3] += p.w * fb;
        }
      }
    }
    cluster.sync();  // ranks 1.. keep their shared memory until read
    if (rank != 0) return;
  }
  if (!o_warp) return;
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= rows) continue;
    const int fr = q0 + r;
    __nv_bfloat16* o =
        out + ((size_t)(b * S + fr / G) * H + kvh * G + fr % G) * D + wd * DW +
        2 * c;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int j = 0; j < NI; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * half] * inv, acc[j][2 * half + 1] * inv);
  }
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
