// The flash-attention block shared by flash_attention.cu (B2: keys in
// dense per-row caches) and flash_attention_paged.cu (B3: keys read
// through a page table); the design and its reasons are in
// flash_attention.cu's header.  The two kernels differ only in where key j
// of a block's (batch row, KV head) lives, which a key policy says:
//   DenseKeys  token b * T + j of the (B, T, KH, D) cache;
//   PagedKeys  token table[b, j / ps] * ps + j % ps of the (P, ps, KH, D)
//              pool, the row's table entries for the block's keys staged
//              in shared memory once (a key's address is then one
//              shared-memory read, not a dependent global load).
// Either way the D values of one key and KV head are contiguous, so a
// 16-byte cp.async copies 8 of them wherever the key lives.
#pragma once

#include <cooperative_groups.h>

#include "sm90_tiles.cuh"

namespace flash {

namespace cg = cooperative_groups;

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
// conflicts.  A paged block adds its staged table entries after BYTES.
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

// Keys of batch row b in a dense (B, T, KH, D) cache.
struct DenseKeys {
  static constexpr bool kStaged = false;
  int b, T;
  __device__ __forceinline__ void stage(int, int, int) {}
  __device__ __forceinline__ int token(int kpos) const { return b * T + kpos; }
};

// Keys of one row in a (P, ps, KH, D) pool: key j is slot j % ps of
// physical page table[j / ps].  stage() copies the entries that address
// keys [k_begin, k_end) into shared memory (`tab`, first entry p0).
struct PagedKeys {
  static constexpr bool kStaged = true;
  const int* table;  // this row's n_slot entries
  int* tab;
  int ps, n_slot, p0;
  __device__ __forceinline__ void stage(int k_begin, int k_end, int tid) {
    p0 = k_begin / ps;
    const int p1 = min(n_slot, (k_end + ps - 1) / ps);
    for (int i = p0 + tid; i < p1; i += kThreads) tab[i - p0] = table[i];
  }
  __device__ __forceinline__ int token(int kpos) const {
    return tab[kpos / ps - p0] * ps + kpos % ps;
  }
};

// One block's work.  q / out are (B, S, H, D); k / v hold T keys per row
// as `keys` addresses them; bq flattened rows per block; blockIdx =
// (query tile * split + rank, KV head, batch row).
template <int D, int RG, int BKV, class Keys>
__device__ __forceinline__ void attend_block(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ out, const int* __restrict__ offset,
    const int* __restrict__ kv_valid, int S, int H, int T, int KH, int bq,
    int window, float softcap, float scale, int split, Keys keys) {
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
  if constexpr (Keys::kStaged) {
    if (n > 0)
      keys.stage(max(lo, (t_first + tb) * BKV),
                 min(hi, (t_first + te) * BKV), tid);
    __syncthreads();  // the staged entries address the first tile's keys
  }

  auto load_kv = [&](int slot, int tile) {
    __nv_bfloat16* sK = sKV + slot * 2 * Lay::KV_ELEMS;
    __nv_bfloat16* sV = sK + Lay::KV_ELEMS;
    const int t0 = (t_first + tile) * BKV;
    for (int idx = tid; idx < BKV * D / 8; idx += kThreads) {
      const int j = idx / (D / 8), cc = (idx % (D / 8)) * 8;
      const int kpos = t0 + j;
      const bool in = kpos >= lo && kpos < hi;
      const size_t src =
          in ? ((size_t)keys.token(kpos) * KH + kvh) * D + cc : 0;
      sm90::cp_async16(sK + j * Lay::SKV + cc, k + src, in ? 16 : 0);
      sm90::cp_async16(sV + j * Lay::SKV + cc, v + src, in ? 16 : 0);
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

}  // namespace flash
