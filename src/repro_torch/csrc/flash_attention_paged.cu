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
// 8 FLOPs per byte, so it is bound by the bytes of the visible pages.
//
// What the design does about it:
// - One block per (KV head, batch row).  The block holds every query head
//   of the KV head's group (rows = S * H/KH; gemma-2b: 8 query heads on
//   one KV head), so each page's K and V cross HBM once, not once per
//   query head as in the TPU grid and in the dense kernel.
// - A page of 8 or 16 tokens is smaller than a useful tile, so the block
//   gathers 64 consecutive logical keys (several pages, each page's
//   physical index read from the table) into one shared-memory KV tile
//   with 16-byte loads; a key row of one page is D contiguous bf16.
// - The loop covers only the keys some query can see, [lo, hi) with
//   hi = min(kv_valid, last query position + 1) and lo the window's first
//   key, so a decode row reads ceil(hi / ps) pages' worth of keys, never
//   the whole slot.  Keys outside [lo, hi) are neither loaded nor
//   multiplied: the trash page and unmapped entries are never read, and
//   skipping a fully masked key is exact (it leaves m, l and the
//   accumulator unchanged).
// - Numerics are the TPU kernel's: q upcast to fp32 and then scaled by
//   D**-0.5, optional tanh softcap, masked scores set to -2.3819763e38,
//   masked probabilities zeroed, fp32 running max / denominator /
//   accumulator, denominator clamped at 1e-30 so a row with no visible key
//   writes 0.  Each softmax row is reduced by one warp with shuffles.
// At gemma-2b's widths (8 rows, D = 256) a block needs 84,320 bytes of
// dynamic shared memory.  Not yet done: tensor-core products, cp.async /
// TMA double buffering of the KV tile, and split-KV across blocks (the
// grid is only B * KH blocks: 4 at the serve's decode shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // logical keys per shared-memory KV tile
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

__global__ void __launch_bounds__(kThreads)
    paged_flash_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       __nv_bfloat16* __restrict__ out,
                       const int* __restrict__ page_table,
                       const int* __restrict__ offset,
                       const int* __restrict__ kv_valid, int S, int H, int KH,
                       int D, int ps, int n_slot, int window, float softcap,
                       float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int rows = S * G;  // row r: query r / G, head kvh * G + r % G
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sk = D + 2;  // padded K-row stride (bf16): conflict-free reads
  const int nf = (2 * rows * D + rows * kTile + 3 * rows + 3) & ~3;

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // rows x D, scaled fp32 queries
  float* sAcc = sQ + rows * D;       // rows x D, fp32 output accumulator
  float* sP = sAcc + rows * D;       // rows x kTile, scores then probs
  float* sM = sP + rows * kTile;     // rows running max
  float* sL = sM + rows;             // rows running denominator
  float* sAlpha = sL + rows;         // rows rescale factor of this tile
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + nf);
  __nv_bfloat16* sK = sV + kTile * D;  // kTile x sk

  const int off = offset[b];
  const int kvl = min(kv_valid[b], n_slot * ps);
  const int* table = page_table + (size_t)b * n_slot;

  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int h = kvh * G + r % G;
    sQ[idx] = __bfloat162float(q[((size_t)(b * S + r / G) * H + h) * D + d]) *
              scale;
    sAcc[idx] = 0.0f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.0f;
  }

  // keys any query of this row can see: [lo, hi)
  const int hi = min(kvl, off + S);
  const int lo = window > 0 ? max(0, off - window + 1) : 0;
  const int chunks = D / 8;  // 16-byte chunks per key row
  const int half_d = D / 2;
  for (int t0 = (lo / kTile) * kTile; t0 < hi; t0 += kTile) {
    const int nj = min(kTile, hi - t0);  // keys of this tile below hi
    __syncthreads();  // previous tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < kTile * chunks; idx += kThreads) {
      const int j = idx / chunks, c = (idx % chunks) * 8;
      const int kpos = t0 + j;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (kpos >= lo && kpos < hi) {
        const size_t page = (size_t)table[kpos / ps];
        const size_t src = ((page * ps + kpos % ps) * KH + kvh) * D + c;
        kw = *reinterpret_cast<const uint4*>(k_pool + src);
        vw = *reinterpret_cast<const uint4*>(v_pool + src);
      }
      *reinterpret_cast<uint4*>(sV + j * D + c) = vw;
      uint32_t* kd = reinterpret_cast<uint32_t*>(sK + j * sk + c);
      kd[0] = kw.x;
      kd[1] = kw.y;
      kd[2] = kw.z;
      kd[3] = kw.w;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * kTile; idx += kThreads) {
      const int r = idx / kTile, j = idx % kTile;
      float s = kNegInf;
      if (j < nj && visible(t0 + j, off + r / G, kvl, window)) {
        const float* qr = sQ + r * D;
        const __nv_bfloat162* kj =
            reinterpret_cast<const __nv_bfloat162*>(sK + j * sk);
        s = 0.0f;
        for (int p = 0; p < half_d; ++p) {
          const float2 kf = __bfloat1622float2(kj[p]);
          s = fmaf(qr[2 * p], kf.x, s);
          s = fmaf(qr[2 * p + 1], kf.y, s);
        }
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      }
      sP[idx] = s;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = sP + r * kTile;
      const int qpos = off + r / G;
      const float m_prev = sM[r];
      float m_cur = m_prev;
      for (int j = lane; j < kTile; j += 32) m_cur = fmaxf(m_cur, pr[j]);
      m_cur = warp_max(m_cur);
      float sum = 0.0f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = (j < nj && visible(t0 + j, qpos, kvl, window))
                            ? expf(pr[j] - m_cur)
                            : 0.0f;
        pr[j] = p;
        sum += p;
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
    for (int idx = tid; idx < rows * half_d; idx += kThreads) {
      const int r = idx / half_d, dp = (idx % half_d) * 2;
      const float* pr = sP + r * kTile;
      float a0 = 0.0f, a1 = 0.0f;
      for (int j = 0; j < nj; ++j) {
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sV + j * D + dp));
        a0 = fmaf(pr[j], vf.x, a0);
        a1 = fmaf(pr[j], vf.y, a1);
      }
      float* acc = sAcc + r * D + dp;
      acc[0] = acc[0] * sAlpha[r] + a0;
      acc[1] = acc[1] * sAlpha[r] + a1;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int h = kvh * G + r % G;
    out[((size_t)(b * S + r / G) * H + h) * D + d] =
        __float2bfloat16(sAcc[idx] / fmaxf(sL[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// page_table is (B, n_slot) int32, offset and kv_valid are (B,) int32, all
// on the device.  window <= 0 means no window, softcap <= 0 no softcap.
// smem is the dynamic shared memory the wrapper computed for (S*H/KH, D).
int flash_attention_paged_bf16(const void* q, const void* k_pool,
                               const void* v_pool, void* out,
                               const void* page_table, const void* offset,
                               const void* kv_valid, int B, int S, int H,
                               int KH, int D, int ps, int n_slot, int window,
                               float softcap, float scale, int smem,
                               void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(KH, B);
  paged_flash_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(page_table),
      static_cast<const int*>(offset), static_cast<const int*>(kv_valid), S,
      H, KH, D, ps, n_slot, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
