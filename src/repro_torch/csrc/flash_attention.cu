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
// What bounds it on an H100: on the serving path it reads each row's valid
// K/V once (decode: S = 1 query per head, 2*D FLOPs per key and head
// against 4*D bytes of K and V read; a prefill chunk: S <= 16), so it is
// bound by the bytes of the KV cache, not by arithmetic.
//
// What the design does about it: one block per (q tile, head, batch row)
// and a loop over KV tiles inside the block in place of the TPU's KV grid
// axis.  The loop covers only the tiles that hold a visible key for some
// query of the tile (from the window's first key to min(kv_valid, last
// query position + 1)), so a decode row reads its valid prefix, not the
// whole max_len cache; skipping a tile in which every score is masked is
// exact, because such a tile leaves m, l and the accumulator unchanged.
// The scratch state lives in shared memory (q pre-scaled in fp32, the
// accumulator, one score tile, m, l and the rescale factor), the K tile is
// row-padded so the score loop reads it without bank conflicts, and the
// arithmetic is fp32 FMA with the TPU kernel's numerics: q upcast to fp32
// and then scaled by D**-0.5, optional tanh softcap, masked scores set to
// -2.3819763e38, masked probabilities zeroed, and the denominator clamped
// at 1e-30 so a fully masked row writes 0.  At D = 256 and a (64, 64) tile
// the block needs 214,272 bytes of dynamic shared memory (the entry point
// raises the 48 KB default).  Not yet done: tensor-core products, K/V
// shared across the heads of one KV group, split-KV for long caches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ bool visible(int kpos, int qpos, int kv_valid,
                                        int window) {
  return kpos <= qpos && kpos < kv_valid &&
         (window <= 0 || kpos > qpos - window);
}

__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           const int* __restrict__ offset,
                           const int* __restrict__ kv_valid, int S, int H,
                           int T, int KH, int D, int bq, int bkv, int window,
                           float softcap, float scale) {
  const int q0 = blockIdx.x * bq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ss = bkv + 1;    // padded score-row stride
  const int sk = D + 2;      // padded K-row stride (bf16 elements)

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // bq x D, scaled fp32 queries
  float* sAcc = sQ + bq * D;         // bq x D, fp32 output accumulator
  float* sS = sAcc + bq * D;         // bq x ss, scores then probabilities
  float* sM = sS + bq * ss;          // bq running max
  float* sL = sM + bq;               // bq running denominator
  float* sAlpha = sL + bq;           // bq rescale factor of this tile
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(sAlpha + bq);
  __nv_bfloat16* sV = sK + bkv * sk;  // bkv x D

  const int off = offset[b];
  const int kvl = min(kv_valid[b], T);
  const int rows = min(bq, S - q0);  // real query rows of this tile

  for (int idx = tid; idx < bq * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    sQ[idx] = i < rows
                  ? __bfloat162float(q[((size_t)(b * S + q0 + i) * H + h) * D + d]) * scale
                  : 0.0f;
    sAcc[idx] = 0.0f;
  }
  for (int i = tid; i < bq; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.0f;
  }

  // keys any real query of this tile can see: [lo, hi)
  const int qlo = off + q0, qhi = off + q0 + rows - 1;
  const int hi = min(kvl, qhi + 1);
  const int lo = window > 0 ? max(0, qlo - window + 1) : 0;
  const int half_d = D / 2;
  for (int t0 = (lo / bkv) * bkv; t0 < hi; t0 += bkv) {
    __syncthreads();   // previous tile's readers are done with sK/sV/sS
    for (int idx = tid; idx < bkv * half_d; idx += kThreads) {
      const int j = idx / half_d, dp = (idx % half_d) * 2;
      const int kpos = t0 + j;
      uint32_t kw = 0, vw = 0;
      if (kpos < T) {
        const size_t src = ((size_t)(b * T + kpos) * KH + kvh) * D + dp;
        kw = *reinterpret_cast<const uint32_t*>(k + src);
        vw = *reinterpret_cast<const uint32_t*>(v + src);
      }
      *reinterpret_cast<uint32_t*>(sK + j * sk + dp) = kw;
      *reinterpret_cast<uint32_t*>(sV + j * D + dp) = vw;
    }
    __syncthreads();
    for (int idx = tid; idx < bq * bkv; idx += kThreads) {
      const int i = idx / bkv, j = idx % bkv;
      const float* qi = sQ + i * D;
      const __nv_bfloat162* kj =
          reinterpret_cast<const __nv_bfloat162*>(sK + j * sk);
      float s = 0.0f;
      for (int p = 0; p < half_d; ++p) {
        const float2 kf = __bfloat1622float2(kj[p]);
        s = fmaf(qi[2 * p], kf.x, s);
        s = fmaf(qi[2 * p + 1], kf.y, s);
      }
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      sS[i * ss + j] = visible(t0 + j, off + q0 + i, kvl, window) ? s : kNegInf;
    }
    __syncthreads();
    for (int i = tid; i < bq; i += kThreads) {
      float* si = sS + i * ss;
      const float m_prev = sM[i];
      float m_cur = m_prev;
      for (int j = 0; j < bkv; ++j) m_cur = fmaxf(m_cur, si[j]);
      float sum = 0.0f;
      for (int j = 0; j < bkv; ++j) {
        const float p = visible(t0 + j, off + q0 + i, kvl, window)
                            ? expf(si[j] - m_cur)
                            : 0.0f;
        si[j] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_cur);
      sL[i] = sL[i] * alpha + sum;
      sM[i] = m_cur;
      sAlpha[i] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < bq * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      const float* pi = sS + i * ss;
      float a = 0.0f;
      for (int j = 0; j < bkv; ++j)
        a = fmaf(pi[j], __bfloat162float(sV[j * D + d]), a);
      sAcc[idx] = sAcc[idx] * sAlpha[i] + a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int i = idx / D, d = idx % D;
    out[((size_t)(b * S + q0 + i) * H + h) * D + d] =
        __float2bfloat16(sAcc[idx] / fmaxf(sL[i], 1e-30f));
  }
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// offset and kv_valid are (B,) int32 on the device.  window <= 0 means no
// window, softcap <= 0 no softcap.  smem is the dynamic shared memory the
// wrapper computed for (bq, bkv, D).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, const void* offset, const void* kv_valid,
                         int B, int S, int H, int T, int KH, int D, int bq,
                         int bkv, int window, float softcap, float scale,
                         int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + bq - 1) / bq, H, B);
  flash_attention_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(offset),
      static_cast<const int*>(kv_valid), S, H, T, KH, D, bq, bkv, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
