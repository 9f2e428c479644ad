// ssd_scan: the Mamba-2 chunked SSD scan,
// x (B,L,H,P) bf16, dt (B,L,H) fp32, a (H,) fp32, b/c (B,L,G,N) bf16 with G
// dividing H (head h reads group h / (H/G)), h0 (B,H,P,N) fp32 or null
// -> y (B,L,H,P) bf16, final state (B,H,P,N) fp32.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan`
// (src/repro/kernels/ssd_scan.py:23,68).  The TPU version walks a
// sequential (B, H, L/Q) grid with the chunk axis innermost and carries the
// (P, N) fp32 state in VMEM scratch from one chunk step to the next.  Per
// chunk, with seg the inclusive cumsum of dt*a and total = seg[last]:
//   y_i  = sum_{j<=i} (C_i.B_j) exp(seg_i - seg_j) dt_j x_j + exp(seg_i) C_i.h
//   h'   = exp(total) h + sum_j x_j (exp(total - seg_j) dt_j B_j)^T
//
// What bounds it on an H100: on the serving path (prefill chunks of at
// most 16 tokens, one chunk per call) it reads and writes the 48 x 64 x 128
// fp32 state of every head, ~3.1 MB at B = 1, so it is bound by bytes and,
// at that size, by the latency of one launch's loads; a monolithic prefill
// of hundreds of tokens runs ~3 GFLOP of causal products (C.B^T over every
// head) against ~12 MB of x, y, B and C.
//
// What the design does about it:
// - P is split across blocks: one block per (16 columns of P, head, batch
//   row), 4 x 48 = 192 blocks at B = 1 instead of 48.  y's columns and the
//   state's rows are independent in P, so the split is exact; each block
//   recomputes the chunk's cumsum and C.B^T (on tensor cores, cheap).  The
//   blocks of one head are neighbours, so B and C come from L2 after the
//   first.
// - B and C are read once per group (b/c (B, L, G, N)); the model no longer
//   expands them to heads.
// - All four products run on mma.sync m16n8k16 with fp32 accumulators:
//   C.B^T (bf16 operands, exact); the decayed scores times x, C.h and the
//   state update x^T (w o B), whose fp32 operand (the scores, h, x*w) is
//   split into bf16 hi + lo and both products summed, so it keeps ~2^-17
//   relative precision.  The scores never leave registers: an m16n8 sum
//   fragment is the m16k16 operand fragment of the next product.  The
//   decay exp(seg_i - seg_j) is computed only for j <= i and the score is
//   selected to 0 above the diagonal (where the exponent can overflow and
//   inf * 0 would be NaN), never multiplied by a mask.
// - A chunk's B, C and x are staged by 16-byte cp.async copies into rows
//   padded by 16 bytes (ldmatrix without bank conflicts); the state slice
//   is loaded and stored with 16-byte copies and stays in shared memory
//   (fp32, plus its bf16 hi / lo split for C.h) across the chunks.
// - Row tiles of the intra-chunk product go to the 8 warps in a snake
//   order (warp w takes tiles w and 15 - w at Q = 256), which evens out
//   the causal triangle.
// The cumsum of dt*a is a warp-level prefix sum in fp32 (another order of
// summation than jnp.cumsum).  The ragged last chunk is masked, not
// padded: rows past L of B, C and x land as zeros and their dt as 0, so
// the real rows of y and the final state equal the TPU wrapper's dt = 0
// padding.  Shared memory depends on (Q, N): 205,056 bytes at Q = 256,
// N = 128 (`ssd_scan_smem_bytes`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tiles.cuh"
#include "ssd_phases.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPW = 16;  // columns of P a block takes
constexpr int kMaxSmem = 227 * 1024;

// what the host found aligned for 16-byte copies
constexpr int kVecBC = 1, kVecX = 2, kVecH = 4;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout in bytes for chunk length Q and state dim N (rows
// padded: bf16 by 8 elements, fp32 by 4; every region 16-byte aligned).
struct Layout {
  int QP, NP, SB, SQW, SH;  // padded sizes and row strides (elements)
  int B, C, X, XWH, XWL, HH, HL, H, Y, SEG, DT, W, BYTES;
  __host__ __device__ Layout(int Q, int N) {
    QP = round_up(Q, 16);
    NP = round_up(N, 32);
    SB = NP + 8;   // bf16 rows of B, C, h hi / lo
    SQW = QP + 8;  // bf16 rows of (x*w)^T hi / lo
    SH = NP + 4;   // fp32 state rows
    B = 0;
    C = B + QP * SB * 2;
    X = C + QP * SB * 2;  // QP x 24 bf16
    XWH = X + QP * 24 * 2;
    XWL = XWH + kPW * SQW * 2;
    HH = XWL + kPW * SQW * 2;
    HL = HH + kPW * SB * 2;
    H = HL + kPW * SB * 2;
    Y = H + kPW * SH * 4;  // QP x 16 fp32: exp(seg_i) C_i.h
    SEG = Y + QP * kPW * 4;
    DT = SEG + QP * 4;
    W = DT + QP * 4;
    BYTES = W + QP * 4;
  }
};
constexpr int kSX = 24;  // bf16 row stride of the x slice

// two bf16 as one operand register, `first` in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 first,
                                         __nv_bfloat16 second) {
  const __nv_bfloat162 v = __halves2bfloat162(first, second);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v = hi + lo in bf16, lo the rounding error of hi
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// acc[nb] (16 x 8, nb = 0, 1) += A . R^T over k in [0, K): A is 16 rows of
// stride sa from `a`, R the 16 rows of stride sr from `r` (rows nb*8 ..
// nb*8 + 7 give the columns of acc[nb]); K a multiple of 32.
__device__ __forceinline__ void rows_dot(const __nv_bfloat16* a, int sa,
                                         const __nv_bfloat16* r, int sr,
                                         int K, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* pa = a + (lane & 15) * sa + (lane >> 4) * 8;
  const __nv_bfloat16* pr0 = r + (lane & 7) * sr + (lane >> 3) * 8;
  const __nv_bfloat16* pr1 = pr0 + 8 * sr;
  for (int kk = 0; kk < K; kk += 32) {
    uint32_t a0[4], a1[4], b0[4], b1[4];
    sm90::ldmatrix_x4(a0, pa + kk);
    sm90::ldmatrix_x4(a1, pa + kk + 16);
    sm90::ldmatrix_x4(b0, pr0 + kk);
    sm90::ldmatrix_x4(b1, pr1 + kk);
    sm90::mma_bf16_16816(acc[0], a0, b0[0], b0[1]);
    sm90::mma_bf16_16816(acc[0], a1, b0[2], b0[3]);
    sm90::mma_bf16_16816(acc[1], a0, b1[0], b1[1]);
    sm90::mma_bf16_16816(acc[1], a1, b1[2], b1[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ bmat,
                    const __nv_bfloat16* __restrict__ cmat,
                    const float* __restrict__ h0,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ state_out, int L, int H, int G,
                    int P, int N, int Q, int psplit,
                    int vec SSD_PHASE_PARAM) {
  const int h = blockIdx.x / psplit;
  const int p0 = (blockIdx.x % psplit) * kPW;
  const int b = blockIdx.y;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const Layout lay(Q, N);
  const int NP = lay.NP, SB = lay.SB, SQW = lay.SQW, SH = lay.SH;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + lay.B);
  __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(smem + lay.C);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem + lay.X);
  __nv_bfloat16* sXWh = reinterpret_cast<__nv_bfloat16*>(smem + lay.XWH);
  __nv_bfloat16* sXWl = reinterpret_cast<__nv_bfloat16*>(smem + lay.XWL);
  __nv_bfloat16* sHh = reinterpret_cast<__nv_bfloat16*>(smem + lay.HH);
  __nv_bfloat16* sHl = reinterpret_cast<__nv_bfloat16*>(smem + lay.HL);
  float* sH = reinterpret_cast<float*>(smem + lay.H);
  float* sY = reinterpret_cast<float*>(smem + lay.Y);
  float* sSeg = reinterpret_cast<float*>(smem + lay.SEG);
  float* sDt = reinterpret_cast<float*>(smem + lay.DT);
  float* sW = reinterpret_cast<float*>(smem + lay.W);

  SSD_PHASE_BEGIN();
  const float av = a[h];
  const int prow = min(kPW, P - p0);  // real rows of the state slice
  const size_t hoff = (((size_t)b * H + h) * P + p0) * N;

  // the state slice (prow x N of fp32, contiguous) into sH, zero-padded
  if (h0 != nullptr && (vec & kVecH)) {
    for (int idx = tid; idx < kPW * (NP / 4); idx += kThreads) {
      const int p = idx / (NP / 4), n = (idx % (NP / 4)) * 4;
      const bool in = p < prow && n < N;
      sm90::cp_async16(sH + p * SH + n, in ? h0 + hoff + (size_t)p * N + n : h0,
                       in ? 16 : 0);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
  } else {
    for (int idx = tid; idx < kPW * NP; idx += kThreads) {
      const int p = idx / NP, n = idx % NP;
      sH[p * SH + n] = (h0 != nullptr && p < prow && n < N)
                           ? h0[hoff + (size_t)p * N + n]
                           : 0.0f;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kPW * NP; idx += kThreads) {
    const int p = idx / NP, n = idx % NP;
    split_bf16(sH[p * SH + n], sHh[p * SB + n], sHl[p * SB + n]);
  }
  SSD_PHASE(kPhaseStateLoad);

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);
    const int RP = round_up(rows, 16);  // rows the products cover
    __syncthreads();  // the previous chunk's readers are done

    // B and C rows of the group (zero past `rows` and past N)
    if (vec & kVecBC) {
      for (int idx = tid; idx < RP * (NP / 8); idx += kThreads) {
        const int j = idx / (NP / 8), n = (idx % (NP / 8)) * 8;
        const bool in = j < rows && n < N;
        const size_t src = in ? (((size_t)b * L + c0 + j) * G + grp) * N + n
                              : 0;
        sm90::cp_async16(sB + j * SB + n, bmat + src, in ? 16 : 0);
        sm90::cp_async16(sC + j * SB + n, cmat + src, in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < RP * NP; idx += kThreads) {
        const int j = idx / NP, n = idx % NP;
        const bool in = j < rows && n < N;
        const size_t src = (((size_t)b * L + c0 + j) * G + grp) * N + n;
        sB[j * SB + n] = in ? bmat[src] : __float2bfloat16(0.0f);
        sC[j * SB + n] = in ? cmat[src] : __float2bfloat16(0.0f);
      }
    }
    // the x slice: rows x 16 columns of P
    if (vec & kVecX) {
      for (int idx = tid; idx < RP * 2; idx += kThreads) {
        const int j = idx / 2, p = (idx % 2) * 8;
        const bool in = j < rows && p < prow;
        const size_t src =
            in ? (((size_t)b * L + c0 + j) * H + h) * P + p0 + p : 0;
        sm90::cp_async16(sX + j * kSX + p, x + src, in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < RP * kPW; idx += kThreads) {
        const int j = idx / kPW, p = idx % kPW;
        const bool in = j < rows && p < prow;
        sX[j * kSX + p] =
            in ? x[(((size_t)b * L + c0 + j) * H + h) * P + p0 + p]
               : __float2bfloat16(0.0f);
      }
    }
    sm90::cp_async_commit();
    for (int j = tid; j < RP; j += kThreads)
      sDt[j] = j < rows ? dt[((size_t)b * L + c0 + j) * H + h] : 0.0f;
    sm90::cp_async_wait<0>();
    __syncthreads();
    SSD_PHASE(kPhaseStaging);

    // inclusive cumsum of dt*a: each lane of warp 0 sums a contiguous
    // segment, then adds the exclusive prefix of the lanes' segment sums
    if (tid < 32) {
      const int per = (rows + 31) / 32;
      const int lo = min(rows, tid * per), hi = min(rows, lo + per);
      float run = 0.0f;
      for (int j = lo; j < hi; ++j) {
        run += sDt[j] * av;
        sSeg[j] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float excl = incl - run;
      for (int j = lo; j < hi; ++j) sSeg[j] += excl;
      for (int j = rows + tid; j < RP; j += 32) sSeg[j] = 0.0f;
    }
    __syncthreads();
    const float total = sSeg[rows - 1];
    for (int j = tid; j < RP; j += kThreads)
      sW[j] = j < rows ? expf(total - sSeg[j]) * sDt[j] : 0.0f;
    __syncthreads();
    // (x * w)^T split into bf16 hi + lo: the state update's A operand
    for (int idx = tid; idx < kPW * RP; idx += kThreads) {
      const int p = idx / RP, j = idx % RP;
      split_bf16(__bfloat162float(sX[j * kSX + p]) * sW[j],
                 sXWh[p * SQW + j], sXWl[p * SQW + j]);
    }
    SSD_PHASE(kPhaseCumsum);

    // row tiles of 16 go to the warps in a snake order
    const int nt = RP / 16;
    // inter-chunk term: sY = exp(seg_i) * C_i . h_in (h as hi + lo)
    for (int r = 0; r * kWarps < nt; ++r) {
      const int ti = r * kWarps + ((r & 1) ? kWarps - 1 - warp : warp);
      if (ti >= nt) continue;
      float d[2][4] = {};
      rows_dot(sC + ti * 16 * SB, SB, sHh, SB, NP, d);
      rows_dot(sC + ti * 16 * SB, SB, sHl, SB, NP, d);
      const float es_a = expf(sSeg[ti * 16 + g]);
      const float es_b = expf(sSeg[ti * 16 + g + 8]);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float* ya = sY + (ti * 16 + g) * kPW + nb * 8 + 2 * c;
        *reinterpret_cast<float2*>(ya) =
            make_float2(es_a * d[nb][0], es_a * d[nb][1]);
        *reinterpret_cast<float2*>(ya + 8 * kPW) =
            make_float2(es_b * d[nb][2], es_b * d[nb][3]);
      }
    }
    SSD_PHASE(kPhaseInter);

    // intra-chunk term, 16 query rows x 16 key rows at a time up to the
    // diagonal: S = C_i . B_j^T, then M = S exp(seg_i - seg_j) dt_j on
    // j <= i (0 elsewhere), then y += M . x_j with M as bf16 hi + lo
    for (int r = 0; r * kWarps < nt; ++r) {
      const int ti = r * kWarps + ((r & 1) ? kWarps - 1 - warp : warp);
      if (ti >= nt) continue;
      const int ia = ti * 16 + g, ib = ia + 8;
      const float seg_a = sSeg[ia], seg_b = sSeg[ib];
      float acc[2][4] = {};
      for (int tj = 0; tj <= ti; ++tj) {
        float s[2][4] = {};
        rows_dot(sC + ti * 16 * SB, SB, sB + tj * 16 * SB, SB, NP, s);
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = tj * 16 + nb * 8 + 2 * c + (e & 1);
            v[e] = (j <= i && i < rows)
                       ? s[nb][e] * expf((e < 2 ? seg_a : seg_b) - sSeg[j]) *
                             sDt[j]
                       : 0.0f;
          }
          // the m16n8 sum fragment is half of the m16k16 operand fragment
          __nv_bfloat16 hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_bf16(v[e], hi[e], lo[e]);
          // operand registers: a0 = row g / keys 0-7, a1 = row g+8 /
          // keys 0-7, a2 = row g / keys 8-15, a3 = row g+8 / keys 8-15
          mh[2 * nb] = pack2(hi[0], hi[1]);
          mh[2 * nb + 1] = pack2(hi[2], hi[3]);
          ml[2 * nb] = pack2(lo[0], lo[1]);
          ml[2 * nb + 1] = pack2(lo[2], lo[3]);
        }
        uint32_t bx[4];
        sm90::ldmatrix_x4_trans(
            bx, sX + (tj * 16 + (lane & 15)) * kSX + (lane >> 4) * 8);
        sm90::mma_bf16_16816(acc[0], mh, bx[0], bx[1]);
        sm90::mma_bf16_16816(acc[0], ml, bx[0], bx[1]);
        sm90::mma_bf16_16816(acc[1], mh, bx[2], bx[3]);
        sm90::mma_bf16_16816(acc[1], ml, bx[2], bx[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib;
          const int col = nb * 8 + 2 * c + (e & 1);
          if (i < rows && col < prow)
            y[(((size_t)b * L + c0 + i) * H + h) * P + p0 + col] =
                __float2bfloat16(acc[nb][e] + sY[i * kPW + col]);
        }
    }
    SSD_PHASE(kPhaseIntra);

    // state update, 16 state columns a warp at a time:
    // h' = exp(total) h + (x*w)^T . B with (x*w) as bf16 hi + lo
    __syncthreads();  // every reader of h_in's hi / lo is done
    const float decay = expf(total);
    for (int pr = warp; pr < NP / 16; pr += kWarps) {
      float acc[2][4] = {};
      for (int ks = 0; ks < RP; ks += 16) {
        uint32_t wh[4], wl[4], bb[4];
        const int ao = (lane & 15) * SQW + ks + (lane >> 4) * 8;
        sm90::ldmatrix_x4(wh, sXWh + ao);
        sm90::ldmatrix_x4(wl, sXWl + ao);
        sm90::ldmatrix_x4_trans(
            bb, sB + (ks + (lane & 15)) * SB + pr * 16 + (lane >> 4) * 8);
        sm90::mma_bf16_16816(acc[0], wh, bb[0], bb[1]);
        sm90::mma_bf16_16816(acc[0], wl, bb[0], bb[1]);
        sm90::mma_bf16_16816(acc[1], wh, bb[2], bb[3]);
        sm90::mma_bf16_16816(acc[1], wl, bb[2], bb[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = e < 2 ? g : g + 8;
          const int n = pr * 16 + nb * 8 + 2 * c + (e & 1);
          float* hp = sH + p * SH + n;
          *hp = decay * *hp + acc[nb][e];
          split_bf16(*hp, sHh[p * SB + n], sHl[p * SB + n]);
        }
    }
    SSD_PHASE(kPhaseUpdate);
  }
  __syncthreads();
  if (vec & kVecH) {
    for (int idx = tid; idx < prow * (N / 4); idx += kThreads) {
      const int p = idx / (N / 4), n = (idx % (N / 4)) * 4;
      *reinterpret_cast<float4*>(state_out + hoff + (size_t)p * N + n) =
          *reinterpret_cast<const float4*>(sH + p * SH + n);
    }
  } else {
    for (int idx = tid; idx < prow * N; idx += kThreads)
      state_out[hoff + idx] = sH[(idx / N) * SH + idx % N];
  }
  SSD_PHASE(kPhaseStore);
  SSD_PHASE_END(blockIdx.y * gridDim.x + blockIdx.x);
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block at chunk length Q and state dim N
// (`smem_bytes` in kernels/ssd_scan.py), or -1 for Q or N below 1.
int ssd_scan_smem_bytes(int Q, int N) {
  if (Q < 1 || N < 1) return -1;
  return Layout(Q, N).BYTES;
}

// h0 may be null (a zero initial state).  Q is the chunk length
// (min(chunk_size, L)); G divides H.  One block per (16 columns of P,
// head, batch row).  Returns cudaErrorInvalidValue for shapes the kernel
// does not take or a block beyond the card's shared memory.  The phase
// build's entry point takes the stamps' buffer last (ssd_phases.cuh).
int SSD_ENTRY(const void* x, const void* dt, const void* a, const void* b,
              const void* c, const void* h0, void* y, void* state, int B,
              int L, int H, int G, int P, int N, int Q,
              void* stream SSD_PHASE_PARAM) {
  if (B < 1 || L < 1 || H < 1 || G < 1 || H % G || P < 1 || N < 1 ||
      Q < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = Layout(Q, N).BYTES;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (N % 8 == 0 && aligned(b) && aligned(c) ? kVecBC : 0) |
                  (P % 8 == 0 && aligned(x) ? kVecX : 0) |
                  (N % 4 == 0 && (h0 == nullptr || aligned(h0)) &&
                           aligned(state)
                       ? kVecH
                       : 0);
  const int psplit = (P + kPW - 1) / kPW;
  dim3 grid(H * psplit, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), L, H, G, P,
      N, Q, psplit, vec SSD_PHASE_ARG);
  return (int)cudaGetLastError();
}

}  // extern "C"
