// ssd_scan: the Mamba-2 chunked SSD scan,
// x (B,L,H,P) bf16, dt (B,L,H) fp32, a (H,) fp32, b/c (B,L,H,N) bf16,
// h0 (B,H,P,N) fp32 or null -> y (B,L,H,P) bf16, final state (B,H,P,N) fp32.
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
// fp32 state of every head, ~3.1 MB at B = 1, so it is bound by bytes; a
// monolithic prefill of hundreds of tokens is still bound by the bytes of
// x, y, B and C (~22 MB at L = 600) against ~2 GFLOP of causal products.
//
// What the design does about it: Hopper blocks run in no order, so one
// block per (head, batch row) loops over the chunks itself and keeps the
// state in shared memory across them (a (P, N + 1) fp32 array, padded so
// the threads of a warp read distinct banks).  Each chunk's B, C (bf16,
// rows padded to an odd word stride) and x (bf16) are staged in shared
// memory once; at Q = 256 the (Q, Q) score matrix would not fit beside
// them, so the intra-chunk product runs by 64 x 64 sub-tiles: for each
// tile of 64 query rows, key tiles up to the diagonal build a score tile
// in shared memory (each thread a strided 4 x 4 micro-tile in registers)
// and fold it into the query rows' 4 x 4 register accumulators of y.  The
// decay exp(seg_i - seg_j) is computed only for j <= i: above the
// diagonal it can overflow, and the score is selected to 0 there, not
// multiplied by a mask.  The cumsum of dt*a is a warp-level prefix sum in
// fp32 (another order of summation than jnp.cumsum).  The ragged last
// chunk is masked, not padded: its real rows of y and the final state
// equal the TPU wrapper's dt = 0 padding.  At Q = 256, P = 64, N = 128 a
// block needs 218,624 bytes of dynamic shared memory.  Not yet done:
// tensor-core products, reading B and C once per group instead of per
// head, splitting P across blocks for more than B x H blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kTile = 64;       // query rows and key rows of one sub-tile
constexpr int kMaxP = 64;       // head_dim held in 4 x 16 register columns

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ bmat,
                    const __nv_bfloat16* __restrict__ cmat,
                    const float* __restrict__ h0,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ state_out, int L, int H, int P,
                    int N, int Q) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int sbc = (N | 1) + 1;   // B/C row stride (bf16): even, >= N + 1
  const int sh = N + 1;          // state row stride (fp32)
  const int ss = kTile + 1;      // score row stride (fp32)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sH = reinterpret_cast<float*>(smem_raw);     // P x sh state
  float* sSeg = sH + P * sh;                          // Q cumsum of dt*a
  float* sDt = sSeg + Q;                              // Q dt
  float* sW = sDt + Q;                                // Q exp(total-seg)*dt
  float* sS = sW + Q;                                 // kTile x ss scores
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(sS + kTile * ss);
  __nv_bfloat16* sC = sB + Q * sbc;                   // Q x sbc
  __nv_bfloat16* sX = sC + Q * sbc;                   // Q x P

  const float av = a[h];
  const size_t hoff = ((size_t)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads)
    sH[(idx / N) * sh + idx % N] = h0 != nullptr ? h0[hoff + idx] : 0.0f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const int rows = min(Q, L - c0);
    __syncthreads();   // the previous chunk's readers are done
    for (int idx = tid; idx < rows * N; idx += kThreads) {
      const int j = idx / N, n = idx % N;
      const size_t src = (((size_t)b * L + c0 + j) * H + h) * N + n;
      sB[j * sbc + n] = bmat[src];
      sC[j * sbc + n] = cmat[src];
    }
    for (int idx = tid; idx < rows * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      sX[j * P + p] = x[(((size_t)b * L + c0 + j) * H + h) * P + p];
    }
    for (int j = tid; j < rows; j += kThreads)
      sDt[j] = dt[((size_t)b * L + c0 + j) * H + h];
    __syncthreads();

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
    }
    __syncthreads();
    const float total = sSeg[rows - 1];
    for (int j = tid; j < rows; j += kThreads)
      sW[j] = expf(total - sSeg[j]) * sDt[j];

    // y of this chunk, by tiles of kTile query rows; thread (tx, ty) owns
    // rows i0 + ty + 16r and columns p = tx + 16c
    for (int i0 = 0; i0 < rows; i0 += kTile) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      int ir[4], pc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ir[r] = min(i0 + ty + 16 * r, rows - 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) pc[c] = min(tx + 16 * c, P - 1);

      const int jend = min(rows, i0 + kTile);   // keys up to the diagonal
      for (int j0 = 0; j0 < jend; j0 += kTile) {
        int jc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) jc[c] = min(j0 + tx + 16 * c, rows - 1);
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = bf(sC[ir[r] * sbc + n]);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bf(sB[jc[c] * sbc + n]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
        }
        __syncthreads();   // the previous score tile's readers are done
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float v = 0.0f;
            if (j <= i && i < rows)
              v = s[r][c] * expf(sSeg[i] - sSeg[j]) * sDt[j];
            sS[(ty + 16 * r) * ss + tx + 16 * c] = v;
          }
        }
        __syncthreads();
        const int jn = min(kTile, jend - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float xv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = bf(sX[(j0 + jj) * P + pc[c]]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float sv = sS[(ty + 16 * r) * ss + jj];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(sv, xv[c], acc[r][c]);
          }
        }
      }

      // inter-chunk term: exp(seg_i) * C_i . h_in
      float d[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) d[r][c] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = bf(sC[ir[r] * sbc + n]);
#pragma unroll
        for (int c = 0; c < 4; ++c) hv[c] = sH[pc[c] * sh + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[r][c] = fmaf(cv[r], hv[c], d[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= rows) continue;
        const float es = expf(sSeg[i]);
        __nv_bfloat16* yrow = y + (((size_t)b * L + c0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yrow[p] = __float2bfloat16(acc[r][c] + es * d[r][c]);
        }
      }
    }

    // state update; each thread owns whole (p, n) entries
    __syncthreads();   // every reader of the incoming state is done
    const float decay = expf(total);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float acc = 0.0f;
      for (int j = 0; j < rows; ++j)
        acc = fmaf(bf(sX[j * P + p]), bf(sB[j * sbc + n]) * sW[j], acc);
      float* hp = sH + p * sh + n;
      *hp = decay * *hp + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads)
    state_out[hoff + idx] = sH[(idx / N) * sh + idx % N];
}

}  // namespace

extern "C" {

const char* cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// h0 may be null (a zero initial state).  Q is the chunk length
// (min(chunk_size, L)); smem is the dynamic shared memory the wrapper
// computed for (Q, P, N).  P must be at most kMaxP.
int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                  const void* b, const void* c, const void* h0, void* y,
                  void* state, int B, int L, int H, int P, int N, int Q,
                  int smem, void* stream) {
  if (P > kMaxP || P < 1 || N < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), L, H, P, N,
      Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
