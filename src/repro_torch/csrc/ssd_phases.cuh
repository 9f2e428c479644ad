// Per-phase clock stamps of the SSD scan kernel (ssd_scan.cu), compiled in
// only when SSD_PHASE_CLOCKS is defined: kernels/cuda_build.py builds that
// variant as libssd_scan_phases.so and `phase_clocks` in
// kernels/ssd_scan.py reads it.  Each marker syncs the block, then thread 0
// adds the SM cycles since the previous marker to that phase's total (a
// phase met once per chunk sums over the chunks).  At the end thread 0
// writes, per block, kPhases + 3 int64: the phase totals in cycles, the
// block's cycles from first to last marker, and its start and end on the
// global nanosecond timer (which gives the cycles' clock rate).  In the
// normal build every macro is empty and the entry point is ssd_scan_bf16.
#pragma once

enum {
  kPhaseStateLoad,  // initial state into shared memory
  kPhaseStaging,    // a chunk's B, C, x and dt into shared memory
  kPhaseCumsum,     // the cumsum of dt*a and the state-update weights
  kPhaseIntra,      // C.B^T, the causal decay, and its product with x
  kPhaseInter,      // C.h, and y written out
  kPhaseUpdate,     // h' = exp(total) h + x^T (w o B)
  kPhaseStore,      // final state written out
  kPhases
};

#ifdef SSD_PHASE_CLOCKS

__device__ __forceinline__ long long ssd_globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define SSD_ENTRY ssd_scan_phases_bf16
#define SSD_PHASE_PARAM , long long* __restrict__ phase_clocks
#define SSD_PHASE_ARG , phase_clocks
#define SSD_PHASE_BEGIN()                          \
  long long ph_sum_[kPhases] = {};                 \
  const long long ph_g0_ = ssd_globaltimer();      \
  long long ph_t_ = clock64();                     \
  const long long ph_c0_ = ph_t_
#define SSD_PHASE(i)                  \
  do {                                \
    __syncthreads();                  \
    if (threadIdx.x == 0) {           \
      const long long t_ = clock64(); \
      ph_sum_[i] += t_ - ph_t_;       \
      ph_t_ = t_;                     \
    }                                 \
  } while (0)
#define SSD_PHASE_END(blk)                                              \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      long long* o_ = phase_clocks + (size_t)(blk) * (kPhases + 3);     \
      for (int i_ = 0; i_ < kPhases; ++i_) o_[i_] = ph_sum_[i_];        \
      o_[kPhases] = ph_t_ - ph_c0_;                                     \
      o_[kPhases + 1] = ph_g0_;                                         \
      o_[kPhases + 2] = ssd_globaltimer();                              \
    }                                                                   \
  } while (0)

#else

#define SSD_ENTRY ssd_scan_bf16
#define SSD_PHASE_PARAM
#define SSD_PHASE_ARG
#define SSD_PHASE_BEGIN() \
  do {                    \
  } while (0)
#define SSD_PHASE(i) \
  do {               \
  } while (0)
#define SSD_PHASE_END(blk) \
  do {                     \
  } while (0)

#endif
