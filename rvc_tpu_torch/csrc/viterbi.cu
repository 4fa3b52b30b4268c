// CREPE's Viterbi decode on Hopper: kernel V `viterbi`.
//
// Replaces no Pallas kernel: the JAX package decodes CREPE's salience in
// numpy on the host (rvc_tpu/predictors/crepe.py:71), and so did the port
// until V (predictors/crepe.py `_viterbi_path`, which stays as V's plain
// version on the CPU). V computes `_viterbi_path`'s function over a whole
// song in float64, from the masked salience [T, 360] f32 on the card to the
// path [T] int64:
//
//   obs[i]   = sal[i] / max(sum(sal[i]), 1e-12),  lo[i] = log(obs[i] + 1e-12)
//   dp[0]    = log(1 / 360) + lo[0]
//   a[i]     = dp[i] - log_rowsum
//   dp[i][j] = max_k (a[i-1][j - offs[k]] + logw[k]) + lo[i][j],  offs[k] = k - 11
//
// then the first argmax of dp[T-1] and the backtrack through each step's
// first maximising k. logw, log_rowsum and log(1 / 360) are the host's
// (ops/viterbi.py `band`, float64), passed in.
//
// Bits. The adds, subtractions and the division round to nearest on both
// sides, and nothing is contracted into an fma. The row sum is numpy's
// pairwise order for a contiguous row of 360 (halves of 176 and 184, leaves
// of 88, 88, 88 and 96, eight accumulators a leaf): a warp takes a row,
// lane 8 L + m runs leaf L's accumulator m in numpy's order, and xor
// shuffles 1, 2, 4 (the leaf's tree) then 8, 16 (the halves) join them as
// numpy does; a float add commutes, so every lane ends with numpy's sum.
// The log is CUDA's (within an ulp of the exact value), so lo may differ
// from numpy's by an ulp; no frame of the path has moved for it (PERF.md,
// kernel V). Candidates are compared in k order and the first maximum
// kept: the order in which the host's backtrack breaks ties.
//
// What bounds it on the card: latency. A step is 360 x 23 adds and compares
// of values the previous step wrote, and the next step needs all of them;
// the bytes (the salience once, lo written and read once, a back pointer
// byte a bin) are about 100 MB for a 240 s song, 0.03 ms of HBM. So:
//
// - `viterbi_obs`: the observations, parallel over frames (a warp a row),
//   lo [T, 360] f64 to device memory.
// - `viterbi_dp`: one block of 384 threads, a thread a destination bin,
//   runs the frames in order. The 360 values of a live in shared memory,
//   double-buffered and padded by 11 cells of -inf a side, so a step is one
//   barrier; logw sits in registers. Each thread copies its bin's lo
//   kRing - 1 frames ahead by cp.async into a shared ring, so a step does
//   not wait on device memory. A step writes its winning k, a byte a bin,
//   to device memory ([T, 360]; 8.6 MB for 240 s, which L2 holds).
// - The backtrack in the same block: kChunk frames of back pointers at a
//   time are copied into the ring's bytes by every thread, and one thread
//   follows the path through them.
// - `rvc_viterbi_floor` (for measurement, not V) runs `viterbi_dp` with
//   the step's copy, stores and barrier and without the band's loads, adds
//   and compares: the step's latency floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 360;
constexpr int kReach = 11;                // the band's half-width
constexpr int kBand = 2 * kReach + 1;     // offsets -11 .. 11
constexpr int kPadded = kBins + 2 * kReach;
constexpr int kDpThreads = 384;           // a thread a bin, 12 warps
constexpr int kRing = 8;                  // frames of lo a thread has in flight
constexpr int kChunk = kRing * 8;         // frames of back pointers in the ring's bytes
constexpr int kObsWarps = 8;              // rows a block of viterbi_obs

// ---- cp.async --------------------------------------------------------------

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ double neg_inf() { return -__longlong_as_double(0x7ff0000000000000LL); }

// ---- the kernels -----------------------------------------------------------

__global__ void __launch_bounds__(kObsWarps * 32)
    viterbi_obs(const float* __restrict__ sal, double* __restrict__ lo, int t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kObsWarps + (threadIdx.x >> 5);
  if (row >= t) return;
  const float* x = sal + static_cast<size_t>(row) * kBins;
  // numpy's pairwise sum: leaf L (88 values from 88 L; the last 96), its
  // accumulator m = lane % 8 adds every eighth value in order
  const int leaf = lane >> 3;
  const int first = 88 * leaf + (lane & 7), len = leaf == 3 ? 96 : 88;
  double r = static_cast<double>(x[first]);
  for (int q = 8; q < len; q += 8) r = __dadd_rn(r, static_cast<double>(x[first + q]));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) r = __dadd_rn(r, __shfl_xor_sync(0xffffffffu, r, d));
  const double sum = fmax(r, 1e-12);
  double* out = lo + static_cast<size_t>(row) * kBins;
  for (int c = lane; c < kBins; c += 32)
    out[c] = log(__dadd_rn(__ddiv_rn(static_cast<double>(x[c]), sum), 1e-12));
}

template <bool kFloor>
__global__ void __launch_bounds__(kDpThreads, 1)
    viterbi_dp(const double* __restrict__ lo, const double* __restrict__ band,
               uint8_t* back, int64_t* __restrict__ path, int t) {
  __shared__ double a[2][kPadded];
  __shared__ __align__(16) double ring[kRing][kBins];
  __shared__ double warp_best[kDpThreads / 32];
  __shared__ int warp_bin[kDpThreads / 32];
  const int j = threadIdx.x;
  const bool live = j < kBins;

  double logw[kBand];
#pragma unroll
  for (int k = 0; k < kBand; ++k) logw[k] = band[k];
  const double rowsum = live ? band[kBand + j] : 0.0;
  for (int c = j; c < 2 * kPadded; c += kDpThreads) (&a[0][0])[c] = neg_inf();
  for (int f = 1; f < kRing; ++f) {  // frames 1 .. kRing - 1 in flight
    if (live && f < t) cp_async8(&ring[f][j], lo + static_cast<size_t>(f) * kBins + j);
    cp_async_commit();
  }
  double dp = live ? __dadd_rn(band[kBand + kBins], lo[j]) : neg_inf();
  __syncthreads();  // the padding, before a's interior
  if (live) a[0][kReach + j] = __dsub_rn(dp, rowsum);
  __syncthreads();

  int cur = 0;
  for (int i = 1; i < t; ++i) {
    const int f = i + kRing - 1;
    if (live && f < t) cp_async8(&ring[f % kRing][j], lo + static_cast<size_t>(f) * kBins + j);
    cp_async_commit();
    cp_async_wait<kRing - 1>();  // frame i's copy (this thread's own) has landed
    if (live) {
      const double* src = &a[cur][j];  // src[2 kReach - k] = a[j - offs[k]]
      int best_k = kReach;  // the floor's path stays in its bin
      if (kFloor) {
        dp = ring[i % kRing][j];
      } else {
        double best = __dadd_rn(src[2 * kReach], logw[0]);
        best_k = 0;
#pragma unroll
        for (int k = 1; k < kBand; ++k) {
          const double c = __dadd_rn(src[2 * kReach - k], logw[k]);
          if (c > best) {
            best = c;
            best_k = k;
          }
        }
        dp = __dadd_rn(best, ring[i % kRing][j]);
      }
      a[cur ^ 1][kReach + j] = __dsub_rn(dp, rowsum);
      back[static_cast<size_t>(i) * kBins + j] = static_cast<uint8_t>(best_k);
    }
    cur ^= 1;
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy may land in the ring once it holds back pointers

  // the first maximum of dp: (value, bin) pairs, the lower bin on a tie
  double v = live ? dp : neg_inf();
  int bin = j;
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const double ov = __shfl_down_sync(0xffffffffu, v, d);
    const int ob = __shfl_down_sync(0xffffffffu, bin, d);
    if (ov > v || (ov == v && ob < bin)) {
      v = ov;
      bin = ob;
    }
  }
  if ((j & 31) == 0) {
    warp_best[j >> 5] = v;
    warp_bin[j >> 5] = bin;
  }
  __syncthreads();
  int at = 0;
  if (j == 0) {
    v = warp_best[0];
    at = warp_bin[0];
    for (int w = 1; w < kDpThreads / 32; ++w) {
      if (warp_best[w] > v) {
        v = warp_best[w];
        at = warp_bin[w];
      }
    }
    path[t - 1] = at;
  }

  // the backtrack: back[i][at] is the k that took frame i - 1's bin to at
  uint8_t* chunk = reinterpret_cast<uint8_t*>(&ring[0][0]);
  for (int hi = t; hi > 1; hi -= kChunk) {
    const int lo_i = max(1, hi - kChunk);
    // rows [lo_i, hi): contiguous, from a multiple of 8 bytes
    const uint2* g = reinterpret_cast<const uint2*>(back + static_cast<size_t>(lo_i) * kBins);
    uint2* s = reinterpret_cast<uint2*>(chunk);
    const int words = (hi - lo_i) * (kBins / 8);
    __syncthreads();  // the previous chunk is followed
    for (int w = j; w < words; w += kDpThreads) s[w] = g[w];
    __syncthreads();
    if (j == 0) {
      for (int i = hi - 1; i >= lo_i; --i) {
        at -= chunk[(i - lo_i) * kBins + at] - kReach;
        path[i - 1] = at;
      }
    }
  }
}

}  // namespace

extern "C" {

// The observations of a masked salience sal [t, 360] f32 -> lo [t, 360]
// f64, both contiguous on the card.
int rvc_viterbi_obs(const void* sal, void* lo, int t, void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  viterbi_obs<<<(t + kObsWarps - 1) / kObsWarps, kObsWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(sal),
                                                     static_cast<double*>(lo), t);
  return (int)cudaGetLastError();
}

// The path [t] int64 through lo [t, 360] f64; band holds logw [23],
// log_rowsum [360] and log(1 / 360), f64; back [t, 360] uint8 is scratch
// (row 0 unused).
int rvc_viterbi_dp(const void* lo, const void* band, void* back, void* path, int t,
                   void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  viterbi_dp<false><<<1, kDpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lo), static_cast<const double*>(band),
      static_cast<uint8_t*>(back), static_cast<int64_t*>(path), t);
  return (int)cudaGetLastError();
}

// rvc_viterbi_dp's step without the band: its latency floor. The path it
// writes stays in the last frame's best bin and is not V's.
int rvc_viterbi_floor(const void* lo, const void* band, void* back, void* path, int t,
                      void* stream) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  viterbi_dp<true><<<1, kDpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lo), static_cast<const double*>(band),
      static_cast<uint8_t*>(back), static_cast<int64_t*>(path), t);
  return (int)cudaGetLastError();
}

}  // extern "C"
