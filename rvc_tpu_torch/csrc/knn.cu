// Exact squared-L2 k-nearest-neighbour search on Hopper: kernel K3
// `knn_topk`.
//
// Replaces the TPU kernel rvc_tpu/ops/retrieval_pallas.py knn_search_pallas
// (_knn_kernel, pallas_call at :125): d2 = |q|^2 + |v|^2 - 2 q.v computed
// inside the kernel, a running top-k kept across index tiles, distances
// clamped to >= 0, ties resolved to the lower index as lax.top_k does.
//
// What bounds it on the card: operations. At the serving shape (799 queries,
// a 65536 x 768 f32 index) the cross products are 8.0e10 FLOP against a
// 201 MB index read, about 400 FLOP per byte, far above the f32 ridge.
//
// What the design does about it: pass 1 tiles the (query, index) plane.
// Each block owns 64 queries and one contiguous split of the index, streams
// that split through shared memory in 64-row tiles with a 32-wide depth
// chunk, and computes the 64 x 64 cross products as a register-tiled
// SGEMM on the CUDA cores (4 x 4 per thread), together with |v|^2 from the
// same shared tiles. The distances of a tile go to shared memory, and 64
// threads, one per query, fold them into a sorted top-k held in registers.
// Blocks run in no order, so each writes its split's top-k to scratch, and
// pass 2 merges the splits' candidates per query. The split count is chosen
// by the wrapper so that about two blocks per SM are in flight.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kQB = 64;      // queries per block
constexpr int kVB = 64;      // index rows per tile
constexpr int kDK = 32;      // depth chunk
constexpr int kThreads = 256;
constexpr int kMaxK = 8;

__device__ __forceinline__ bool before(float d, int64_t i, float bd,
                                       int64_t bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ void insert(float (&bd)[kMaxK],
                                       int64_t (&bi)[kMaxK], float d,
                                       int64_t i) {
  if (!before(d, i, bd[kMaxK - 1], bi[kMaxK - 1])) return;
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    if (before(d, i, bd[s], bi[s])) {
      const float td = bd[s];
      const int64_t ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_partial(const float* __restrict__ q, const float* __restrict__ v,
            float* __restrict__ part_d, int64_t* __restrict__ part_i,
            int n_q, int n_v, int dim, int split_rows) {
  __shared__ float qs[kDK][kQB + 1];
  __shared__ float vs[kDK][kVB + 1];
  __shared__ float dist[kQB][kVB + 1];
  __shared__ float q2s[kQB];
  __shared__ float v2s[kVB];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kQB;
  const int split = blockIdx.y;
  const int v_begin = split * split_rows;
  const int v_end = min(n_v, v_begin + split_rows);

  // |q|^2 of this block's queries
  if (tid < kQB) {
    float s = 0.f;
    if (q0 + tid < n_q) {
      const float* qr = q + (size_t)(q0 + tid) * dim;
      for (int d = 0; d < dim; ++d) s = fmaf(qr[d], qr[d], s);
    }
    q2s[tid] = s;
  }

  float bd[kMaxK];
  int64_t bi[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = INT64_MAX;
  }

  for (int vt = v_begin; vt < v_end; vt += kVB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float v2 = 0.f;

    for (int d0 = 0; d0 < dim; d0 += kDK) {
      for (int idx = tid; idx < kQB * kDK; idx += kThreads) {
        const int dd = idx % kDK, r = idx / kDK;
        const int d = d0 + dd;
        qs[dd][r] = (q0 + r < n_q && d < dim)
                        ? q[(size_t)(q0 + r) * dim + d] : 0.f;
        vs[dd][r] = (vt + r < v_end && d < dim)
                        ? v[(size_t)(vt + r) * dim + d] : 0.f;
      }
      __syncthreads();
      if (tid < kVB) {
#pragma unroll 8
        for (int dd = 0; dd < kDK; ++dd) v2 = fmaf(vs[dd][tid], vs[dd][tid], v2);
      }
#pragma unroll 8
      for (int dd = 0; dd < kDK; ++dd) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[dd][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = vs[dd][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dist[ty * 4 + i][tx * 4 + j] = acc[i][j];
    if (tid < kVB) v2s[tid] = v2;
    __syncthreads();
    if (tid < kQB && q0 + tid < n_q) {
      const int n_cols = min(kVB, v_end - vt);
      const float qq = q2s[tid];
      for (int j = 0; j < n_cols; ++j) {
        const float d2 = (qq + v2s[j]) - 2.f * dist[tid][j];
        insert(bd, bi, d2, (int64_t)(vt + j));
      }
    }
    __syncthreads();
  }
  if (tid < kQB && q0 + tid < n_q) {
    const size_t base = ((size_t)split * n_q + q0 + tid) * kMaxK;
#pragma unroll
    for (int s = 0; s < kMaxK; ++s) {
      part_d[base + s] = bd[s];
      part_i[base + s] = bi[s];
    }
  }
}

__global__ void knn_merge(const float* __restrict__ part_d,
                          const int64_t* __restrict__ part_i,
                          float* __restrict__ out_d,
                          int64_t* __restrict__ out_i, int n_q, int n_split,
                          int k) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= n_q) return;
  float bd[kMaxK];
  int64_t bi[kMaxK];
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = INT64_MAX;
  }
  for (int sp = 0; sp < n_split; ++sp) {
    const size_t base = ((size_t)sp * n_q + qi) * kMaxK;
    for (int s = 0; s < kMaxK; ++s) insert(bd, bi, part_d[base + s], part_i[base + s]);
  }
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    if (s < k) {
      out_d[(size_t)qi * k + s] = fmaxf(bd[s], 0.f);
      out_i[(size_t)qi * k + s] = bi[s];
    }
  }
}

}  // namespace

extern "C" {

// queries [n_q, dim] f32, vectors [n_v, dim] f32 -> out_d [n_q, k] f32,
// out_i [n_q, k] int64. part_d / part_i: scratch of n_split * n_q * 8.
int rvc_knn_topk(const float* q, const float* v, float* out_d, int64_t* out_i,
                 float* part_d, int64_t* part_i, int n_q, int n_v, int dim,
                 int k, int n_split, int split_rows, void* stream) {
  if (k < 1 || k > kMaxK || n_split < 1 || n_q < 1 || n_v < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n_q + kQB - 1) / kQB, n_split);
  knn_partial<<<grid, kThreads, 0, s>>>(q, v, part_d, part_i, n_q, n_v, dim,
                                        split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge<<<(n_q + 127) / 128, 128, 0, s>>>(part_d, part_i, out_d, out_i,
                                              n_q, n_split, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
