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
// 201 MB index read, about 400 FLOP per byte. The search is exact, so the
// f32 product runs on the tensor cores as 3xTF32 (three tf32 products per
// f32 product, see wgmma.cuh): 2.4e11 tensor-core FLOP.
//
// What the design does about it. Pass 1 tiles the (query, index) plane: a
// block owns kQB = 128 queries and one contiguous split of the index, and
// walks the split in tiles of kVB = 128 rows. Both operands stream through
// shared memory in depth chunks of kDK = 32 floats, so the index is read
// once per 128 queries and the queries come from L2 again for every index
// tile: 2.7 GB from L2 in all. Measured with parts of the kernel compiled
// out, the copies are what holds it: as cp.async copies of 16 bytes a
// thread they alone took as long as the whole kernel. So the tiles come by
// TMA (one instruction per operand and chunk, 128-byte swizzle, zero fill
// past the matrix), into a ring of kStages raw stages. The block is
// warp-specialised:
//
//   two producer warpgroups (256 threads, 88 registers each by setmaxnreg):
//     one thread issues the TMA loads, kLag chunks ahead of the chunk
//     being converted. For the chunk that has landed, a thread takes half
//     of one row of each operand: it writes the tf32 "small" parts to one
//     of two small-plane slots at the same (swizzled) offsets (the raw
//     plane serves as the "big" part, which the hardware truncates itself)
//     and adds the squares to |q|^2 and |v|^2. They hand the chunk over on
//     an mbarrier.
//   two consumer warpgroups (64 queries each): wgmma m64n128k8 tf32, both
//     operands from shared memory, three products per depth step into one
//     64 x 128 f32 accumulator per warpgroup.
//
// Top-k out of the accumulators: in the accumulator layout four lanes hold
// one query row, 32 columns each. After the last chunk of an index tile a
// lane turns its columns into distances and tests each against the 8th
// entry of the sorted top-8 it keeps in registers for each of its two rows;
// after the first tiles almost nothing is inserted. At the end of the split
// the four lanes' lists are merged by shuffles and one lane writes the
// split's top-8. Blocks run in no order, so pass 2 (knn_merge) merges the
// splits' candidates per query. The wrapper picks the splits so that one
// block per SM is in flight (a block takes most of an SM's shared memory).

#include <math_constants.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kQB = 128;     // queries per block (64 per consumer warpgroup)
constexpr int kVB = 128;     // index rows per tile
constexpr int kDK = 32;      // depth chunk (kGroups groups of 16 bytes)
constexpr int kGroups = kDK / 4;
constexpr int kStages = 4;   // raw stages (4 / 2 / 1 measured best of the
constexpr int kSmall = 2;    // small-plane slots   ring depths that fit)
constexpr int kLag = 1;      // the producers convert chunk i - kLag while i loads
constexpr int kConsumers = 256;
constexpr int kProducers = 256;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMaxK = 8;
constexpr int kPlane = kQB * kDK * 4;          // bytes of one operand plane
constexpr int kStageBytes = 2 * kPlane;        // q and v (raw stage or small slot)
constexpr int kSmemBytes = 1024 + (kStages + kSmall) * kStageBytes +
                           2 * kStages * kVB * 4 + 2 * kQB * 4 + 3 * kStages * 8;

template <typename I>
__device__ __forceinline__ bool before(float d, I i, float bd, I bi) {
  return d < bd || (d == bd && i < bi);
}

template <typename I>
__device__ __forceinline__ void insert(float (&bd)[kMaxK], I (&bi)[kMaxK],
                                       float d, I i) {
  if (!before(d, i, bd[kMaxK - 1], bi[kMaxK - 1])) return;
#pragma unroll
  for (int s = 0; s < kMaxK; ++s) {
    if (before(d, i, bd[s], bi[s])) {
      const float td = bd[s];
      const I ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
knn_partial(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap v_map,
            float* __restrict__ part_d, int64_t* __restrict__ part_i, int n_q,
            int n_v, int dim, int split_rows) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* small = smem + kStages * kStageBytes;
  float* v2s = reinterpret_cast<float*>(small + kSmall * kStageBytes);
  float* q2s = v2s + 2 * kStages * kVB;
  uint64_t* full = reinterpret_cast<uint64_t*>(q2s + 2 * kQB);
  uint64_t* empty = full + kStages;
  uint64_t* landed = empty + kStages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQB;
  const int split = blockIdx.y;
  const int v_begin = split * split_rows;
  const int v_end = min(n_v, v_begin + split_rows);
  const int n_tiles = max(0, (v_end - v_begin + kVB - 1) / kVB);
  const int n_chunks = (dim + kDK - 1) / kDK;
  const int total = n_tiles * n_chunks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kProducers);
      mbar_init(&empty[s], kConsumers / 32);
      mbar_init(&landed[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producers: load chunk i, convert and hand over chunk i - kLag ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    const int t = tid - kConsumers;
    // conversion: half `chalf` of the 16-byte groups of row `crow`
    const int crow = t % kQB, chalf = t / kQB;
    float q2 = 0.f, v2 = 0.f;
    int ld_tile = 0, ld_ch = 0;
    for (int i = 0; i < total + kLag; ++i) {
      if (i < total && t == 0) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);  // chunk i - kStages is done
        unsigned char* st = smem + s * kStageBytes;
        mbar_arrive_expect_tx(&landed[s], kStageBytes);
        tma_load_tile(st, &q_map, ld_ch * kDK, q0, &landed[s]);
        tma_load_tile(st + kPlane, &v_map, ld_ch * kDK, v_begin + ld_tile * kVB,
                      &landed[s]);
        if (++ld_ch == n_chunks) {
          ld_ch = 0;
          ++ld_tile;
        }
      }
      if (i >= kLag) {
        const int p = i - kLag;
        // its small slot was read last by chunk p - kSmall
        if (p >= kSmall)
          mbar_wait(&empty[(p - kSmall) % kStages], ((p - kSmall) / kStages) & 1);
        mbar_wait(&landed[p % kStages], (p / kStages) & 1);
        const int s = p % kStages;
        const unsigned char* st = smem + s * kStageBytes;
        unsigned char* sm = small + (p % kSmall) * kStageBytes;
#pragma unroll
        for (int m = 0; m < kGroups / 2; ++m) {
          // 8 consecutive rows take 8 distinct groups: no bank conflict
          const int off = crow * 128 + ((crow + 2 * m + chalf) & 7) * 16;
          const float4 a = *reinterpret_cast<const float4*>(st + off);
          *reinterpret_cast<float4*>(sm + off) = tf32_small(a);
          q2 += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
          const float4 b = *reinterpret_cast<const float4*>(st + kPlane + off);
          *reinterpret_cast<float4*>(sm + kPlane + off) = tf32_small(b);
          v2 += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
        }
        if (p % n_chunks == n_chunks - 1) {  // last chunk of an index tile
          v2s[(2 * s + chalf) * kVB + crow] = v2;
          if (p < n_chunks) q2s[chalf * kQB + crow] = q2;
          v2 = 0.f;
          q2 = 0.f;
        }
        fence_async_proxy();
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: 64 queries x 128 index rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 168;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int gr = lane / 4, qd = lane % 4;
    const int row0 = wg * 64 + warp * 16 + gr;  // this lane's rows: row0, row0 + 8
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float bd[2][kMaxK];
    int bi[2][kMaxK];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < kMaxK; ++s) {
        bd[h][s] = CUDART_INF_F;
        bi[h][s] = INT32_MAX;
      }

    for (int tile = 0, i = 0; tile < n_tiles; ++tile) {
      for (int ch = 0; ch < n_chunks; ++ch, ++i) {
        const int s = i % kStages;
        mbar_wait(&full[s], (i / kStages) & 1);
        const unsigned char* st = smem + s * kStageBytes;
        const unsigned char* sm = small + (i % kSmall) * kStageBytes;
        const uint64_t a_big = operand_desc_sw128(st + wg * 64 * 128);
        const uint64_t a_small = operand_desc_sw128(sm + wg * 64 * 128);
        const uint64_t b_big = operand_desc_sw128(st + kPlane);
        const uint64_t b_small = operand_desc_sw128(sm + kPlane);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDK / 8; ++kk) {
          const int adv = kk * 32;  // 8 floats further on in the swizzled rows
          wgmma_3xtf32(acc, desc_advance(a_big, adv), desc_advance(a_small, adv),
                       desc_advance(b_big, adv), desc_advance(b_small, adv),
                       (ch | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        // the last chunk's stage also holds the tile's |v|^2: freed below
        if (lane == 0 && ch != n_chunks - 1) mbar_arrive(&empty[s]);
      }
      acc_fence(acc);
      // distances of this index tile, straight from the accumulators
      const int s = (i - 1) % kStages;
      const int vt = v_begin + tile * kVB;
      const float qq[2] = {q2s[row0] + q2s[kQB + row0],
                           q2s[row0 + 8] + q2s[kQB + row0 + 8]};
      const float* vv = v2s + 2 * s * kVB;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * qd;
        const float2 va = *reinterpret_cast<const float2*>(vv + col);
        const float2 vb = *reinterpret_cast<const float2*>(vv + kVB + col);
        const float2 v2 = make_float2(va.x + vb.x, va.y + vb.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int gi = vt + col + (e % 2);
          const float d2 = (qq[h] + ((e % 2) ? v2.y : v2.x)) - 2.f * acc[4 * j + e];
          if (gi < v_end) insert(bd[h], bi[h], d2, gi);
        }
      }
      acc_fence(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // merge the four lanes' lists of each row, then one lane writes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        float od[kMaxK];
        int oi[kMaxK];
#pragma unroll
        for (int s = 0; s < kMaxK; ++s) {
          od[s] = __shfl_xor_sync(0xffffffffu, bd[h][s], m);
          oi[s] = __shfl_xor_sync(0xffffffffu, bi[h][s], m);
        }
#pragma unroll
        for (int s = 0; s < kMaxK; ++s) insert(bd[h], bi[h], od[s], oi[s]);
      }
      const int row = q0 + row0 + 8 * h;
      if (qd == 0 && row < n_q) {
        const size_t base = ((size_t)split * n_q + row) * kMaxK;
#pragma unroll
        for (int s = 0; s < kMaxK; ++s) {
          part_d[base + s] = bd[h][s];
          part_i[base + s] = bi[h][s] == INT32_MAX ? INT64_MAX : (int64_t)bi[h][s];
        }
      }
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

// queries [n_q, dim] f32, vectors [n_v, dim] f32 (dim a multiple of 4) ->
// out_d [n_q, k] f32, out_i [n_q, k] int64. part_d / part_i: scratch of
// n_split * n_q * 8; split_rows: index rows per split, a multiple of 128.
int rvc_knn_topk(const float* q, const float* v, float* out_d, int64_t* out_i,
                 float* part_d, int64_t* part_i, int n_q, int n_v, int dim,
                 int k, int n_split, int split_rows, void* stream) {
  if (k < 1 || k > kMaxK || n_split < 1 || n_q < 1 || n_v < 1 || dim < 4 ||
      dim % 4 != 0 || split_rows % kVB != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, v_map;
  if (!make_tile_map(&q_map, q, n_q, dim, kQB) ||
      !make_tile_map(&v_map, v, n_v, dim, kVB))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      knn_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_q + kQB - 1) / kQB, n_split);
  knn_partial<<<grid, kThreads, kSmemBytes, s>>>(q_map, v_map, part_d, part_i,
                                                 n_q, n_v, dim, split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge<<<(n_q + 127) / 128, 128, 0, s>>>(part_d, part_i, out_d, out_i,
                                              n_q, n_split, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
