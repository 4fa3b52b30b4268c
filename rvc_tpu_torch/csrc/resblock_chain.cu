// One ResBlock chain of a wide HiFi-GAN decoder stage on Hopper: kernel K2
// `resblock_chain`.
//
// Replaces the TPU kernel rvc_tpu/ops/resblock_pallas.py fused_resblock
// (_fused_resblock_impl, pallas_call at :239). A chain is, per dilation d:
//   m = conv_d(leaky(y));  y = y + conv_1(leaky(m)),
// with zero padding outside [0, T), f32 compute, I/O in the caller's dtype.
// The precision is kept: every f32 product runs as 3xTF32 (wgmma.cuh).
//
// What bounds it on the card: operations. A conv at C channels and K taps
// is a GEMM of (C x K*C) by (K*C x T): at the serving shape (C = 256,
// T = 19176, K = 3, 7, 11) 126 * 2 * C^2 * T = 3.2e11 f32 FLOP per
// conversion, 9.5e11 on the tensor cores, against a 19.6 MB f32 signal that
// stays in the 50 MB L2 from one conv to the next.
//
// What the design does about it. On the TPU the chain is fused to keep the
// signal out of device memory. Here the signal stays in L2 between launches,
// while a fused pair would have to hold conv_d's output for conv_1 in
// shared memory in two planes (the 3xTF32 "big" and "small" parts):
// 138 rows x 256 channels x 8 bytes = 283 KB, more than an SM has. So the
// kernel is ONE CONV, launched twice per dilation pair, with the
// activation, bias, residual, mask and type conversion fused around it:
//
//   out[co, t] = post(bias[co] + sum_{tap, ci} W[co, ci, tap]
//                                  * pre(in[ci, t + (tap - K/2) * d])) (+ res)
//   conv_d:  pre = leaky, post = leaky, out = m (f32 scratch, in L2)
//   conv_1:  pre = id,    post = id, res = y, out = the next y
//
// There is no halo to recompute, and shared memory goes to the rings.
// A conv whose activation tile (N + (K - 1) d rows, two planes) does not
// fit beside two weight stages at any N (K = 15 at d = 15, K = 3 at d = 99)
// runs as runs of consecutive taps, one launch each: `first` places a run's
// taps, and each later run adds into the f32 sum of the runs before it
// through the residual operand (ops/resblock.py:conv_taps), so the kernel
// takes every K and d.
// A block computes 128 output channels x N time steps, N = 128, 152 or 176
// as the wrapper picks it: a block takes an SM to itself, so the grid
// (time tiles, channel blocks, batch) runs in waves of 132 blocks, and N is
// the tile that wastes least of the last wave (at T = 19176, C = 256:
// N = 152 gives 254 blocks, two waves, where 128 gives 300, three). Channels are the M side and time the
// N side of the product, so the time tile needs no multiple of 64, and the
// weights, [C_out][C_in] per tap with C_in contiguous, are K-major as they
// come. The block is warp-specialised:
//
//   weight loader (one thread): the wrapper packs every (channel block,
//     32-channel depth chunk, tap) as one contiguous 32 KB image of the
//     shared-memory tile, "big" plane then "small" plane, split once at
//     pack time. One bulk copy (cp.async.bulk + mbarrier) per ring stage,
//     3 or 4 stages in flight.
//   activation loaders (7 warps): x is [C, T] with T contiguous, the wrong
//     way round for a tf32 wgmma, so the tile is turned through registers:
//     a thread gathers 4 channels of one time step (each load coalesced
//     along T), applies pre(), and stores 16 bytes to each plane; lanes are
//     consecutive rows, so the stores hit distinct banks. One tile of
//     N + (K - 1) d rows serves all K taps of a depth chunk: in the
//     layout without swizzle a tap is a row offset of the descriptor's
//     start address. Two such tiles alternate.
//   two consumer warpgroups (64 output channels each): wgmma m64nNk8
//     tf32, both operands from shared memory, 12 products per (chunk, tap)
//     into one 64 x N f32 accumulator; one group of products stays in
//     flight while the next stage is awaited. The epilogue adds bias and
//     residual and stores two time steps per lane.

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kCB = 128;          // output channels per block (the M side)
constexpr int kDK = 32;           // input channels per depth chunk
constexpr int kConsumers = 256;   // warps 0..7
constexpr int kLoaders = 224;     // warps 9..15 (warp 8: the weight loader)
constexpr int kThreads = 512;
constexpr int kStageBytes = 2 * kCB * kDK * 4;  // big and small weight planes
constexpr int kMaxStages = 4;

struct ConvArgs {
  const void* in;     // [B, C, T] f32 or bf16
  const void* res;    // residual [B, C, T] f32 or bf16, or null
  void* out;          // [B, C, T] f32 or bf16
  const float* w;     // packed weights of this conv
  const float* bias;  // [c_blocks * 128] f32, zero past C
  int in_bf16, res_bf16, out_bf16;
  int channels;       // C, a multiple of 32
  int length;         // T
  int taps, dil;
  int first;          // time offset of tap 0 from the output step: -(K / 2) * d for a
                      // whole conv, later for a run of its taps
  int rows;           // N + (taps - 1) * dil: rows of an activation tile
  int stages;         // weight ring depth
  int pre_leaky, post_leaky;
  float slope;
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ float load_in(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int N>  // time steps per block (the N side of the product)
__global__ void __launch_bounds__(kThreads, 1) conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = a.rows;
  const int plane = 8 * R * 16;  // bytes of one activation plane
  unsigned char* a_ring = smem;
  unsigned char* b_buf = smem + a.stages * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(b_buf + 4 * plane);
  uint64_t* a_full = bars;
  uint64_t* a_empty = bars + kMaxStages;
  uint64_t* b_full = bars + 2 * kMaxStages;
  uint64_t* b_empty = b_full + 2;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * N;
  const int cb = blockIdx.y;
  const int C = a.channels, T = a.length, K = a.taps, S = a.stages;
  const size_t batch_off = (size_t)blockIdx.z * C * T;
  const int n_kc = C / kDK;
  const int n_it = n_kc * K;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&b_full[s], kLoaders);
      mbar_init(&b_empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers + 32) {
    // ---- activation loaders: one tile per depth chunk ----
    const int pt = tid - (kConsumers + 32);
    const int items = 8 * R;  // (channel group of 4, row)
    const int g_first = t0 + a.first;  // time of tile row 0
    for (int kc = 0; kc < n_kc; ++kc) {
      mbar_wait(&b_empty[kc & 1], ((kc >> 1) & 1) ^ 1);
      unsigned char* big = b_buf + (kc & 1) * 2 * plane;
      // 8 items a thread per pass, all 32 loads issued before the first use
      for (int base = pt; base < items; base += 8 * kLoaders) {
        float4 val[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + u * kLoaders;
          val[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < items) {
            const int g = idx / R, r = idx - g * R;
            const int t = g_first + r;
            if (t >= 0 && t < T) {
              const size_t i0 = batch_off + (size_t)(kc * kDK + 4 * g) * T + t;
              val[u].x = load_in(a.in, i0, a.in_bf16);
              val[u].y = load_in(a.in, i0 + T, a.in_bf16);
              val[u].z = load_in(a.in, i0 + 2 * (size_t)T, a.in_bf16);
              val[u].w = load_in(a.in, i0 + 3 * (size_t)T, a.in_bf16);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = base + u * kLoaders;
          if (idx < items) {
            float4 x = val[u];
            if (a.pre_leaky) {
              x.x = leaky(x.x, a.slope);
              x.y = leaky(x.y, a.slope);
              x.z = leaky(x.z, a.slope);
              x.w = leaky(x.w, a.slope);
            }
            // idx = g * R + r is the 16-byte slot of (group g, row r)
            *reinterpret_cast<float4*>(big + idx * 16) = x;
            *reinterpret_cast<float4*>(big + plane + idx * 16) = tf32_small(x);
          }
        }
      }
      fence_async_proxy();
      mbar_arrive(&b_full[kc & 1]);
    }
  } else if (tid >= kConsumers) {
    // ---- weight loader: one bulk copy per (depth chunk, tap) ----
    if (tid == kConsumers) {
      const float* src = a.w + (size_t)cb * n_it * (kStageBytes / 4);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % S;
        mbar_wait(&a_empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&a_full[s], kStageBytes);
        bulk_copy(a_ring + s * kStageBytes, src + (size_t)it * (kStageBytes / 4),
                  kStageBytes, &a_full[s]);
      }
    }
  } else {
    // ---- consumers: 64 output channels x N time steps per warpgroup ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int gr = lane / 4, qd = lane % 4;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    acc_fence(acc);

    int kc = 0, tap = 0;
    for (int it = 0; it < n_it; ++it) {
      if (tap == 0) mbar_wait(&b_full[kc & 1], (kc >> 1) & 1);
      const int s = it % S;
      mbar_wait(&a_full[s], (it / S) & 1);
      unsigned char* wa = a_ring + s * kStageBytes + wg * 64 * 16;
      unsigned char* xb = b_buf + (kc & 1) * 2 * plane + tap * a.dil * 16;
      const uint64_t a_big = operand_desc(wa, kCB);
      const uint64_t a_small = operand_desc(wa + kStageBytes / 2, kCB);
      const uint64_t b_big = operand_desc(xb, R);
      const uint64_t b_small = operand_desc(xb + plane, R);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDK / 8; ++kk) {
        const int adv_a = kk * 2 * kCB * 16;  // two depth groups per product
        const int adv_b = kk * 2 * R * 16;
        wgmma_3xtf32(acc, desc_advance(a_big, adv_a), desc_advance(a_small, adv_a),
                     desc_advance(b_big, adv_b), desc_advance(b_small, adv_b),
                     (it | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of step it - 1 are done: free its stage
      if (it >= 1 && lane == 0) {
        mbar_arrive(&a_empty[(it - 1) % S]);
        if (tap == 0) mbar_arrive(&b_empty[(kc - 1) & 1]);
      }
      if (++tap == K) {
        tap = 0;
        ++kc;
      }
    }
    wgmma_wait<0>();
    acc_fence(acc);

    // epilogue: bias, activation, residual, store in the output's dtype
    const bool pair_ok = (T % 2) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = cb * kCB + wg * 64 + warp * 16 + gr + 8 * h;
      if (co >= C) continue;
      const float bias = a.bias[co];
      const size_t row = batch_off + (size_t)co * T;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int t = t0 + 8 * j + 2 * qd;
        if (t >= T) continue;
        float v0 = acc[4 * j + 2 * h] + bias;
        float v1 = acc[4 * j + 2 * h + 1] + bias;
        if (a.post_leaky) {
          v0 = leaky(v0, a.slope);
          v1 = leaky(v1, a.slope);
        }
        const bool two = t + 1 < T;
        if (pair_ok) {  // t is even: both steps are there and aligned
          if (a.res) {
            if (a.res_bf16) {
              const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
                  static_cast<const __nv_bfloat16*>(a.res) + row + t);
              v0 += __low2float(r);
              v1 += __high2float(r);
            } else {
              const float2 r = *reinterpret_cast<const float2*>(
                  static_cast<const float*>(a.res) + row + t);
              v0 += r.x;
              v1 += r.y;
            }
          }
          if (a.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.out) + row + t) =
                __floats2bfloat162_rn(v0, v1);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + row + t) =
                make_float2(v0, v1);
        } else {
          if (a.res) {
            v0 += load_in(a.res, row + t, a.res_bf16);
            if (two) v1 += load_in(a.res, row + t + 1, a.res_bf16);
          }
          if (a.out_bf16) {
            __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + row + t;
            o[0] = __float2bfloat16(v0);
            if (two) o[1] = __float2bfloat16(v1);
          } else {
            float* o = static_cast<float*>(a.out) + row + t;
            o[0] = v0;
            if (two) o[1] = v1;
          }
        }
      }
    }
  }
}

template <int N>
cudaError_t launch(const ConvArgs& a, int batch, int c_blocks, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.length + N - 1) / N, c_blocks, batch);
  conv_kernel<N><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One conv of a chain on [B, C, T] (C a multiple of 32):
//   out = post(bias + conv(pre(in))) + res
// with pre / post = leaky_relu(slope) where the flag is set, res optional,
// each of in / res / out f32 or bf16. w: the conv's weights as packed by
// ops/resblock.py:pack_conv_tf32 (c_blocks blocks of 128 output channels);
// bias f32 [c_blocks * 128]. taps, dil, first: the conv's taps (or a run
// of them), their dilation, and the time offset of the first from the output
// step (-(taps / 2) * dil for a whole centred conv). tile: time steps per
// block (128, 152 or 176); stages: depth of the weight ring (2..4); both
// from ops/resblock.py:conv_launch.
int rvc_conv_tf32(const void* in, int in_bf16, const void* res, int res_bf16,
                  void* out, int out_bf16, const float* w, const float* bias,
                  int batch, int channels, int c_blocks, int length, int taps,
                  int dil, int first, int tile, int stages, int pre_leaky, int post_leaky,
                  float slope, void* stream) {
  if (batch < 1 || channels < kDK || channels % kDK != 0 || length < 1 ||
      taps < 1 || dil < 1 || stages < 2 ||
      stages > kMaxStages || c_blocks * kCB < channels)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.in = in;
  a.res = res;
  a.out = out;
  a.w = w;
  a.bias = bias;
  a.in_bf16 = in_bf16;
  a.res_bf16 = res_bf16;
  a.out_bf16 = out_bf16;
  a.channels = channels;
  a.length = length;
  a.taps = taps;
  a.dil = dil;
  a.first = first;
  a.rows = tile + (taps - 1) * dil;
  a.stages = stages;
  a.pre_leaky = pre_leaky;
  a.post_leaky = post_leaky;
  a.slope = slope;
  const int smem = stages * kStageBytes + 4 * 8 * a.rows * 16 +
                   (2 * kMaxStages + 4) * 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 128: return (int)launch<128>(a, batch, c_blocks, smem, st);
    case 152: return (int)launch<152>(a, batch, c_blocks, smem, st);
    case 176: return (int)launch<176>(a, batch, c_blocks, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
