// One block of CREPE's salience network on Hopper: kernel C `crepe_conv`.
//
// Replaces no TPU kernel: the JAX package runs CREPE through lax
// convolutions (rvc_tpu/predictors/crepe.py), which XLA compiles. It was
// added because the library path it replaces here (cuDNN's NCHW convs on an
// Ampere-era TF32 kernel, conv1 on f32 CUDA cores, and separate pad, ReLU,
// batch-norm and pool kernels) ran CREPE at 15 % of the TF32 bound. A block
// is, on frames of 1024 samples,
//   y = maxpool2(bn(relu(conv(x) + bias))),   bn(v) = v * scale + shift,
// with "same" zero padding; scale and shift fold the batch norm's running
// statistics (ops/crepe_conv.py).
//
// What bounds it on the card: operations. CREPE full does 2.82 GFLOP a
// frame, 76 % of it in conv2 (1024 -> 128 channels, 64 taps, 128 steps):
// a 512-frame batch is 1.44 TFLOP, 2.92 ms at TF32's 495 TFLOP/s.
//
// What the design does about it. Each conv is an implicit GEMM on the
// tensor cores: M = frames x output steps, N = output channels (a block
// takes 128 of them, or all where there are fewer), K = taps x input
// channels; wgmma m64nNk8 tf32, f32 accumulators in registers. Activations
// are channels-last [frames, T, C], so a row (one step of one frame) is
// K-major as it lies. A block computes 256 rows: whole frames (T x F = 256,
// so F = 256 / T frames), the frames of a group of `fi` interleaved row by
// row (row = step * fi + frame) so that every 64-row product tile lies in
// one group even where T < 64. The block's input rows for a chunk of `dk`
// input channels sit in shared memory in layout (a) of wgmma.cuh with the
// zero rows of the padding written in place (no padded copy in memory), so
// a tap is a row offset of the operand's start address: one chunk serves all
// its taps. Taps that only ever meet padding are skipped (at T = 8 only 15
// of 64 reach the signal). Roles (384 threads):
//
//   weight loader (one thread): the wrapper packs each (channel block,
//     chunk, tap) as one contiguous image of the stage's shared-memory
//     tile; one bulk copy (cp.async.bulk + mbarrier) per stage, a ring of
//     up to 8 stages (what the activation buffers leave).
//   activation loaders (warps 9-11): 16-byte loads of 4 channels, coalesced
//     along the channels, into two alternating chunk buffers; in the
//     single-pass mode rounded to tf32 (as cuDNN rounds), in 3xTF32 split
//     into the big plane (the low 13 bits cleared: exact tf32 values, so
//     the split does not rest on how the tensor cores read an f32's low
//     bits) and the small plane.
//   two consumer warpgroups: 128 rows each (two 64-row tiles, 2 x N/2
//     accumulator registers), every stage's products in one commit group,
//     one group left in flight while the next stage is awaited. The
//     epilogue adds the bias, applies ReLU and the folded batch norm, takes
//     the max of each pair of steps (a lane shuffle, or the thread's own
//     other row where fi = 8) and stores the pooled rows channels-last,
//     which is the next block's input (and, after the last block, the
//     classifier's time-major row).
//
// conv1 (one input channel, stride 4, 512 taps) is the same GEMM over
// samples: its im2col row t is samples 4t .. 4t + 511 of the padded frame,
// so with the frame in shared memory as rows of 4 samples the A operand of
// depth step s (8 samples) at output row t is rows t + 2s and t + 2s + 1: a
// descriptor whose leading offset (the next depth group) is one 16-byte row.
// The frame is read once; the 512 samples stream as stages of weights.
//
// Precision: single-pass tf32 products with f32 accumulation (both operands
// rounded to nearest), or 3xTF32 (wgmma.cuh) where the caller asks for f32.
// conv1 takes 3xTF32 at every setting: cuDNN ran it in f32 on the CUDA
// cores, and in tf32 it adds a block's rounding (about 3.4e-4 relative, as
// each of the others) to the chain. The single pass's error is its operands'
// rounding: the tensor cores' f32 sums round toward zero, but promoting them
// every stage moved conv2's error only from 3.7e-4 to 3.2e-4. Under 3xTF32,
// whose operands are exact to 2^-20, that rounding is the error left, and it
// grows with the depth (about 1e-3 over conv2's 65 536 products): at 64
// output channels or fewer a block moves the sums into a second set of
// registers every 16 stages, which leaves float32's error; conv1 (128
// channels a block, 512 deep) keeps them in the tensor cores.

#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384;
constexpr int kConsumers = 256;  // warps 0..7 (warp 8: the weight loader)
constexpr int kLoader0 = 288;    // warps 9..11: the activation loaders
constexpr int kLoaders = kThreads - kLoader0;
constexpr int kMaxStages = 8;
constexpr int kBlockRows = 256;  // output rows (steps x frames) of a block
constexpr int kFrame = 1024;     // samples of a frame (conv1's input)
constexpr int kFirstRows = 384;  // conv1's padded frame: 1532 samples, 4 a row
constexpr int kSmemMax = 232448;
constexpr int kPromote = 16;     // 3xTF32: stages between promotions of the sums

struct Args {
  const float* in;     // [frames, T, C_in] (conv1: [frames, 1024])
  float* out;          // [frames, T / 2, C_out]
  const float* w;      // packed weights (ops/crepe_conv.py:pack_weights)
  const float* bias;   // [C_out]
  const float* scale;  // [C_out], the batch norm folded
  const float* shift;  // [C_out]
  int frames, length, c_in, c_out;  // length: T, the output steps before the pool
  int first;           // conv1
  int fi, fg;          // frames interleaved in a group's rows, groups a block
  int pad_lo;          // zero steps (conv1: samples) before the signal
  int k_lo, taps;      // the stages a chunk runs: taps k_lo .. k_lo + taps - 1
  int w_taps;          // taps a chunk has in the packed weights
  int dk;              // depth of a stage: input channels (conv1: samples)
  int rs;              // rows of a depth group in shared memory
  int rg;              // rows of a frame group
  int stages;          // depth of the weight ring
  int chunks;          // depth chunks (conv1: 1)
  int plane_bytes;     // one activation plane
};

template <int N, bool THREE>  // N: output channels a block
__global__ void __launch_bounds__(kThreads, 1) crepe_conv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = THREE ? 2 : 1;  // planes: big and small in 3xTF32
  // 3xTF32 promotes its sums where a second set of them fits the registers
  constexpr bool PROMOTE = THREE && N <= 64;
  const int SB = P * a.dk * N * 4;  // bytes of a weight stage
  const int a_bytes = P * a.plane_bytes;
  const int nbuf = a.first ? 1 : 2;
  unsigned char* w_ring = smem;
  unsigned char* a_buf = smem + a.stages * SB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(a_buf + nbuf * a_bytes);
  uint64_t* w_full = bars;
  uint64_t* w_empty = bars + kMaxStages;
  uint64_t* a_full = bars + 2 * kMaxStages;
  uint64_t* a_empty = a_full + 2;

  const int tid = threadIdx.x;
  const int S = a.stages, T = a.length;
  const int n0 = blockIdx.x * a.fi * a.fg;  // the block's first frame
  const int nb = blockIdx.y;
  const int n_it = a.chunks * a.taps;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&a_full[s], kLoaders);
      mbar_init(&a_empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kLoader0) {
    // ---- activation loaders ----
    const int pt = tid - kLoader0;
    if (a.first) {
      // the frame, zero-padded, as rows of 4 samples: row p holds samples
      // 4p - pad_lo .. 4p - pad_lo + 3
      const float* src = a.in + (size_t)n0 * kFrame;
      for (int p = pt; p < kFirstRows; p += kLoaders) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 4 * p + e - a.pad_lo;
          v[e] = (s >= 0 && s < kFrame) ? __ldg(src + s) : 0.f;
        }
        float4 x = make_float4(v[0], v[1], v[2], v[3]);
        if (THREE) {
          *reinterpret_cast<float4*>(a_buf + p * 16) = tf32_big(x);
          *reinterpret_cast<float4*>(a_buf + a.plane_bytes + p * 16) = tf32_small(x);
        } else {
          x = make_float4(tf32_round(x.x), tf32_round(x.y), tf32_round(x.z), tf32_round(x.w));
          *reinterpret_cast<float4*>(a_buf + p * 16) = x;
        }
      }
      fence_async_proxy();
      mbar_arrive(&a_full[0]);
    } else {
      const int G = a.dk / 4;  // 16-byte depth groups a row
      const int items = a.fg * a.rg * G;
      for (int c = 0; c < a.chunks; ++c) {
        mbar_wait(&a_empty[c & 1], ((c >> 1) & 1) ^ 1);
        unsigned char* buf = a_buf + (c & 1) * a_bytes;
        const float* src = a.in + c * a.dk;
        for (int base = pt; base < items; base += 8 * kLoaders) {
          float4 val[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int idx = base + u * kLoaders;
            val[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (idx < items) {
              const int row = idx / G, g = idx - row * G;
              const int grp = row / a.rg, rr = row - grp * a.rg;
              const int p = rr / a.fi, f = rr - p * a.fi;
              const int n = n0 + grp * a.fi + f;
              const int t = p + a.k_lo - a.pad_lo;
              if (n < a.frames && t >= 0 && t < T)
                val[u] = __ldg(reinterpret_cast<const float4*>(
                    src + ((size_t)n * T + t) * a.c_in + 4 * g));
            }
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int idx = base + u * kLoaders;
            if (idx < items) {
              const int row = idx / G, g = idx - row * G;
              unsigned char* dst = buf + (g * a.rs + row) * 16;
              float4 x = val[u];
              if (THREE) {
                *reinterpret_cast<float4*>(dst) = tf32_big(x);
                *reinterpret_cast<float4*>(dst + a.plane_bytes) = tf32_small(x);
              } else {
                *reinterpret_cast<float4*>(dst) = make_float4(
                    tf32_round(x.x), tf32_round(x.y), tf32_round(x.z), tf32_round(x.w));
              }
            }
          }
        }
        fence_async_proxy();
        mbar_arrive(&a_full[c & 1]);
      }
    }
  } else if (tid >= kConsumers) {
    // ---- weight loader: one bulk copy a stage ----
    if (tid == kConsumers) {
      const float* src = a.w + (size_t)nb * a.chunks * a.w_taps * (SB / 4);
      int it = 0;
      for (int c = 0; c < a.chunks; ++c) {
        for (int k = 0; k < a.taps; ++k, ++it) {
          const int s = it % S;
          mbar_wait(&w_empty[s], ((it / S) & 1) ^ 1);
          mbar_arrive_expect_tx(&w_full[s], SB);
          bulk_copy(w_ring + s * SB,
                    src + ((size_t)c * a.w_taps + a.k_lo + k) * (SB / 4), SB,
                    &w_full[s]);
        }
      }
    }
  } else {
    // ---- consumers: rows 128 wg .. 128 wg + 127 of the block, N channels ----
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int TF = T * a.fi;  // rows of a frame group, in M order
    int row0[2];              // each 64-row tile's first activation row at tap 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m0 = 128 * wg + 64 * h, grp = m0 / TF;
      row0[h] = grp * a.rg + (m0 - grp * TF);
    }
    const int tap_rows = a.first ? a.dk / 4 : a.fi;  // rows a stage moves the operand
    const int lbo_rows = a.first ? 1 : a.rs;         // the next depth group, in rows
    const int step = 2 * lbo_rows * 16;              // bytes of a depth step (8)
    float acc[2][N / 2];
    float tot[PROMOTE ? 2 : 1][PROMOTE ? N / 2 : 1];  // the promoted sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[h][i] = 0.f;
      acc_fence(acc[h]);
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) tot[h][i] = 0.f;
    }

    int c = 0, k = 0;
    for (int it = 0; it < n_it; ++it) {
      if (k == 0) mbar_wait(&a_full[c & 1], (c >> 1) & 1);
      const int s = it % S;
      mbar_wait(&w_full[s], (it / S) & 1);
      unsigned char* wb = w_ring + s * SB;
      unsigned char* ab = a_buf + (c & 1) * a_bytes;
      wgmma_fence();
      for (int j = 0; j < a.dk / 8; ++j) {
        const uint64_t b_big = operand_desc(wb + j * 2 * N * 16, N);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned char* ap = ab + (row0[h] + k * tap_rows) * 16 + j * step;
          const uint64_t a_big = operand_desc(ap, lbo_rows);
          if (THREE) {
            const uint64_t b_small = operand_desc(wb + a.dk * N * 4 + j * 2 * N * 16, N);
            wgmma_tf32(acc[h], operand_desc(ap + a.plane_bytes, lbo_rows), b_big, 1);
            wgmma_tf32(acc[h], a_big, b_small, 1);
          }
          wgmma_tf32(acc[h], a_big, b_big, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage it - 1 are done: free it
      if (it >= 1 && lane == 0) {
        mbar_arrive(&w_empty[(it - 1) % S]);
        if (k == 0 && c >= 1) mbar_arrive(&a_empty[(c - 1) & 1]);
      }
      if constexpr (PROMOTE) {
        // the tensor cores round their f32 sums toward zero, an error that
        // grows with the products summed (about 1e-3 over conv2's 65 536
        // under 3xTF32): every kPromote stages the sums move into registers
        // the CUDA cores add to, rounding to nearest
        if ((it + 1) % kPromote == 0 || it + 1 == n_it) {
          wgmma_wait<0>();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc_fence(acc[h]);
#pragma unroll
            for (int i = 0; i < N / 2; ++i) {
              tot[h][i] += acc[h][i];
              acc[h][i] = 0.f;
            }
            acc_fence(acc[h]);
          }
        }
      }
      if (++k == a.taps) {
        k = 0;
        ++c;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) acc_fence(acc[h]);
    if constexpr (PROMOTE) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[h][i] = tot[h][i];
    }

    // epilogue: bias, ReLU, batch norm, then the pool over step pairs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int co = nb * N + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const float v = fmaxf(acc[h][i] + __ldg(a.bias + co), 0.f);
        acc[h][i] = v * __ldg(a.scale + co) + __ldg(a.shift + co);
      }
    }
    // rows m and m + fi are steps 2u and 2u + 1 of one frame: lanes 4 fi
    // apart, or (fi = 8) the thread's rows r and r + 8
    if (a.fi == 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < N / 2; i += 4) {
          acc[h][i] = fmaxf(acc[h][i], acc[h][i + 2]);
          acc[h][i + 1] = fmaxf(acc[h][i + 1], acc[h][i + 3]);
        }
    } else {
      const int lanes = 4 * a.fi;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          acc[h][i] = fmaxf(acc[h][i], __shfl_xor_sync(0xffffffffu, acc[h][i], lanes));
    }
    const int half = T / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 128 * wg + 64 * h + 16 * warp + lane / 4 + 8 * hh;
        const int grp = m / TF, rem = m - grp * TF;
        const int t = rem / a.fi, n = n0 + grp * a.fi + (rem - t * a.fi);
        if ((t & 1) == 0 && n < a.frames) {
          float* o = a.out + ((size_t)n * half + t / 2) * a.c_out + nb * N + 2 * (lane % 4);
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
            *reinterpret_cast<float2*>(o + 8 * j) =
                make_float2(acc[h][4 * j + 2 * hh], acc[h][4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

template <int N, bool THREE>
cudaError_t launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      crepe_conv_kernel<N, THREE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  crepe_conv_kernel<N, THREE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool THREE>
cudaError_t launch_n(const Args& a, int n_tile, dim3 grid, int smem, cudaStream_t st) {
  switch (n_tile) {
    case 16: return launch<16, THREE>(a, grid, smem, st);
    case 32: return launch<32, THREE>(a, grid, smem, st);
    case 64: return launch<64, THREE>(a, grid, smem, st);
    case 128: return launch<128, THREE>(a, grid, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One CREPE block on f32 tensors: in [frames, T, c_in] channels-last (conv1:
// the normalised frames [frames, 1024], c_in 1, T 256), out [frames, T / 2,
// c_out]. w: the conv packed by ops/crepe_conv.py:pack_weights for this
// plan; bias, scale, shift [c_out]. The geometry (n_tile, fi, fg, k_lo,
// taps, w_taps, dk, rs, rg, stages) is ops/crepe_conv.py:plan's; three: 1
// for 3xTF32 (128 channels a block only for conv1, whose 512-deep sums are
// not promoted), 0 for single-pass tf32.
int rvc_crepe_conv(const float* in, float* out, const float* w, const float* bias,
                   const float* scale, const float* shift, int frames, int length,
                   int c_in, int c_out, int n_tile, int first, int fi, int fg,
                   int pad_lo, int k_lo, int taps, int w_taps, int dk, int three,
                   int rs, int rg, int stages, void* stream) {
  const int planes = three ? 2 : 1;
  if (frames < 1 || n_tile < 16 || n_tile > (three && !first ? 64 : 128) || c_out % n_tile != 0 ||
      stages < 2 || stages > kMaxStages || (dk != 8 && dk != 16 && dk != 32) ||
      dk * planes > 32 || taps < 1 || k_lo < 0 || k_lo + taps > w_taps)
    return (int)cudaErrorInvalidValue;
  if (first) {
    if (c_in != 1 || length * fi * fg != kBlockRows || fi != 1 || fg != 1 ||
        taps * dk != 512 || w_taps != taps || k_lo != 0 || pad_lo < 0 ||
        pad_lo + kFrame > 4 * kFirstRows)
      return (int)cudaErrorInvalidValue;
  } else {
    if (c_in % dk != 0 || length * fi * fg != kBlockRows || (length * fi) % 64 != 0 ||
        (fi != 1 && fi != 2 && fi != 4 && fi != 8) || length % 2 != 0 ||
        rg < (length + taps - 1) * fi || rs < fg * rg)
      return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.in = in;
  a.out = out;
  a.w = w;
  a.bias = bias;
  a.scale = scale;
  a.shift = shift;
  a.frames = frames;
  a.length = length;
  a.c_in = c_in;
  a.c_out = c_out;
  a.first = first;
  a.fi = fi;
  a.fg = fg;
  a.pad_lo = pad_lo;
  a.k_lo = k_lo;
  a.taps = taps;
  a.w_taps = w_taps;
  a.dk = dk;
  a.rs = rs;
  a.rg = rg;
  a.stages = stages;
  a.chunks = first ? 1 : c_in / dk;
  a.plane_bytes = first ? kFirstRows * 16 : (dk / 4) * rs * 16;
  const int smem = stages * planes * dk * n_tile * 4 +
                   (first ? 1 : 2) * planes * a.plane_bytes + (2 * kMaxStages + 4) * 8;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int per_block = fi * fg;
  dim3 grid((frames + per_block - 1) / per_block, c_out / n_tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(three ? launch_n<true>(a, n_tile, grid, smem, st)
                     : launch_n<false>(a, n_tile, grid, smem, st));
}

}  // extern "C"
