// HiFi-GAN decoder stage tails on Hopper: kernel K1 `mrf_stage`. (K2
// `resblock_chain`, the one-chain kernel of the wide stages, is
// resblock_chain.cu.)
//
// Replaces the TPU kernel rvc_tpu/ops/resblock_pallas.py fused_mrf
// (_fused_mrf_impl, pallas_call at :437): the mean over the parallel
// ResBlock chains of one decoder stage. A chain is, per dilation d: m = conv_d(leaky(y)); y = y + conv_1(leaky(m)),
// with values outside [0, T) zeroed after every conv, as the direct convs'
// zero padding requires.
//
// What bounds it on the card: operations. A stage of three chains runs
// 2 * 126 * C^2 * T FLOP (about 1.7e12 over the four stages of one 10 s
// 48 kHz conversion) against 2 bytes in and 2 bytes out per sample and
// channel in bf16: hundreds of FLOP per byte, far above the ridge.
//
// What the design does about it: each block owns one time tile of one
// batch row, loads the tile plus the chain's halo (60 samples a side for
// k = 11, d = 1, 3, 5) into shared memory once, runs every conv of every
// chain out of shared memory, and writes the stage output once: device
// memory sees one read and one write of the signal instead of 12 per chain.
// Each conv computes only the rows later convs still need (the halo shrinks
// conv by conv), as a GEMM of (rows x K*C_in) by (K*C_in x C_out) on the
// tensor cores with mma.sync (no wgmma, no TMA). The operand precision is
// a template parameter:
//
//   bf16    mma.sync.m16n8k16, bf16 x bf16 -> f32: exactly the TPU kernel's
//           dot (K1 on bf16 input, the serving path). The state y stays f32;
//           the activated conv1 output m is kept as a bf16 operand.
//   3xTF32  mma.sync.m16n8k8: each f32 operand v is split into
//           big = tf32(v) and small = tf32(v - big), and every product is
//           big*big + big*small + small*big, about 21 bits of each product
//           (the dropped small*small term is below f32's rounding). K1 on f32
//           input.
//
// Shared memory holds y (f32, rows padded so the fragment loads hit distinct
// banks) and m (bf16 or f32). A warp computes 32 rows x 8*NT channels at a
// time. The tile is 32 rows per warp row of the last conv, so that conv's
// outputs map one to one onto the 8 warps and the sum over chains stays in
// registers. The weights are packed by the wrapper in B-fragment order, so a
// warp reads each fragment with one coalesced load per lane (from L2, shared
// by the block's warps through L1). Channels are padded by the wrapper to
// 16, 32 or a multiple of 64.
//
// Layout: x and out are [B, C, T] (contiguous), f32 or bf16. Weights are
// ordered chain-major, conv1 then conv2 per dilation; biases f32
// [n_convs][C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWM = 32;  // rows per warp item (two m16 tiles)
constexpr int kMaxChains = 4;
constexpr int kMaxDil = 4;

struct Args {
  int channels, length, tile, halo, n_chains, n_dil;
  int ks[kMaxChains];
  int dil[kMaxDil];
  float slope;
  int ldy;  // floats per row of the state y
  int ldm;  // elements per row of the operand buffer m
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per precision: the operand buffer's element, the packed B fragment of one
// lane, and the k extent of one mma.
template <bool BF16>
struct Ops {
  using M = __nv_bfloat16;  // m16n8k16: lane holds 4 bf16 of the B fragment
  using W = uint2;
  static constexpr int kK = 16;
};
template <>
struct Ops<false> {
  using M = float;  // m16n8k8 (tf32): lane holds 2 f32 of the B fragment
  using W = float2;
  static constexpr int kK = 8;
};

// One conv over buffer rows [lo, hi).
//   CONV1: m[r] = leaky(mask * (b + conv_d(leaky(y))))
//   else : y[r] = mask * (y[r] + b + conv_1(m)); with FINAL the result is
//          added to the per-thread chain sum instead of stored.
// w: this conv's weights, [K][C/kK][C/8][32 lanes] B fragments.
template <bool BF16, int NT, bool CONV1, bool FINAL>
__device__ void conv(float* ys, typename Ops<BF16>::M* ms,
                     const typename Ops<BF16>::W* __restrict__ w,
                     const float* __restrict__ b, int K, int d, int lo, int hi,
                     int g0, const Args& a, float (&sum)[2][NT][4]) {
  using W = typename Ops<BF16>::W;
  constexpr int kK = Ops<BF16>::kK;
  const int C = a.channels;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, q = lane % 4;
  const int ncg = C / (NT * 8);
  const int items = (hi - lo + kWM - 1) / kWM * ncg;
  const int n_kc = C / kK, n_nt = C / 8;
  const int center = (K - 1) / 2;
  for (int item = warp; item < items; item += kWarps) {
    const int r0 = lo + (item / ncg) * kWM;
    const int n0 = (item % ncg) * NT * 8;
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    int rr[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rr[mt][h] = min(r0 + mt * 16 + h * 8 + gr, hi - 1);

    for (int k = 0; k < K; ++k) {
      const int off = (k - center) * d;
      const W* wk = w + ((size_t)k * n_kc * n_nt + n0 / 8) * 32 + lane;
#pragma unroll(BF16 ? 2 : 1)
      for (int kc = 0; kc < n_kc; ++kc) {
        if constexpr (BF16) {
          // A: rows (gr, gr+8), c_in 16 kc + (2q, 2q+1, 2q+8, 2q+9)
          uint2 bv[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            bv[nt] = __ldg(wk + ((size_t)kc * n_nt + nt) * 32);
          const int c0 = kc * 16 + 2 * q;
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (CONV1) {
              const float* p0 = ys + (rr[mt][0] + off) * a.ldy + c0;
              const float* p1 = ys + (rr[mt][1] + off) * a.ldy + c0;
              const float2 v00 = *reinterpret_cast<const float2*>(p0);
              const float2 v10 = *reinterpret_cast<const float2*>(p1);
              const float2 v01 = *reinterpret_cast<const float2*>(p0 + 8);
              const float2 v11 = *reinterpret_cast<const float2*>(p1 + 8);
              af[mt][0] = pack_bf16(leaky(v00.x, a.slope), leaky(v00.y, a.slope));
              af[mt][1] = pack_bf16(leaky(v10.x, a.slope), leaky(v10.y, a.slope));
              af[mt][2] = pack_bf16(leaky(v01.x, a.slope), leaky(v01.y, a.slope));
              af[mt][3] = pack_bf16(leaky(v11.x, a.slope), leaky(v11.y, a.slope));
            } else {
              const __nv_bfloat16* p0 = ms + (rr[mt][0] + off) * a.ldm + c0;
              const __nv_bfloat16* p1 = ms + (rr[mt][1] + off) * a.ldm + c0;
              af[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
              af[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
              af[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
              af[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma16816(acc[0][nt], af[0], bv[nt].x, bv[nt].y);
            mma16816(acc[1][nt], af[1], bv[nt].x, bv[nt].y);
          }
        } else {
          // A: rows (gr, gr+8), c_in 8 kc + (q, q+4)
          uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 v = __ldg(wk + ((size_t)kc * n_nt + nt) * 32);
            split_tf32(v.x, bb[nt][0], bs[nt][0]);
            split_tf32(v.y, bb[nt][1], bs[nt][1]);
          }
          const int c0 = kc * 8 + q;
          const float* src = CONV1 ? ys : ms;
          const int ld = CONV1 ? a.ldy : a.ldm;
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* p0 = src + (rr[mt][0] + off) * ld + c0;
            const float* p1 = src + (rr[mt][1] + off) * ld + c0;
            float v[4] = {p0[0], p1[0], p0[4], p1[4]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (CONV1) v[e] = leaky(v[e], a.slope);
              split_tf32(v[e], ab[mt][e], as[mt][e]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma1688(acc[mt][nt], as[mt], bb[nt][0], bb[nt][1]);
              mma1688(acc[mt][nt], ab[mt], bs[nt][0], bs[nt][1]);
              mma1688(acc[mt][nt], ab[mt], bb[nt][0], bb[nt][1]);
            }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + mt * 16 + h * 8 + gr;
        if (row >= hi) continue;
        const int g = g0 + row;
        const bool inside = g >= 0 && g < a.length;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = n0 + nt * 8 + 2 * q;
          const float v0 = acc[mt][nt][2 * h] + b[col];
          const float v1 = acc[mt][nt][2 * h + 1] + b[col + 1];
          if (CONV1) {
            const float m0 = leaky(inside ? v0 : 0.f, a.slope);
            const float m1 = leaky(inside ? v1 : 0.f, a.slope);
            if constexpr (BF16)
              *reinterpret_cast<uint32_t*>(ms + row * a.ldm + col) =
                  pack_bf16(m0, m1);
            else
              *reinterpret_cast<float2*>(ms + row * a.ldm + col) =
                  make_float2(m0, m1);
          } else {
            float2* p = reinterpret_cast<float2*>(ys + row * a.ldy + col);
            const float2 y = *p;
            const float2 y2 = make_float2(inside ? y.x + v0 : 0.f,
                                          inside ? y.y + v1 : 0.f);
            if (FINAL) {
              sum[mt][nt][2 * h] += y2.x;
              sum[mt][nt][2 * h + 1] += y2.y;
            } else {
              *p = y2;
            }
          }
        }
      }
  }
}

// The mean over a.n_chains chains, summed in registers; needs
// tile == kWM * kWarps / (C / (8 * NT)).
template <bool BF16, typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
stage_kernel(const T* __restrict__ x, T* __restrict__ out,
             const typename Ops<BF16>::W* __restrict__ w,
             const float* __restrict__ b, Args a) {
  using M = typename Ops<BF16>::M;
  extern __shared__ float4 smem[];
  const int C = a.channels, T_len = a.length;
  const int rows_total = a.tile + 2 * a.halo;
  float* ys = reinterpret_cast<float*>(smem);
  M* ms = reinterpret_cast<M*>(ys + (size_t)rows_total * a.ldy);
  const int t0 = blockIdx.x * a.tile;
  const int g0 = t0 - a.halo;  // global time of buffer row 0
  const T* xb = x + (size_t)blockIdx.y * C * T_len;
  T* ob = out + (size_t)blockIdx.y * C * T_len;

  float sum[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;

  // K * C * C weights per conv, 4 (bf16) or 2 (f32) in each fragment entry
  const typename Ops<BF16>::W* wc = w;
  const float* bc = b;
  for (int chain = 0; chain < a.n_chains; ++chain) {
    const int K = a.ks[chain];
    const int hk = (K - 1) / 2;
    const size_t conv_frags = (size_t)K * C * C / (BF16 ? 4 : 2);
    int rem = 0;
    for (int i = 0; i < a.n_dil; ++i) rem += hk * (a.dil[i] + 1);
    // load the rows this chain reads, zero outside [0, T)
    const int lo = a.halo - rem;
    const int n_rows = a.tile + 2 * rem;
    for (int idx = threadIdx.x; idx < n_rows * C; idx += kThreads) {
      const int r = lo + idx % n_rows;
      const int c = idx / n_rows;
      const int g = g0 + r;
      ys[r * a.ldy + c] =
          (g >= 0 && g < T_len) ? load_value(xb + (size_t)c * T_len + g) : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < a.n_dil; ++i) {
      rem -= hk * a.dil[i];
      conv<BF16, NT, true, false>(ys, ms, wc, bc, K, a.dil[i], a.halo - rem,
                                  a.halo + a.tile + rem, g0, a, sum);
      __syncthreads();
      wc += conv_frags;
      bc += C;
      rem -= hk;
      if (i == a.n_dil - 1)
        conv<BF16, NT, false, true>(ys, ms, wc, bc, K, 1, a.halo - rem,
                                    a.halo + a.tile + rem, g0, a, sum);
      else
        conv<BF16, NT, false, false>(ys, ms, wc, bc, K, 1, a.halo - rem,
                                     a.halo + a.tile + rem, g0, a, sum);
      __syncthreads();
      wc += conv_frags;
      bc += C;
    }
  }

  {
    // the mean over chains, staged through y's rows for a coalesced store
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int ncg = C / (NT * 8);
    const int r0 = a.halo + (warp / ncg) * kWM;
    const int n0 = (warp % ncg) * NT * 8;
    const float inv = 1.f / (float)a.n_chains;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int row = r0 + mt * 16 + h * 8 + lane / 4;
          const int col = n0 + nt * 8 + 2 * (lane % 4);
          *reinterpret_cast<float2*>(ys + row * a.ldy + col) = make_float2(
              sum[mt][nt][2 * h] * inv, sum[mt][nt][2 * h + 1] * inv);
        }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < a.tile * C; idx += kThreads) {
    const int r = idx % a.tile;
    const int c = idx / a.tile;
    if (t0 + r < T_len)
      store_value(ob + (size_t)c * T_len + t0 + r, ys[(a.halo + r) * a.ldy + c]);
  }
}

template <bool BF16, typename T, int NT>
cudaError_t launch(const void* x, void* out, const void* w, const float* b,
                   int batch, const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(a.tile + 2 * a.halo) *
                      (sizeof(float) * a.ldy +
                       sizeof(typename Ops<BF16>::M) * a.ldm);
  auto kernel = stage_kernel<BF16, T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.length + a.tile - 1) / a.tile, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const typename Ops<BF16>::W*>(w), b, a);
  return cudaGetLastError();
}

template <bool BF16, typename T>
cudaError_t launch_nt(int nt, const void* x, void* out, const void* w,
                      const float* b, int batch, const Args& a,
                      cudaStream_t stream) {
  switch (nt) {
    case 8: return launch<BF16, T, 8>(x, out, w, b, batch, a, stream);
    case 4: return launch<BF16, T, 4>(x, out, w, b, batch, a, stream);
    case 2: return launch<BF16, T, 2>(x, out, w, b, batch, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One decoder stage tail on x [B, C, T] -> out: the mean over n_chains
// chains of kernel sizes ks; tile must be 32 * 8 / (C / (8 * nt)) rows.
// bf16: x and out bf16 and bf16 dot operands; else f32 I/O and 3xTF32.
// nt in {2, 4, 8}: channel tiles of 8 per warp item; C a multiple of 8 * nt
// and of 16. w: B fragments packed by the wrapper
// (ops/resblock.py:_pack_fragments); b f32 [n_convs][C].
int rvc_resblock_stage(const void* x, void* out, const void* w, const float* b,
                       int batch, int channels, int length, int tile, int nt,
                       int n_chains, const int* ks, int n_dil, const int* dil,
                       float slope, int bf16, void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || n_dil < 1 || n_dil > kMaxDil ||
      (nt != 2 && nt != 4 && nt != 8) || channels % (8 * nt) != 0 ||
      channels % 16 != 0 || tile < 1 || length < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  if (tile * (channels / (8 * nt)) != kWM * kWarps)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.channels = channels;
  a.length = length;
  a.tile = tile;
  a.n_chains = n_chains;
  a.n_dil = n_dil;
  a.slope = slope;
  a.halo = 0;
  for (int c = 0; c < kMaxChains; ++c) a.ks[c] = c < n_chains ? ks[c] : 1;
  for (int i = 0; i < kMaxDil; ++i) a.dil[i] = i < n_dil ? dil[i] : 1;
  for (int c = 0; c < n_chains; ++c) {
    int h = 0;
    for (int i = 0; i < n_dil; ++i) h += (ks[c] - 1) / 2 * (dil[i] + 1);
    if (h > a.halo) a.halo = h;
  }
  // rows padded so the fragment loads of a warp hit distinct banks
  a.ldy = channels + (bf16 ? 8 : 4);
  a.ldm = a.ldy;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_nt<true, __nv_bfloat16>(nt, x, out, w, b, batch, a, st)
                    : launch_nt<false, float>(nt, x, out, w, b, batch, a, st));
}

}  // extern "C"
