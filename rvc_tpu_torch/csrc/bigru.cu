// RMVPE's bidirectional GRU recurrence on Hopper: kernel G `bigru`.
//
// Replaces no Pallas kernel: it is the card's counterpart of the one
// jax.lax.scan of rvc_tpu/predictors/rmvpe.py FusedBiGRU (:192-239), which
// XLA compiles into one on-device loop with the cell fused. Both directions
// of the recurrence over input projections computed outside (x @ wi + bi,
// :218-219, torch.matmul in the port):
//
//   g = h @ Wh                                   [rows, 3H], summed in f32
//   r = sigmoid(xi_r + g_r), z = sigmoid(xi_z + g_z)
//   n = tanh(xi_n + r * (g_n + b_hn)),  h = (1 - z) * n + z * h
//
// in f32, with the carry h rounded to the I/O dtype after every step as
// JAX's carry (h0 in x.dtype, :235). The backward direction reads its rows
// of xi in reverse time order and writes its outputs un-reversed: out
// [B, T, 2H] holds the forward direction in [..., :H], the backward in
// [..., H:].
//
// What bounds it on the card: latency. A step is one product of a [rows, H]
// vector by [H, 3H], then the gates, and the next step needs all of this
// one's h. At H = 256 and one row that is 0.4 MFLOP a step, a few hundred
// nanoseconds of one SM; the bytes (Wh once, xi and out once) are 7.5 MB
// for a 10 s input. So the design keeps everything a step needs on chip
// and makes the step's critical path short:
//
// - One cluster of `cluster` blocks per (direction, group of up to `rows`
//   batch rows), all in one launch. Block q of a cluster owns the hidden
//   units [q * units, (q + 1) * units) and the three columns of Wh that
//   feed each (r, z, n).
// - A unit is computed by `ks` consecutive lanes (a power of two), each
//   summing a k-slice of the product: 4-wide chunks c = ks_lane + ks * j of
//   h, read as float4 from shared memory (the units of a warp read the same
//   addresses), and the sums joined by xor shuffles, so every lane of the
//   unit holds g and computes the gates.
// - Wh stays in registers for the whole sequence where it fits (KPT > 0:
//   KPT weights per gate a thread, f32 for either I/O dtype: the compiler
//   hoists a bf16 weight's conversion out of the step loop, so packing
//   them saves no register), and is read from memory (L1 / L2) every step
//   where it does not (KPT = 0, any H; a thread then takes several units
//   one after another). ops/bigru.py's planner picks the geometry.
// - Every block keeps the whole h of its rows, f32, double-buffered in
//   shared memory. After a step each unit's lanes store the new h into
//   every block of the cluster by st.async (distributed shared memory),
//   each store counting its 4 bytes on the receiving block's mbarrier of
//   that buffer; a block arms the mbarrier for H * rows * 4 bytes and
//   waits on it at the top of the step that reads the buffer. No barrier
//   passes a step: a block writes buffer (s + 1) & 1 in step s only after
//   it received every unit's h of step s - 1, which each thread sent after
//   its last read of that buffer. Measured against a cluster barrier a
//   step (st.shared::cluster, barrier.cluster arrive / wait), the
//   exchange-only floor fell from about 1.0 to 0.4 us a step (PERF.md).
//   A lone block writes its own buffer and passes __syncthreads.
// - xi of the next D - 1 steps is in flight in registers (D = 4 for one
//   row, 2 for more).
// - `exchange_only` (for measuring the latency floor) skips the product
//   and the gates and keeps the loads and the exchange.

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kRegOther = 56;  // ops/bigru.py REG_OTHER

struct Args {
  const void* xi[2];  // [B, T, 3H] per direction, I/O dtype
  const void* wh;     // [2, H, 3H]
  const void* bn;     // [2, H]
  void* out;          // [B, T, 2H]
  int batch, steps, hidden;
  int cluster, units, ks, kchunks, kp;
  int exchange_only;
};

template <typename IO>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const void* p, size_t i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  static __device__ __forceinline__ void store(void* p, size_t i, float v) {
    static_cast<float*>(p)[i] = v;
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const void* p, size_t i) {
    return __uint_as_float(static_cast<uint32_t>(
                               __ldg(static_cast<const unsigned short*>(p) + i))
                           << 16);
  }
  static __device__ __forceinline__ void store(void* p, size_t i, float v) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// Steps of xi a thread keeps in flight (registers: 3 a row and step).
template <int RM>
__host__ __device__ constexpr int prefetch_depth() {
  return RM == 1 ? 4 : 2;
}

// Registers a thread needs (the weights, per row 3 sums, the prefetched
// xi and the new h, kRegOther), and so the most threads a block of this
// instantiation may have: ptxas allocates for whole groups of 128 threads
// (ops/bigru.py max_threads).
template <int KPT, int RM>
constexpr int max_threads() {
  const int need = (3 * KPT + (4 + 3 * prefetch_depth<RM>()) * RM + kRegOther + 7) / 8 * 8;
  const int t = 65536 / need / 128 * 128;
  return t > 1024 ? 1024 : t;
}

// A store into a block of the cluster that counts its 4 bytes on the
// mbarrier `bar` over there (both addresses from map_to_rank).
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + __expf(-x)); }

// The ks lanes of a unit: their partial sums joined, every lane gets the sum.
template <int RM>
__device__ __forceinline__ void reduce(float (&acc)[RM][3], int ks) {
  for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[r][g] += __shfl_xor_sync(0xffffffffu, acc[r][g], off);
  }
}

// xi of unit u at step s for the block's rows (0 where a row, the unit or
// the step does not exist).
template <typename IO, int RM>
__device__ __forceinline__ void load_x(const Args& a, const void* xi, int row0, int u,
                                       bool unit_ok, int s, int dir, float (&x)[RM][3]) {
  const int p = dir ? a.steps - 1 - s : s;
  const int h3 = 3 * a.hidden;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const bool ok = unit_ok && s < a.steps && row0 + r < a.batch;
    const size_t base = ((size_t)(row0 + r) * a.steps + p) * h3 + u;
#pragma unroll
    for (int g = 0; g < 3; ++g) x[r][g] = ok ? Io<IO>::load(xi, base + (size_t)g * a.hidden) : 0.0f;
  }
}

// The cell for the block's rows of unit u: h_new[r], rounded to the I/O
// dtype. hb: this step's h (f32, row stride kp).
template <typename IO, int RM>
__device__ __forceinline__ void cell(const Args& a, const float (&acc)[RM][3],
                                     const float (&x)[RM][3], float bn, const float* hb,
                                     int u, float (&hn)[RM]) {
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float h;
    if (a.exchange_only) {
      h = x[r][0];
    } else {
      const float rg = sigmoid(x[r][0] + acc[r][0]);
      const float zg = sigmoid(x[r][1] + acc[r][1]);
      const float ng = tanhf(x[r][2] + rg * (acc[r][2] + bn));
      h = (1.0f - zg) * ng + zg * hb[r * a.kp + u];
    }
    hn[r] = Io<IO>::round(h);
  }
}

// The exchange of h between the blocks of a cluster (see the head of the
// file); a lone block writes its own buffer and passes __syncthreads.
struct Exchange {
  float* hbuf;      // [2][RM][kp]
  uint64_t* full;   // [2]: the mbarriers of the two buffers
  bool cluster;     // more than one block
  uint32_t bytes;   // H * RM * 4: what a block receives a step

  // the top of step s: the buffer of step s is complete
  __device__ __forceinline__ void begin(const Args& a, int s) const {
    if (!cluster || s == 0) return;
    mbar_wait_cluster(smem_addr(full + (s & 1)), ((s - 1) >> 1) & 1);
    // armed again for h of step s + 1, which lands in this buffer
    if (threadIdx.x == 0 && s + 1 <= a.steps - 2) mbar_arrive_expect_tx(full + (s & 1), bytes);
  }

  // h of unit u (RM rows) into every block's buffer of step s + 1; the
  // unit's ks lanes take the blocks in turn
  template <int RM>
  __device__ __forceinline__ void send(const Args& a, int s, int u, int lane_k,
                                       const float (&hn)[RM]) const {
    float* nb = hbuf + ((s + 1) & 1) * RM * a.kp;
    if (!cluster) {
      if (lane_k == 0)
#pragma unroll
        for (int r = 0; r < RM; ++r) nb[r * a.kp + u] = hn[r];
      return;
    }
    for (int peer = lane_k; peer < a.cluster; peer += a.ks) {
      const uint32_t base = map_to_rank(smem_addr(nb + u), peer);
      const uint32_t bar = map_to_rank(smem_addr(full + ((s + 1) & 1)), peer);
#pragma unroll
      for (int r = 0; r < RM; ++r) st_async(base + 4u * r * a.kp, hn[r], bar);
    }
  }

  // the end of step s (not the last)
  __device__ __forceinline__ void end() const {
    if (!cluster) __syncthreads();
  }
};

template <typename IO, int RM>
__device__ __forceinline__ void store_out(const Args& a, int row0, int u, int s, int dir,
                                          const float (&hn)[RM]) {
  const int p = dir ? a.steps - 1 - s : s;
#pragma unroll
  for (int r = 0; r < RM; ++r)
    if (row0 + r < a.batch)
      Io<IO>::store(a.out, ((size_t)(row0 + r) * a.steps + p) * 2 * a.hidden +
                               (size_t)dir * a.hidden + u, hn[r]);
}

template <typename IO, int KPT, int RM>
__global__ void __launch_bounds__(max_threads<KPT, RM>())
    bigru_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);  // [2][RM][kp], f32
  const int tid = threadIdx.x;
  const int cs = a.cluster;
  const int rank = blockIdx.x % cs;
  const int cid = blockIdx.x / cs;
  const int dir = cid & 1, row0 = (cid >> 1) * RM;
  const int lane_k = tid % a.ks;
  const int unit0 = rank * a.units;
  const int unit_end = min(unit0 + a.units, a.hidden);
  const int hh3 = 3 * a.hidden;
  const void* xi = a.xi[dir];
  const size_t wbase = (size_t)dir * a.hidden * hh3;
  const Exchange ex = {hbuf, reinterpret_cast<uint64_t*>(hbuf + 2 * RM * a.kp), cs > 1,
                       (uint32_t)(a.hidden * RM * 4)};

  for (int i = tid; i < 2 * RM * a.kp; i += blockDim.x) hbuf[i] = 0.0f;
  if (ex.cluster && tid == 0) {
    mbar_init(ex.full, 1);
    mbar_init(ex.full + 1, 1);
    mbar_init_fence();
    // armed for h of steps 0 and 1
    if (a.steps >= 2) mbar_arrive_expect_tx(ex.full + 1, ex.bytes);
    if (a.steps >= 3) mbar_arrive_expect_tx(ex.full, ex.bytes);
  }
  if (cs > 1) {
    cluster_sync();  // buffers zero and barriers armed before a peer writes
  } else {
    __syncthreads();
  }

  if constexpr (KPT > 0) {
    // one unit a thread, its weights in registers for the whole sequence,
    // xi of the next D - 1 steps in flight
    constexpr int D = prefetch_depth<RM>();
    const int u = unit0 + tid / a.ks;
    const bool ok = u < unit_end;
    float W[3][KPT];
#pragma unroll
    for (int j = 0; j < KPT / 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int k = 4 * (lane_k + a.ks * j) + v;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          W[g][4 * j + v] = ok && k < a.hidden
                                ? Io<IO>::load(a.wh, wbase + (size_t)k * hh3 + g * a.hidden + u)
                                : 0.0f;
      }
    const float bn = ok ? Io<IO>::load(a.bn, (size_t)dir * a.hidden + u) : 0.0f;
    float xr[D][RM][3], hn[RM];
#pragma unroll
    for (int d = 0; d < D - 1; ++d) load_x<IO, RM>(a, xi, row0, u, ok, d, dir, xr[d]);
    for (int s0 = 0; s0 < a.steps; s0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int s = s0 + d;
        if (s >= a.steps) break;
        load_x<IO, RM>(a, xi, row0, u, ok, s + D - 1, dir, xr[(d + D - 1) % D]);
        ex.begin(a, s);
        const float* hb = hbuf + (s & 1) * RM * a.kp;
        float acc[RM][3] = {};
        if (!a.exchange_only) {
#pragma unroll
          for (int j = 0; j < KPT / 4; ++j) {
            const int c = lane_k + a.ks * j;
#pragma unroll
            for (int r = 0; r < RM; ++r) {
              const float4 h4 = *reinterpret_cast<const float4*>(hb + r * a.kp + 4 * c);
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                float t = acc[r][g];
                t = fmaf(h4.x, W[g][4 * j], t);
                t = fmaf(h4.y, W[g][4 * j + 1], t);
                t = fmaf(h4.z, W[g][4 * j + 2], t);
                acc[r][g] = fmaf(h4.w, W[g][4 * j + 3], t);
              }
            }
          }
          reduce<RM>(acc, a.ks);
        }
        if (ok) {
          cell<IO, RM>(a, acc, xr[d], bn, hb, u, hn);
          if (s + 1 < a.steps) ex.send<RM>(a, s, u, lane_k, hn);
          if (lane_k == 0) store_out<IO, RM>(a, row0, u, s, dir, hn);
        }
        if (s + 1 < a.steps) ex.end();
      }
    }
  } else {
    // weights read from memory every step; a thread takes the units
    // tid / ks, + slots, ... of the block in passes (as many for every
    // thread: the shuffles need whole warps)
    const int slots = blockDim.x / a.ks;
    const int passes = (a.units + slots - 1) / slots;
    for (int s = 0; s < a.steps; ++s) {
      ex.begin(a, s);
      const float* hb = hbuf + (s & 1) * RM * a.kp;
      for (int pass = 0; pass < passes; ++pass) {
        const int u = unit0 + pass * slots + tid / a.ks;
        const bool ok = u < unit_end;
        float x[RM][3], hn[RM];
        load_x<IO, RM>(a, xi, row0, u, ok, s, dir, x);
        float acc[RM][3] = {};
        if (!a.exchange_only) {
          for (int j = 0; j < a.kchunks; ++j) {
            const int c = lane_k + a.ks * j;
            float w[3][4];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int k = 4 * c + v;
#pragma unroll
              for (int g = 0; g < 3; ++g)
                w[g][v] = ok && k < a.hidden
                              ? Io<IO>::load(a.wh, wbase + (size_t)k * hh3 + g * a.hidden + u)
                              : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < RM; ++r) {
              const float4 h4 = *reinterpret_cast<const float4*>(hb + r * a.kp + 4 * c);
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                float t = acc[r][g];
                t = fmaf(h4.x, w[g][0], t);
                t = fmaf(h4.y, w[g][1], t);
                t = fmaf(h4.z, w[g][2], t);
                acc[r][g] = fmaf(h4.w, w[g][3], t);
              }
            }
          }
          reduce<RM>(acc, a.ks);
        }
        if (ok) {
          const float bn = Io<IO>::load(a.bn, (size_t)dir * a.hidden + u);
          cell<IO, RM>(a, acc, x, bn, hb, u, hn);
          if (s + 1 < a.steps) ex.send<RM>(a, s, u, lane_k, hn);
          if (lane_k == 0) store_out<IO, RM>(a, row0, u, s, dir, hn);
        }
      }
      if (s + 1 < a.steps) ex.end();
    }
  }
  // st.async: no block leaves while a peer's stores into it may be in flight
  if (ex.cluster) cluster_sync();
}

template <typename IO, int KPT, int RM>
cudaError_t launch(const Args& a, int groups, int threads, cudaStream_t stream) {
  if (threads > max_threads<KPT, RM>()) return cudaErrorInvalidValue;
  auto* kernel = bigru_kernel<IO, KPT, RM>;
  const int smem = 2 * RM * a.kp * 4 + 16;  // h, and the mbarriers full[2]
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.cluster * 2 * groups);
  if (a.cluster == 1) {
    kernel<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  if (a.cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename IO, int KPT>
cudaError_t launch_rows(const Args& a, int rows, int groups, int threads, cudaStream_t st) {
  switch (rows) {
    case 1: return launch<IO, KPT, 1>(a, groups, threads, st);
    case 4: return launch<IO, KPT, 4>(a, groups, threads, st);
    default: return launch<IO, KPT, 8>(a, groups, threads, st);
  }
}

template <typename IO>
cudaError_t launch_io(const Args& a, int kpt, int rows, int groups, int threads,
                      cudaStream_t st) {
  switch (kpt) {
    case 16: return launch_rows<IO, 16>(a, rows, groups, threads, st);
    case 32: return launch_rows<IO, 32>(a, rows, groups, threads, st);
    default: return launch_rows<IO, 0>(a, rows, groups, threads, st);
  }
}

}  // namespace

extern "C" {

// Both directions of a GRU recurrence, one launch: xi_f, xi_b [B, T, 3H]
// (the input projections with the folded biases, the backward's in time
// order), wh [2, H, 3H], bn [2, H] (b_hn), all of one dtype (io_bf16: bf16,
// else f32), contiguous -> out [B, T, 2H]. The geometry comes from
// ops/bigru.py:plan: `cluster` blocks per (direction, group of `rows` batch
// rows), `units` hidden units a block, `ks` lanes a unit, `kpt` weights per
// gate a thread in registers (16 or 32; 0: read from memory every step, in
// `kchunks` 4-wide chunks a lane), `threads` a block. exchange_only: the
// loads and the exchange alone (the latency floor).
int rvc_bigru(const void* xi_f, const void* xi_b, const void* wh, const void* bn, void* out,
              int io_bf16, int batch, int steps, int hidden, int cluster, int units, int ks,
              int kpt, int kchunks, int rows, int threads, int exchange_only, void* stream) {
  const int hp = (hidden + 3) / 4 * 4;
  const bool pow2_cluster = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
                            cluster == 16;
  if (batch < 1 || steps < 1 || hidden < 1 || !pow2_cluster || ks < 1 || ks > 32 ||
      (ks & (ks - 1)) || (rows != 1 && rows != 4 && rows != 8) ||
      (kpt != 0 && kpt != 16 && kpt != 32) || units < 1 || units * cluster < hidden ||
      threads < 32 || threads % 32 || threads < ks || kchunks < 1 ||
      4 * ks * kchunks < hp || (kpt > 0 && (kchunks != kpt / 4 || units * ks > threads)))
    return (int)cudaErrorInvalidValue;
  const int groups = (batch + rows - 1) / rows;
  if ((long long)cluster * 2 * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.xi[0] = xi_f;
  a.xi[1] = xi_b;
  a.wh = wh;
  a.bn = bn;
  a.out = out;
  a.batch = batch;
  a.steps = steps;
  a.hidden = hidden;
  a.cluster = cluster;
  a.units = units;
  a.ks = ks;
  a.kchunks = kchunks;
  a.kp = 4 * ks * kchunks;
  a.exchange_only = exchange_only;
  if (2LL * rows * a.kp * 4 + 16 > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(io_bf16 ? launch_io<__nv_bfloat16>(a, kpt, rows, groups, threads, st)
                       : launch_io<float>(a, kpt, rows, groups, threads, st));
}

}  // extern "C"
