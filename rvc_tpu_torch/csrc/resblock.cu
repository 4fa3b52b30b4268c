// HiFi-GAN decoder stage tails on Hopper: kernel K1 `mrf_stage`. (K2
// `resblock_chain`, the one-chain f32 kernel of the wide stages, is
// resblock_chain.cu.)
//
// Replaces the TPU kernel rvc_tpu/ops/resblock_pallas.py fused_mrf
// (_fused_mrf_impl, pallas_call at :437): the mean over the parallel
// ResBlock chains of one decoder stage. A chain is, per dilation d:
//   m = mask * (b1 + conv_d(leaky(y)));  y = mask * (y + b2 + conv_1(leaky(m))),
// bf16 x bf16 -> f32 products, the state y and every sum in f32; mask zeroes
// the rows outside [0, T) after every conv, as the direct convs' zero
// padding requires.
//
// What bounds it on the card: operations. A stage of three chains
// (k = 3, 7, 11, three dilations) runs 2 * 126 * C^2 * T FLOP (1.4e12 over
// the three stages of one 10 s 48 kHz conversion: 1.4 ms at 989 TFLOP/s
// bf16) against 2 bytes in and 2 bytes out per sample and channel. The
// weights are small (K * C^2 * 2 bytes a conv, 4.1 MB a stage at C = 128)
// but every block needs all of them, so what a block pulls from L2 per row
// it computes is the second thing the design watches.
//
// What the design does about it. Time is the M side of the product (64
// rows a warpgroup product) and C_out the N side (N = C: 16, 32, 64, 128),
// wgmma m64nNk16 with both operands from shared memory:
//
//   activations: two bf16 planes [time][channel] in wgmma.cuh's layout (a)
//     (16-byte depth groups of 8 channels). A1 holds leaky(y), A2 holds
//     leaky(m). A conv tap is a row offset of the descriptor's start
//     address, so one plane serves all K taps; 32 guard rows above and
//     below take the taps that reach past the block's rows (so no tap may
//     reach further: k = 11, d = 5 reaches 25).
//   state: y lives in REGISTERS, as conv_1's accumulator. Two consumer
//     warpgroups own 256 / C bands of 64 rows each (128 f32 registers a
//     thread at every width), so a block holds R = 32768 / C rows: 256 at
//     C = 128, 512 at 64, 1024 at 32. Shared memory then holds only the two
//     planes and the weight ring; an f32 copy of y beside them would cut R
//     to 160 rows at C = 128. conv_1 starts from y + b2 and leaves the new y
//     in place; its epilogue masks y and writes bf16(leaky(y)) to A1.
//     conv_d accumulates into 64 more registers, two passes of 128 / C
//     bands each, and its epilogue writes bf16(leaky(m)) to A2: leaky and
//     the rounding happen once per element. The consumers run at 240
//     registers (setmaxnreg; the producer's warpgroup gives its own up), and
//     their code is kept free of anything else that lives long: ptxas
//     spills accumulators at the least excuse.
//   clusters: every conv computes all rows of the buffer; the rows within
//     `halo` of its ends (60 for k = 11, d = 1, 3, 5) come out wrong and are
//     not stored. One block alone would store 136 of 256 rows at C = 128.
//     So the 2 blocks of a cluster (C = 128, 64) hold consecutive runs of
//     rows of ONE buffer of 2 R rows, and after each conv one thread of
//     the producer's warpgroup sends the block's first and last 32 rows of
//     the plane just written into the neighbours' guard rows (bulk copies
//     through distributed shared memory that complete on the neighbour's
//     mbarrier: see ConvBarrier). A cluster computes 1.31x / 1.13x the rows
//     it stores at C = 128 / 64, the lone block at C = 32 1.13x.
//   weights: packed by the wrapper as ready shared-memory images, per conv
//     [tap][C_in / 8][C_out][8] bf16 (K-major as the product reads them),
//     streamed in 16 KB ring stages (half a tap at C = 128, 2 taps at 64,
//     8 at 32) by one producer thread, one cp.async.bulk + mbarrier each,
//     4 or 5 stages in flight, and read by both consumer warpgroups: a
//     block fetches each conv_1 once and each conv_d twice (once per pass),
//     6.2 MB a work item at C = 128, and the stream hides under the
//     products.
//   blocks are persistent: as many clusters as the card holds walk over
//     the (batch, tile) work items, so the weight stream runs ahead across
//     tiles, and the sum over chains waits in a per-block f32 scratch
//     (thread-private, coalesced, 128 KB a block: it stays in L2) while the
//     next chain uses the registers.
//   x is read and the output written straight from the accumulator
//     fragments ([C, T] with T contiguous: 8 lanes cover 8 neighbouring
//     time steps of one channel); all of a chain's loads are issued before
//     the first is used.
//
// Layout: x and out are [B, C, T] contiguous, bf16. Weights are ordered
// chain-major, conv_d then conv_1 per dilation; biases f32 [n_convs][C].
//
// Ablation switches, for timing only (rvc_tpu_torch/tools/mrf_ablation.py;
// the results are wrong with any of them): -DMRF_ABLATE_PRODUCTS issues no
// wgmma, -DMRF_ABLATE_COPIES copies no weights (the barriers still cycle),
// -DMRF_ABLATE_EPILOGUE skips the masks, leaky and plane stores after each
// conv, -DMRF_ABLATE_IO reads no x and writes no output or scratch
// (-DMRF_ABLATE_LOAD, _SCRATCH, _STORE: each of the three alone;
// -DMRF_ABLATE_RELOAD reads x for a tile's first chain only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = 384;    // and the producer's warpgroup
constexpr int kStageBytes = 16384;
constexpr int kMaxStages = 8;
constexpr int kGuard = 32;  // guard rows above and below each plane
constexpr int kMaxChains = 4;
constexpr int kMaxDil = 4;

struct Args {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const unsigned char* w;  // packed weight images, conv after conv
  const float* bias;       // [n_convs][C]
  float* scratch;          // [grid][128][256] f32: the sum over chains
  int batch, length, n_tiles;
  int cluster;             // blocks of a cluster
  int tile, halo, stages;  // tile: rows the CLUSTER stores per work item
  int n_chains, n_dil;
  int ks[kMaxChains];
  int dil[kMaxDil];
  float slope;
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// No memory clobber: the planes are written and read by asm only (the
// consumers' barrier orders them), and global loads may move across.
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// The barrier after a conv, and the exchange of edge rows in a cluster.
// The blocks of a cluster hold consecutive runs of rows of one buffer, and
// a conv's taps reach up to kGuard rows into the neighbours' rows: after a
// conv has written a plane, each block's first and last kGuard rows must be
// in its neighbours' guard rows before the next conv starts. One thread of
// the producer's warpgroup (the "exchange thread") does that with bulk
// copies through distributed shared memory, so the consumers' code holds
// no access to a neighbour (a store into a neighbour's shared memory from
// the consumers makes ptxas serialise every wgmma of the kernel, C7520, and
// loads cost registers that are not there):
//
//   written[i] (8 arrivals): every consumer warp arrives when its rows of
//     the plane are written (and fenced for the async proxy).
//   ready[i] (9 arrivals + bytes): the consumer warps arrive here too, and
//     wait here. The exchange thread arrives once with the bytes the
//     neighbours will send (kGuard rows x C x 2 each), waits for
//     written[i], and sends this block's edge rows, one 512-byte copy per
//     depth group and neighbour, to complete on the neighbour's ready[i].
//
// i alternates between two pairs of barriers, so that a neighbour one conv
// ahead counts on the other pair. All a consumer thread keeps is the count
// of barriers passed.
struct ConvBarrier {
  uint32_t count;

  // bars: shared address of written[0], written[1], ready[0], ready[1]
  __device__ __forceinline__ void sync(uint32_t bars, int lane) {
    fence_async_proxy();  // this thread's plane writes -> wgmma, bulk copies
    __syncwarp();
    const uint32_t i = 8 * (count & 1);
    // lane 0 arrives, under a predicate: no branch between the products
    mbar_arrive_if(bars + i, lane == 0);
    mbar_arrive_if(bars + 16 + i, lane == 0);
    mbar_wait_cluster(bars + 16 + i, (count >> 1) & 1);
    ++count;
  }
};

// Position in the weight ring, kept alike by the producer and by every
// consumer warp.
struct Ring {
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Ablation only: a use of the accumulators that costs one add each, so
// that the products whose epilogue is compiled out are not dropped.
template <int N>
__device__ __forceinline__ void keep_alive(const float (&d)[N], uint32_t addr) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) sum += d[i];
  if (sum == 1.2345e30f) st_shared(addr, 0);
}

// A store under a predicate and not under a branch: the accumulators are
// read in straight-line code.
__device__ __forceinline__ void store_if(__nv_bfloat16* p, float v, int ok) {
  const __nv_bfloat16 b = __float2bfloat16(v);
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.b16 [%0], %1;\n}\n" ::"l"(p),
               "h"(*reinterpret_cast<const unsigned short*>(&b)), "r"(ok)
               : "memory");
}

// The chain's start: y = x on the thread's rows (zero outside [0, T)) and
// A1 = bf16(leaky(y)). x: the batch row's channel 2 * qd; g0: the time of
// the thread's row 0; slot: the thread's 4 bytes in its row 0, depth group
// 0 of A1.
// No branch defines the accumulators: a clamped load, then a select.
template <int C>
__device__ __forceinline__ void load_state(float (&y)[256 / C][C / 2],
                                           const __nv_bfloat16* x, int T, int g0,
                                           uint32_t slot, float slope) {
  constexpr uint32_t rows16 = (32768 / C + 2 * kGuard) * 16;
  // every load is issued before the first value is used
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const __nv_bfloat16* x0 = x + (size_t)(8 * j) * T;
    const __nv_bfloat16* x1 = x0 + T;
#pragma unroll
    for (int lb = 0; lb < 256 / C; ++lb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = g0 + 128 * lb + 8 * h;
        const bool inside = t >= 0 && t < T;
        const int tc = min(max(t, 0), T - 1);
        y[lb][4 * j + 2 * h] = inside ? __bfloat162float(x0[tc]) : 0.f;
        y[lb][4 * j + 2 * h + 1] = inside ? __bfloat162float(x1[tc]) : 0.f;
      }
  }
#pragma unroll
  for (int lb = 0; lb < 256 / C; ++lb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
        st_shared(slot + j * rows16 + (128 * lb + 8 * h) * 16,
                  pack_bf16(leaky(y[lb][4 * j + 2 * h], slope),
                            leaky(y[lb][4 * j + 2 * h + 1], slope)));
}

// out = y * inv on the thread's rows [r_lo, r_hi) that lie before T.
template <int C>
__device__ __forceinline__ void store_mean(const float (&y)[256 / C][C / 2],
                                           __nv_bfloat16* out, int T, int g0, int r_lo,
                                           int r_hi, float inv) {
#pragma unroll
  for (int lb = 0; lb < 256 / C; ++lb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 128 * lb + 8 * h;
      const int t = g0 + r;
      const int ok = r >= r_lo && r < r_hi && t < T;
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store_if(out + (size_t)(8 * j + e) * T + t, y[lb][4 * j + 2 * h + e] * inv, ok);
    }
}

// acc[g] += conv over NB bands of 64 rows, 128 rows apart: for every tap
// and 16-channel depth step one product per band, the weights from the ring
// as their 16 KB stages arrive. a_desc: the plane at the first band's first
// row, tap offset 0, depth step 0.
template <int C, int NB>
__device__ __forceinline__ void conv_products(
    float (&acc)[NB][C / 2], uint64_t a_desc, int K, int d,
    unsigned char* ring_buf, uint64_t* full, uint64_t* empty, int stages,
    Ring& ring, int lane) {
  constexpr int kSteps = C / 16;           // depth steps per tap
  constexpr int kUnit = 32 * C;            // bytes of one (tap, depth step)
  constexpr int kUnits = kStageBytes / kUnit;
  constexpr int rows = 32768 / C + 2 * kGuard;  // of a plane
  const int hk = K / 2;
  const int n_units = K * kSteps;
  int prev = -1;
  for (int u0 = 0; u0 < n_units; u0 += kUnits) {
    mbar_wait(&full[ring.stage], ring.phase);
    const int n_u = min(kUnits, n_units - u0);
    const uint64_t b_desc = operand_desc(ring_buf + ring.stage * kStageBytes, C);
    wgmma_fence();
    for (int u = 0; u < n_u; ++u) {
      const int unit = u0 + u;
      const int tap = unit / kSteps, kc = unit % kSteps;
      // in 16-byte rows: two depth groups per step, the tap's row offset
      const int off = 2 * kc * rows + (tap - hk) * d;
      const uint64_t bd = b_desc + (uint64_t)(u * (kUnit >> 4));
#ifndef MRF_ABLATE_PRODUCTS
#pragma unroll
      for (int g = 0; g < NB; ++g)
        wgmma_bf16(acc[g], a_desc + (uint64_t)(int64_t)(off + 128 * g), bd);
#endif
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = ring.stage;
    ring.next(stages);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(&empty[prev]);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) stage_kernel(const Args a) {
  constexpr int NREG = C / 2;        // accumulator registers of one band
  constexpr int BANDS = 256 / C;     // bands of 64 rows per warpgroup
  constexpr int GB = 128 / C;        // bands per conv_d pass
  constexpr int R = 2 * BANDS * 64;  // rows of the block's buffer
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int rows = R + 2 * kGuard;
  constexpr int plane = rows * C * 2;
  unsigned char* a1 = smem;
  unsigned char* ring_buf = smem + 2 * plane;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_buf + a.stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* conv_bars = empty + kMaxStages;  // written[2], ready[2]: ConvBarrier
  uint64_t* leave = conv_bars + 4;           // neighbours are done with this block

  const int tid = threadIdx.x;
  const int S = a.stages;
  const int n_work = a.batch * a.n_tiles;
  // the grid is 1-D and so are its clusters: rank and size from blockIdx and
  // an argument, which the compiler knows to be uniform over the block
  const int n_ranks = a.cluster, rank = blockIdx.x % n_ranks;
  const int first_work = blockIdx.x / n_ranks, work_step = gridDim.x / n_ranks;
  const bool has_up = rank > 0, has_dn = rank < n_ranks - 1;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&conv_bars[i], kConsumers / 32);
      mbar_init(&conv_bars[2 + i], kConsumers / 32 + 1);
    }
    mbar_init(leave, max(1, has_up + has_dn));
    mbar_init_fence();
  }
  // the guard rows stay zero for the block's life
  for (int i = tid; i < 2 * plane / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  fence_async_proxy();
  cluster_sync();  // barriers and zeroed planes are there before a neighbour writes

  if (tid >= kConsumers) {
    // ---- producer: the weight stream, the same for every work item ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      Ring ring = {0, 0};
      for (int w = first_work; w < n_work; w += work_step) {
        const unsigned char* wp = a.w;
        for (int chain = 0; chain < a.n_chains; ++chain) {
          const int conv_bytes = a.ks[chain] * C * C * 2;
          for (int cv = 0; cv < 2 * a.n_dil; ++cv) {
            const int passes = (cv & 1) ? 1 : 2;  // conv_d: once per pass
            for (int p = 0; p < passes; ++p)
              for (int o = 0; o < conv_bytes; o += kStageBytes) {
                const int bytes = min(kStageBytes, conv_bytes - o);
                mbar_wait(&empty[ring.stage], ring.phase ^ 1);
#ifndef MRF_ABLATE_COPIES
                mbar_arrive_expect_tx(&full[ring.stage], bytes);
                bulk_copy(ring_buf + ring.stage * kStageBytes, wp + o, bytes,
                          &full[ring.stage]);
#else
                mbar_arrive(&full[ring.stage]);
#endif
                ring.next(S);
              }
            wp += conv_bytes;
          }
        }
      }
    } else if (tid == kConsumers + 32) {
      // ---- exchange thread: the edge rows, after every conv but a chain's last ----
      const uint32_t bars = smem_addr(conv_bars);
      const int incoming = (has_up + has_dn) * kGuard * C * 2;
      uint32_t count = 0;
      for (int w = first_work; w < n_work; w += work_step)
        for (int chain = 0; chain < a.n_chains; ++chain)
          for (int cv = 0; cv < 2 * a.n_dil; ++cv, ++count) {
            // the chain's start and every conv_1 but the last write A1,
            // every conv_d writes A2
            const uint32_t p = smem_addr(a1) + (cv & 1) * plane;
            const uint32_t i = 8 * (count & 1);
            mbar_arrive_expect_tx(&conv_bars[2 + (count & 1)], incoming);
            mbar_wait_cluster(bars + i, (count >> 1) & 1);
            for (int j = 0; j < C / 8; ++j) {
              // rows 0..kGuard-1 -> the guard rows below the previous block's
              // rows; rows R-kGuard..R-1 -> the guard rows above the next one's
              const uint32_t first = p + (j * rows + kGuard) * 16;
              if (has_up)
                bulk_copy_to_cluster(map_to_rank(first + R * 16, rank - 1), first,
                                     kGuard * 16, map_to_rank(bars + 16 + i, rank - 1));
              if (has_dn)
                bulk_copy_to_cluster(map_to_rank(first - kGuard * 16, rank + 1),
                                     first + (R - kGuard) * 16, kGuard * 16,
                                     map_to_rank(bars + 16 + i, rank + 1));
            }
          }
      // no block leaves while a neighbour may still copy into it or be read
      // by its copies: each neighbour says so once its consumers have passed
      // their last barrier (the copies sent to it have landed by then)
      if (count) mbar_wait_cluster(bars + 16 + 8 * ((count - 1) & 1), ((count - 1) >> 1) & 1);
      if (has_up) mbar_arrive_cluster(map_to_rank(smem_addr(leave), rank - 1));
      if (has_dn) mbar_arrive_cluster(map_to_rank(smem_addr(leave), rank + 1));
      if (has_up || has_dn) mbar_wait_cluster(smem_addr(leave), 0);
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int gr = lane / 4, qd = lane % 4;
    const int T = a.length;
    const float slope = a.slope;
    // row of (band lb, half h): 128 * lb + 8 * h + r_lane;
    // channel of (j, e): 8 * j + 2 * qd + e; register 4 * j + 2 * h + e
    const int r_lane = 64 * wg + 16 * warp + gr;
    // the thread's 4-byte slot in row r, depth group j of a plane:
    // (j * rows + guard + r) * 16 + 4 * qd
    constexpr uint32_t rows16 = rows * 16;
    const uint32_t slot = smem_addr(a1) + (kGuard + r_lane) * 16 + 4 * qd;
    ConvBarrier conv_bar = {0};
    const uint32_t bars = smem_addr(conv_bars);
    const uint64_t a1_desc = operand_desc(a1 + (kGuard + 64 * wg) * 16, rows);
    const uint64_t a2_desc = a1_desc + (uint64_t)(plane >> 4);
    float* scratch = a.scratch + (size_t)blockIdx.x * (BANDS * NREG * kConsumers) + tid;
    Ring ring = {0, 0};
    float y[BANDS][NREG];

    for (int w = first_work; w < n_work; w += work_step) {
      const int bi = w / a.n_tiles, ti = w - bi * a.n_tiles;
      // time of the thread's row 0: the cluster's buffer starts `halo` rows
      // before its tile, this block's rows R * rank further on
      const int g0 = ti * a.tile - a.halo + R * rank + r_lane;
      const float* bias = a.bias;

      for (int chain = 0; chain < a.n_chains; ++chain) {
        const int K = a.ks[chain];
        // y = x on the block's rows (zero outside [0, T)); A1 = leaky(y)
        size_t io_off = (size_t)bi * C * T + (size_t)(2 * qd) * T;
        asm volatile("" : "+l"(io_off));  // addresses are made here, chain by chain
#if !defined(MRF_ABLATE_IO) && !defined(MRF_ABLATE_LOAD)
#ifdef MRF_ABLATE_RELOAD
        if (chain > 0) {
        } else
#endif
        load_state<C>(y, a.x + io_off, T, g0, slot, slope);
#else
#pragma unroll
        for (int lb = 0; lb < BANDS; ++lb)
#pragma unroll
          for (int i = 0; i < NREG; ++i) y[lb][i] = 0.f;
#endif
        conv_bar.sync(bars, lane);

        for (int di = 0; di < a.n_dil; ++di) {
          // conv_d: A2 = leaky(mask * (b1 + conv_d(A1))), GB bands a pass
#pragma unroll
          for (int p = 0; p < BANDS / GB; ++p) {
            float acc[GB][NREG];
#pragma unroll
            for (int j = 0; j < C / 8; ++j) {
              const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * qd);
#pragma unroll
              for (int g = 0; g < GB; ++g) {
                acc[g][4 * j] = acc[g][4 * j + 2] = bv.x;
                acc[g][4 * j + 1] = acc[g][4 * j + 3] = bv.y;
              }
            }
#pragma unroll
            for (int g = 0; g < GB; ++g) acc_fence(acc[g]);
            conv_products<C, GB>(acc, a1_desc + (uint64_t)(128 * GB * p), K,
                                 a.dil[di], ring_buf, full, empty, S, ring, lane);
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              acc_fence(acc[g]);
#ifdef MRF_ABLATE_EPILOGUE
              keep_alive(acc[g], slot);
#else
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 128 * (GB * p + g) + 8 * h;
                const int t = g0 + r;
                const bool inside = t >= 0 && t < T;
#pragma unroll
                for (int j = 0; j < C / 8; ++j) {
                  const float m0 = inside ? acc[g][4 * j + 2 * h] : 0.f;
                  const float m1 = inside ? acc[g][4 * j + 2 * h + 1] : 0.f;
                  st_shared(slot + plane + j * rows16 + r * 16,
                            pack_bf16(leaky(m0, slope), leaky(m1, slope)));
                }
              }
#endif
            }
          }
          bias += C;
          conv_bar.sync(bars, lane);

          // conv_1: y = mask * (y + b2 + conv_1(A2)); A1 = leaky(y)
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * qd);
#pragma unroll
            for (int lb = 0; lb < BANDS; ++lb) {
              y[lb][4 * j] += bv.x;
              y[lb][4 * j + 2] += bv.x;
              y[lb][4 * j + 1] += bv.y;
              y[lb][4 * j + 3] += bv.y;
            }
          }
#pragma unroll
          for (int lb = 0; lb < BANDS; ++lb) acc_fence(y[lb]);
          conv_products<C, BANDS>(y, a2_desc, K, 1, ring_buf, full, empty, S,
                                  ring, lane);
          bias += C;
          const bool last = di == a.n_dil - 1;
#pragma unroll
          for (int lb = 0; lb < BANDS; ++lb) {
            acc_fence(y[lb]);
#ifdef MRF_ABLATE_EPILOGUE
            keep_alive(y[lb], slot);
#else
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 128 * lb + 8 * h;
              const int t = g0 + r;
              const bool inside = t >= 0 && t < T;
#pragma unroll
              for (int j = 0; j < C / 8; ++j) {
                const float y0 = inside ? y[lb][4 * j + 2 * h] : 0.f;
                const float y1 = inside ? y[lb][4 * j + 2 * h + 1] : 0.f;
                y[lb][4 * j + 2 * h] = y0;
                y[lb][4 * j + 2 * h + 1] = y1;
                if (!last)
                  st_shared(slot + j * rows16 + r * 16,
                            pack_bf16(leaky(y0, slope), leaky(y1, slope)));
              }
            }
#endif
          }
          // the last conv_1 of a chain wrote no plane: the next chain's
          // load is followed by its own barrier
          if (!last) conv_bar.sync(bars, lane);
        }

#if !defined(MRF_ABLATE_IO) && !defined(MRF_ABLATE_SCRATCH)
        // the sum over chains waits in the block's scratch
        if (chain > 0) {
#pragma unroll
          for (int lb = 0; lb < BANDS; ++lb)
#pragma unroll
            for (int i = 0; i < NREG; ++i)
              y[lb][i] += scratch[(lb * NREG + i) * kConsumers];
        }
        if (chain < a.n_chains - 1) {
#pragma unroll
          for (int lb = 0; lb < BANDS; ++lb)
#pragma unroll
            for (int i = 0; i < NREG; ++i)
              scratch[(lb * NREG + i) * kConsumers] = y[lb][i];
        }
#endif
      }

#if !defined(MRF_ABLATE_IO) && !defined(MRF_ABLATE_STORE)
      // the mean, on the rows of the output tile
      size_t io_off = (size_t)bi * C * T + (size_t)(2 * qd) * T;
      // the tile in the thread's rows
      const int r_lo = a.halo - R * rank - r_lane, r_hi = r_lo + a.tile;
      const float inv = 1.f / (float)a.n_chains;
      store_mean<C>(y, a.out + io_off, T, g0, r_lo, r_hi, inv);
#endif
    }
  }
}

template <int C>
cudaError_t launch(const Args& a, int cluster, int max_blocks, cudaStream_t stream) {
  const int rows = 32768 / C + 2 * kGuard;
  const int smem =
      2 * rows * C * 2 + a.stages * kStageBytes + (2 * kMaxStages + 5) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      stage_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // clusters the current device holds at once: asked at every launch
  // (microseconds on the host), so nothing is remembered across devices or
  // threads
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, stage_kernel<C>, &cfg);
  if (err != cudaSuccess) return err;
  const int n_work = a.batch * a.n_tiles;
  const int n_clusters = min(min(n_work, resident), max_blocks / cluster);
  if (n_clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(n_clusters * cluster);
  return cudaLaunchKernelEx(&cfg, stage_kernel<C>, a);
}

}  // namespace

extern "C" {

// One decoder stage tail on x [B, C, T] -> out: the mean over n_chains
// chains of kernel sizes ks, each over the dilations dil. C is 16, 32, 64
// or 128 (the wrapper pads). x and out are bf16. w: the weight images
// packed by ops/resblock.py:pack_stage; bias f32 [n_convs][C]; scratch f32
// [max_blocks][128][256]. cluster, tile, halo, stages: from
// ops/resblock.py:stage_plan (a cluster's 1 or 2 blocks share a buffer of
// cluster * 32768 / C rows and store tile = that - 2 * halo rows; no tap
// reaches over 32 rows; stages 16 KB ring stages). The launch is
// of persistent blocks: as many clusters as the card holds at once, at most
// max_blocks blocks.
int rvc_mrf_stage(const void* x, void* out, const void* w, const float* bias,
                  float* scratch, int batch, int channels, int length,
                  int cluster, int tile, int halo, int stages, int n_chains,
                  const int* ks, int n_dil, const int* dil, float slope,
                  int max_blocks, void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || n_dil < 1 || n_dil > kMaxDil ||
      batch < 1 || length < 1 || tile < 1 || halo < 0 || max_blocks < 1 ||
      stages < 2 || stages > kMaxStages || cluster < 1 || cluster > 2 ||
      (channels != 16 && channels != 32 && channels != 64 && channels != 128) ||
      tile + 2 * halo > cluster * (32768 / channels))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.w = static_cast<const unsigned char*>(w);
  a.bias = bias;
  a.scratch = scratch;
  a.batch = batch;
  a.length = length;
  a.n_tiles = (length + tile - 1) / tile;
  a.cluster = cluster;
  a.tile = tile;
  a.halo = halo;
  a.stages = stages;
  a.n_chains = n_chains;
  a.n_dil = n_dil;
  a.slope = slope;
  for (int c = 0; c < kMaxChains; ++c) a.ks[c] = c < n_chains ? ks[c] : 1;
  for (int i = 0; i < kMaxDil; ++i) a.dil[i] = i < n_dil ? dil[i] : 1;
  for (int c = 0; c < n_chains; ++c) {
    if (ks[c] < 1 || ks[c] % 2 == 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_dil; ++i)
      if (dil[i] < 1 || ks[c] / 2 * dil[i] > kGuard)
        return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16: return (int)launch<16>(a, cluster, max_blocks, st);
    case 32: return (int)launch<32>(a, cluster, max_blocks, st);
    case 64: return (int)launch<64>(a, cluster, max_blocks, st);
    default: return (int)launch<128>(a, cluster, max_blocks, st);
  }
}

}  // extern "C"
