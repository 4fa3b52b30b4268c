// Narrow ResBlock chains in f32 on Hopper: the "narrow chain" kernel N.
//
// Replaces, at C <= 64, the TPU kernels rvc_tpu/ops/resblock_pallas.py
// fused_resblock (_fused_resblock_impl, pallas_call at :239: one chain) and,
// for f32 input, fused_mrf (_fused_mrf_impl, pallas_call at :437: the mean
// over a stage's chains, which JAX computes with f32 operands for f32
// input). A chain is, per dilation d:
//   m = mask * (b1 + conv_d(leaky(y)));  y = mask * (y + b2 + conv_1(leaky(m))),
// f32 compute whatever the I/O dtype (bf16 or f32); mask zeroes the rows
// outside [0, T) after every conv, as the direct convs' zero padding
// requires. Every product runs as 3xTF32 (wgmma.cuh), so the result keeps
// f32 precision.
//
// What bounds it on the card: operations. A chain of K taps and three
// dilations is 6 * 2 * K * C^2 FLOP per time step, three tf32 products per
// f32 product (a C = 32, K = 11 chain at T = 511 360: 2.1e11 tf32 FLOP, 0.42
// ms at 495 TFLOP/s) against 2 reads and 2 writes of C * T values. The wide
// kernel (resblock_chain.cu) puts the output channels on wgmma's M side in
// blocks of 128 rows: at C = 32 three quarters of its products are on zero
// rows, and each conv is a launch with an f32 scratch signal between them.
//
// What the design does about it:
//   orientation: time is the M side (64 rows a warpgroup product) and the
//     output channels the N side, N = C = 16, 32 or 64 (the wrapper pads),
//     wgmma m64nNk8 tf32: nothing is computed on padding rows.
//   A from registers: the activations lie in ONE f32 plane [time][channel]
//     in wgmma.cuh's layout (a). For every tap, 8-channel depth step and
//     band of 64 rows a thread loads its 4 values of the A fragment (rows r
//     and r + 8 of its warp's 16, channels q and q + 4) with plain shared
//     loads, splits each into its tf32 big part and the exact remainder in
//     registers, and issues the three products of the 3xTF32 sum with A
//     from those registers (wgmma_tf32_rs) and B (the weights, big and
//     small planes) from the ring. A is read from shared memory once per
//     product triple, not three times, and no plane of small parts is kept.
//     Each band's triple is one commit group; the fragment of the next
//     band is loaded while the last two groups run, and a wait that leaves
//     one group in flight frees the registers of the group before it.
//   the whole chain per time tile, the halo recomputed once per CLUSTER:
//     the `cluster` blocks of a cluster (1 or 2: the planner weighs the
//     waves of blocks against the exchange's cost, ops/resblock.py
//     narrow_plan) hold consecutive runs of R = 16384 / C rows of one
//     buffer (256 at C = 64,
//     512 at 32, 1024 at 16) that starts `halo` rows before the cluster's
//     tile, run all convs of the chain on them, and store the cluster's
//     rows no conv spoiled: cluster * R - 2 * halo (halo = K / 2 *
//     sum(d + 1): 60 rows at K = 11, dilations 1, 3, 5; at C = 64 a
//     cluster stores 392 of 512 rows, a lone block 136 of 256). The
//     signal is read once and written once a chain: no scratch signal.
//   the halo exchange, as K1's (resblock.cu): kGuard = 128 guard rows above
//     and below the plane take the taps that reach past the block's rows
//     (so no tap may reach further: K = 11, d = 5 reaches 25; K = 15, d = 9
//     63); the outer ones are zero, and after every plane write one thread
//     of the producer's warpgroup copies the block's `reach` edge rows (the
//     furthest any tap of the launch reaches) into the neighbour's guard
//     rows by bulk copies through distributed shared memory (Exchange).
//     The consumers' code touches no neighbour (that would serialise every
//     wgmma, C7520). With one plane, a conv's output waits in registers
//     until every warp of the block has read it (drain), and a copy into a
//     neighbour waits until the neighbour has drained the conv before.
//   state: two consumer warpgroups keep the state y and a conv's sums m in
//     2 x 64 registers a thread at every width (NB = 128 / C bands of 64
//     rows each, C / 2 registers a band), at 240 registers (setmaxnreg; the
//     producer's warpgroup gives its own up). The sums start from the bias
//     and meet y only after the products (accumulated onto y, every add
//     rounds at y's magnitude).
//   weights: packed by the wrapper as ready shared-memory images, per conv
//     and (tap, 8-channel depth step) one unit of 64 * C bytes (the big plane
//     then the small, each [2 depth groups][C_out][4]), streamed in 16 KB
//     ring stages by one producer thread, one cp.async.bulk + mbarrier each,
//     up to 6 stages in flight; every block reads each conv once (from L2).
//   several chains in one launch (an f32 stage tail): the block runs the
//     chains one after the other on the same tile, and the sum over them
//     waits in the output itself, f32, written and read back by the same
//     threads (its rows are the block's alone); the last chain's store
//     scales by 1 / n_chains.
//   x is read and the output written straight from the accumulator
//     fragments ([C, T] with T contiguous: 8 lanes cover 8 neighbouring
//     time steps of one channel), under predicates, never under a branch.
//
// Layout: x and out are [B, C, T] contiguous, both bf16 or both f32 (more
// than one chain: f32). Weights are ordered chain-major, conv_d then conv_1
// per dilation; biases f32 [n_convs][C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = 384;    // and the producer's warpgroup
constexpr int kStageBytes = 16384;
constexpr int kMaxStages = 6;
constexpr int kGuard = 128;      // guard rows above and below the plane
constexpr int kBlockElems = 16384;  // rows x channels of a block's buffer
constexpr int kMaxChains = 4;
constexpr int kMaxDil = 4;
// the exchange's barriers, in this order after the ring's: drained[2],
// written[2], ready[2], may_send[2], leave
constexpr int kDrained = 0, kWritten = 2, kReady = 4, kMaySend = 6, kLeave = 8;
constexpr int kBarriers = 2 * kMaxStages + 9;

struct Args {
  const void* x;
  void* out;
  const unsigned char* w;  // packed weight images, conv after conv
  const float* bias;       // [n_convs][C]
  int length;
  int cluster;             // blocks of a cluster: 1 or 2
  int tile, halo, reach, stages;  // tile: rows a CLUSTER stores
  int n_chains, n_dil;
  int ks[kMaxChains];
  int dil[kMaxDil];
  float slope;
};

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

__device__ __forceinline__ void st_shared2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

// The two consumer warpgroups, and nobody else (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ float load_x(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Stores and loads under a predicate and not under a branch: the
// accumulators are read in straight-line code.
__device__ __forceinline__ void store_if(float* p, float v, int ok) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
               "f"(v), "r"(ok)
               : "memory");
}

__device__ __forceinline__ void store_if(__nv_bfloat16* p, float v, int ok) {
  const __nv_bfloat16 b = __float2bfloat16(v);
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.b16 [%0], %1;\n}\n" ::"l"(p),
               "h"(*reinterpret_cast<const unsigned short*>(&b)), "r"(ok)
               : "memory");
}

__device__ __forceinline__ float load_if(const float* p, int ok) {
  float v = 0.f;
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q ld.global.f32 %0, [%1];\n}\n"
               : "+f"(v)
               : "l"(p), "r"(ok)
               : "memory");
  return v;
}

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

// The consumers' side of the plane's life. Every plane write (a chain's
// start and every conv but a chain's last) is one exchange e, and the
// products that read it end in one drain; the barriers of exchange e are
// those of index e % 2:
//   drained (1 arrival): every consumer warp has read the plane of
//     exchange e (its guard rows too); the exchange thread then lets the
//     neighbour send exchange e + 1 (may_send, 1 arrival, from the
//     neighbour's exchange thread).
//   written (8 arrivals): every consumer warp has written its rows of the
//     plane (and fenced them for the bulk copies).
//   ready (8 arrivals, + 1 and the neighbour's bytes in a cluster): the
//     consumers wait here until the plane is whole, the neighbour's edge
//     rows in the guard rows included.
// All a consumer thread keeps is the count of exchanges passed. A lone
// block (a cluster of one) has no neighbour: the consumers' named barrier
// is all it takes, before and after a plane write.
struct Exchange {
  uint32_t n;
  bool lone;

  // bars: shared address of the first exchange barrier
  __device__ __forceinline__ void publish(uint32_t bars, int lane) {
    if (lone) {
      consumer_sync();
      return;
    }
    fence_async_proxy();  // this thread's plane writes -> the bulk copies
    __syncwarp();
    const uint32_t i = 8 * (n & 1);
    // lane 0 arrives, under a predicate: no branch between the products
    mbar_arrive_if(bars + 8 * kWritten + i, lane == 0);
    mbar_arrive_if(bars + 8 * kReady + i, lane == 0);
    mbar_wait_cluster(bars + 8 * kReady + i, (n >> 1) & 1);
    ++n;
  }

  __device__ __forceinline__ void drain(uint32_t bars, int tid) {
    consumer_sync();  // every warp's products have read the plane
    if (!lone) mbar_arrive_if(bars + 8 * kDrained + 8 * ((n - 1) & 1), tid == 0);
  }
};

// acc = the conv's bias on the thread's channels (8 j + 2 qd + e), every band.
template <int C, int NB>
__device__ __forceinline__ void init_bias(float (&acc)[NB][C / 2], const float* bias,
                                          int qd) {
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * qd);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      acc[b][4 * j] = acc[b][4 * j + 2] = bv.x;
      acc[b][4 * j + 1] = acc[b][4 * j + 3] = bv.y;
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) acc_fence(acc[b]);
}

// acc[g] += conv over the NB bands of 64 rows: for every tap and 8-channel
// depth step one 3xTF32 product per band, A from registers, the weights
// from the ring as their 16 KB stages arrive. frag: the thread's A value at
// its row r (band 0), depth group 0 of the plane, tap offset 0.
template <int C, int NB>
__device__ __forceinline__ void conv_products(
    float (&acc)[NB][C / 2], const unsigned char* frag, int K, int d,
    unsigned char* ring_buf, uint64_t* full, uint64_t* empty, int stages,
    Ring& ring, int lane) {
  constexpr int kSteps = C / 8;            // depth steps per tap
  constexpr int kUnit = 64 * C;            // bytes of one (tap, depth step)
  constexpr int kUnits = kStageBytes / kUnit;
  constexpr int rows = kBlockElems / C + 2 * kGuard;  // of the plane
  constexpr int kGroup = rows * 4;         // floats from a depth group to the next
  const int hk = K / 2;
  const int n_units = K * kSteps;
  int prev = -1;
  for (int u0 = 0; u0 < n_units; u0 += kUnits) {
    mbar_wait(&full[ring.stage], ring.phase);
    const int n_u = min(kUnits, n_units - u0);
    const uint64_t b_desc = operand_desc(ring_buf + ring.stage * kStageBytes, C);
    for (int u = 0; u < n_u; ++u) {
      const int unit = u0 + u;
      const int tap = unit / kSteps, step = unit - tap * kSteps;
      // in 16-byte rows: two depth groups per step, the tap's row offset
      const float* a =
          reinterpret_cast<const float*>(frag + (2 * step * rows + (tap - hk) * d) * 16);
      const uint64_t b_big = b_desc + (uint64_t)(u * (kUnit >> 4));
      const uint64_t b_small = b_big + (uint64_t)(kUnit >> 5);
#pragma unroll
      for (int g = 0; g < NB; ++g) {
        // rows r and r + 8 of band g, channels q and q + 4 of the step
        const float* p = a + g * 64 * 4;
        const float v[4] = {p[0], p[8 * 4], p[kGroup], p[kGroup + 8 * 4]};
        uint32_t big[4], small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          big[i] = __float_as_uint(v[i]) & 0xffffe000u;
          small[i] = __float_as_uint(v[i] - __uint_as_float(big[i]));
        }
        // the group before the last is done: its registers are free (two
        // or three in flight measured alike, tools/narrow_ab.py)
        wgmma_wait<1>();
        wgmma_fence();
        wgmma_tf32_rs(acc[g], small, b_big);
        wgmma_tf32_rs(acc[g], big, b_small);
        wgmma_tf32_rs(acc[g], big, b_big);
        wgmma_commit();
      }
    }
    wgmma_wait<1>();  // the previous stage's products are done: free it
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = ring.stage;
    ring.next(stages);
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(&empty[prev]);
}

template <int C, typename IO>
__global__ void __launch_bounds__(kThreads, 1) narrow_kernel(const Args a) {
  constexpr int NB = 128 / C;        // bands of 64 rows per warpgroup
  constexpr int NREG = C / 2;        // accumulator registers of one band
  constexpr int R = kBlockElems / C;  // rows of the block's buffer
  constexpr int rows = R + 2 * kGuard;
  constexpr int plane = rows * C * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring_buf = smem + plane;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_buf + a.stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;  // the exchange's barriers

  const int tid = threadIdx.x;
  const int S = a.stages;
  // the grid's x runs over (tile, rank) and its clusters are along x: rank
  // and tile from blockIdx and an argument, uniform over the block
  const int rank = blockIdx.x % a.cluster, ti = blockIdx.x / a.cluster;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xbar[kDrained + i], 1);
      mbar_init(&xbar[kWritten + i], kConsumers / 32);
      mbar_init(&xbar[kReady + i], kConsumers / 32 + (a.cluster > 1));
      mbar_init(&xbar[kMaySend + i], 1);
    }
    mbar_init(&xbar[kLeave], 1);
    mbar_init_fence();
  }
  // the `reach` guard rows above and below the block's rows, all a tap
  // reads, stay zero for the block's life where no neighbour's rows land
  for (int i = tid; i < (C / 4) * 2 * a.reach; i += kThreads) {
    const int group = i / (2 * a.reach), r = i - group * 2 * a.reach;
    const int row = r < a.reach ? kGuard - a.reach + r : kGuard + R - a.reach + r;
    *reinterpret_cast<uint4*>(smem + (group * rows + row) * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_async_proxy();
  cluster_sync();  // barriers and zeroed guards are there before a neighbour writes

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      // ---- producer: every conv of every chain, once ----
      Ring ring = {0, 0};
      const unsigned char* wp = a.w;
      for (int chain = 0; chain < a.n_chains; ++chain) {
        const int conv_bytes = a.ks[chain] * C * C * 8;
        for (int cv = 0; cv < 2 * a.n_dil; ++cv) {
          for (int o = 0; o < conv_bytes; o += kStageBytes) {
            const int bytes = min(kStageBytes, conv_bytes - o);
            mbar_wait(&empty[ring.stage], ring.phase ^ 1);
            mbar_arrive_expect_tx(&full[ring.stage], bytes);
            bulk_copy(ring_buf + ring.stage * kStageBytes, wp + o, bytes,
                      &full[ring.stage]);
            ring.next(S);
          }
          wp += conv_bytes;
        }
      }
    } else if (tid == kConsumers + 32 && a.cluster > 1) {
      // ---- exchange thread: the edge rows after every plane write ----
      const uint32_t bars = smem_addr(xbar), p0 = smem_addr(smem);
      const uint32_t other = rank ^ 1;
      const int n_x = a.n_chains * 2 * a.n_dil;
      // rank 0 sends its last `reach` rows into the guard rows above rank
      // 1's first row; rank 1 its first rows into those below rank 0's last
      const int src = rank == 0 ? kGuard + R - a.reach : kGuard;
      const int dst = rank == 0 ? kGuard - a.reach : kGuard + R;
      for (int e = 0; e < n_x; ++e) {
        const uint32_t i = 8 * (e & 1), ph = (e >> 1) & 1;
        mbar_arrive_expect_tx(&xbar[kReady + (e & 1)], a.reach * C * 4);
        mbar_wait_cluster(bars + 8 * kWritten + i, ph);
        // the neighbour has drained exchange e - 1: its guard rows are free
        if (e > 0) mbar_wait_cluster(bars + 8 * kMaySend + 8 * ((e - 1) & 1), ((e - 1) >> 1) & 1);
        if (a.reach > 0)
          for (int j = 0; j < C / 4; ++j)
            bulk_copy_to_cluster(map_to_rank(p0 + (j * rows + dst) * 16, other),
                                 p0 + (j * rows + src) * 16, a.reach * 16,
                                 map_to_rank(bars + 8 * kReady + i, other));
        mbar_wait_cluster(bars + 8 * kDrained + i, ph);
        if (e < n_x - 1) mbar_arrive_cluster(map_to_rank(bars + 8 * kMaySend + i, other));
      }
      // no block leaves while its neighbour may still copy into it or be
      // read by its copies: each says so once its consumers have drained
      // the last exchange (the copies sent to it have landed by then)
      mbar_arrive_cluster(map_to_rank(bars + 8 * kLeave, other));
      mbar_wait_cluster(bars + 8 * kLeave, 0);
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int gr = lane / 4, qd = lane % 4;
    const int T = a.length;
    const float slope = a.slope;
    // row of (band b, half h): r_lane + 64 * b + 8 * h; channel of
    // (j, e): 8 * j + 2 * qd + e; register 4 * j + 2 * h + e
    const int r_lane = 64 * NB * wg + 16 * warp + gr;
    // time of buffer row 0: the cluster's buffer starts `halo` rows before
    // its tile, this block's rows R * rank further on
    const int g0 = ti * a.tile - a.halo + R * rank;
    const int t_lane = g0 + r_lane;
    // the thread's 8 bytes in its row 0, channels 2 qd and 2 qd + 1 (depth
    // group qd / 2) of the plane; channels 8 j on: 2 j groups further
    const uint32_t slot =
        smem_addr(smem) + ((qd >> 1) * rows + kGuard + r_lane) * 16 + (qd & 1) * 8;
    // its A value: row r_lane, channel qd (depth group 0)
    const unsigned char* frag = smem + (kGuard + r_lane) * 16 + qd * 4;
    const uint32_t bars = smem_addr(xbar);
    // the batch row's channel 2 qd
    const size_t io_off = ((size_t)blockIdx.y * C + 2 * qd) * T;
    const IO* x = static_cast<const IO*>(a.x);
    IO* out = static_cast<IO*>(a.out);
    // the rows this block stores, in the thread's rows
    const int r_lo = a.halo - R * rank - r_lane, r_hi = r_lo + a.tile;
    const float inv = 1.f / (float)a.n_chains;
    const float* bias = a.bias;
    Ring ring = {0, 0};
    Exchange xch = {0, a.cluster == 1};
    float y[NB][NREG];

    for (int chain = 0; chain < a.n_chains; ++chain) {
      const int K = a.ks[chain];
      // addresses are made here, chain by chain: hoisted out of the loop
      // they are 64 registers of pointers a thread, spilled
      size_t off = io_off;
      asm volatile("" : "+l"(off));
      // y = x on the block's rows (zero outside [0, T)); plane = leaky(y).
      // Every load is issued before the first value is used; no branch
      // defines the accumulators: a clamped load, then a select.
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = t_lane + 64 * b + 8 * h;
              const bool inside = t >= 0 && t < T;
              const int tc = min(max(t, 0), T - 1);
              const float v = load_x(x, off + (size_t)(8 * j + e) * T + tc);
              y[b][4 * j + 2 * h + e] = inside ? v : 0.f;
            }
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < C / 8; ++j)
            st_shared2(slot + (2 * j * rows + 64 * b + 8 * h) * 16,
                       leaky(y[b][4 * j + 2 * h], slope),
                       leaky(y[b][4 * j + 2 * h + 1], slope));
      xch.publish(bars, lane);

      for (int di = 0; di < a.n_dil; ++di) {
        const bool last = di == a.n_dil - 1;
        // conv_d: m = mask * (b1 + conv_d(plane)); plane = leaky(m)
        float m[NB][NREG];
        init_bias<C, NB>(m, bias, qd);
        conv_products<C, NB>(m, frag, K, a.dil[di], ring_buf, full, empty, S, ring, lane);
        bias += C;
#pragma unroll
        for (int b = 0; b < NB; ++b) acc_fence(m[b]);
        xch.drain(bars, tid);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t_lane + 64 * b + 8 * h;
            const bool inside = t >= 0 && t < T;
#pragma unroll
            for (int j = 0; j < C / 8; ++j)
              st_shared2(slot + (2 * j * rows + 64 * b + 8 * h) * 16,
                         inside ? leaky(m[b][4 * j + 2 * h], slope) : 0.f,
                         inside ? leaky(m[b][4 * j + 2 * h + 1], slope) : 0.f);
          }
        xch.publish(bars, lane);

        // conv_1: y = mask * (y + (b2 + conv_1(plane))); plane = leaky(y).
        // The sums start from the bias, as conv_d's, and meet the state
        // after the products: accumulated onto y itself, every product's
        // add rounds at y's magnitude (on the card, 2.8e-5 of the largest
        // value apart from the plain chain at C = 64, K = 11; 3.6e-6 so)
        init_bias<C, NB>(m, bias, qd);
        conv_products<C, NB>(m, frag, K, 1, ring_buf, full, empty, S, ring, lane);
        bias += C;
#pragma unroll
        for (int b = 0; b < NB; ++b) acc_fence(m[b]);
        xch.drain(bars, tid);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t_lane + 64 * b + 8 * h;
            const bool inside = t >= 0 && t < T;
#pragma unroll
            for (int j = 0; j < C / 8; ++j) {
              const float y0 = inside ? y[b][4 * j + 2 * h] + m[b][4 * j + 2 * h] : 0.f;
              const float y1 =
                  inside ? y[b][4 * j + 2 * h + 1] + m[b][4 * j + 2 * h + 1] : 0.f;
              y[b][4 * j + 2 * h] = y0;
              y[b][4 * j + 2 * h + 1] = y1;
              if (!last)
                st_shared2(slot + (2 * j * rows + 64 * b + 8 * h) * 16, leaky(y0, slope),
                           leaky(y1, slope));
            }
          }
        // the last conv_1 of a chain writes no plane: the next chain's load
        // is followed by its own exchange
        if (!last) xch.publish(bars, lane);
      }

      // the chain's rows into the output: one chain is stored as it is;
      // several are summed there (f32; a band's loads issued before its
      // first store) and the last store scales the sum
      const float scale = chain == a.n_chains - 1 ? inv : 1.f;
      const int again = sizeof(IO) == 4 && chain > 0;
      asm volatile("" : "+l"(off));
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float prev[NREG];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * b + 8 * h;
          const int ok = r >= r_lo && r < r_hi && t_lane + r < T;
#pragma unroll
          for (int j = 0; j < C / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              prev[4 * j + 2 * h + e] = load_if(
                  reinterpret_cast<const float*>(out + off + (size_t)(8 * j + e) * T +
                                                 (t_lane + r)),
                  ok & again);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * b + 8 * h;
          const int ok = r >= r_lo && r < r_hi && t_lane + r < T;
#pragma unroll
          for (int j = 0; j < C / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              store_if(out + off + (size_t)(8 * j + e) * T + (t_lane + r),
                       (y[b][4 * j + 2 * h + e] + prev[4 * j + 2 * h + e]) * scale, ok);
        }
      }
    }
  }
}

template <int C, typename IO>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int rows = kBlockElems / C + 2 * kGuard;
  const int smem = rows * C * 4 + a.stages * kStageBytes + kBarriers * 8;
  cudaError_t err = cudaFuncSetAttribute(
      narrow_kernel<C, IO>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.cluster * ((a.length + a.tile - 1) / a.tile), batch);
  if (a.cluster == 1) {  // lone blocks: a plain launch (a block is its own cluster)
    narrow_kernel<C, IO><<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cluster;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, narrow_kernel<C, IO>, a);
}

template <typename IO>
cudaError_t launch_io(const Args& a, int batch, int channels, cudaStream_t stream) {
  switch (channels) {
    case 16: return launch<16, IO>(a, batch, stream);
    case 32: return launch<32, IO>(a, batch, stream);
    default: return launch<64, IO>(a, batch, stream);
  }
}

}  // namespace

extern "C" {

// n_chains ResBlock chains of kernel sizes ks over the dilations dil on x
// [B, C, T] -> out, out = the mean of the chains' outputs (one chain: its
// output). C is 16, 32 or 64 (the wrapper pads); x and out both bf16
// (io_bf16, one chain only) or both f32. w: the weight images packed by
// ops/resblock.py:pack_narrow; bias f32 [n_convs][C]. cluster, tile, halo,
// reach, stages: from ops/resblock.py:narrow_plan (the cluster's 1 or 2
// blocks share a buffer of cluster * 16384 / C rows and store tile = that -
// 2 * halo rows; no tap reaches over reach <= 128 rows; stages 16 KB ring
// stages). One cluster per (tile, batch row).
int rvc_narrow_chain(const void* x, int io_bf16, void* out, const void* w,
                     const float* bias, int batch, int channels, int length,
                     int cluster, int tile, int halo, int reach, int stages,
                     int n_chains, const int* ks, int n_dil, const int* dil, float slope,
                     void* stream) {
  if (n_chains < 1 || n_chains > kMaxChains || (io_bf16 && n_chains != 1) ||
      n_dil < 1 || n_dil > kMaxDil || batch < 1 || batch > 65535 || length < 1 ||
      cluster < 1 || cluster > 2 || tile < 1 || halo < 0 || reach < 0 ||
      reach > kGuard || stages < 2 || stages > kMaxStages ||
      (channels != 16 && channels != 32 && channels != 64) ||
      tile + 2 * halo > cluster * (kBlockElems / channels))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.out = out;
  a.w = static_cast<const unsigned char*>(w);
  a.bias = bias;
  a.length = length;
  a.cluster = cluster;
  a.tile = tile;
  a.halo = halo;
  a.reach = reach;
  a.stages = stages;
  a.n_chains = n_chains;
  a.n_dil = n_dil;
  a.slope = slope;
  for (int c = 0; c < kMaxChains; ++c) a.ks[c] = c < n_chains ? ks[c] : 1;
  for (int i = 0; i < kMaxDil; ++i) a.dil[i] = i < n_dil ? dil[i] : 1;
  for (int c = 0; c < n_chains; ++c) {
    if (ks[c] < 1 || ks[c] % 2 == 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_dil; ++i)
      if (dil[i] < 1 || ks[c] / 2 * dil[i] > reach) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(io_bf16 ? launch_io<__nv_bfloat16>(a, batch, channels, st)
                       : launch_io<float>(a, batch, channels, st));
}

}  // extern "C"
