"""HiFi-GAN stage tails: kernels K1 ``mrf_stage`` and K2 ``resblock_chain``.

Counterparts of ``rvc_tpu/ops/resblock_pallas.py``'s ``fused_mrf`` and
``fused_resblock``. Each wrapper launches its kernel for a CUDA tensor and
takes its plain PyTorch version (``mrf_stage_plain`` /
``resblock_chain_plain``) only for a CPU tensor.

Signals are [B, C, T]. Weights are the folded (weight-norm applied) conv
weights in torch layout [C_out, C_in, K], one per dilation, and biases [C];
each wrapper packs them for its kernel, and keeps the packed weights in the
``WeightCache`` (``utils/weight_cache.py``) the caller hands it, so that a
module packs once.

K1 (``csrc/resblock.cu``, C <= 128, bf16 input) runs every chain of a stage
in one launch of persistent blocks: ``wgmma`` bf16 products with time on the
M side, the f32 state in registers as conv_1's accumulator, two bf16
activation planes in shared memory and the weights streamed through a ring
of 16 KB stages (``stage_plan`` / ``pack_stage``). Its bound is operations
at 989 TFLOP/s bf16. A block computes 32768 / C rows; the blocks of a
cluster share one buffer (they exchange their edge rows after every conv),
which stores 2 * halo rows fewer than it computes; a block fetches each
conv_1 once and each conv_d twice from L2.
K2 (``csrc/resblock_chain.cu``, wide stages) runs a chain as two launches
of one ``wgmma`` 3xTF32 conv kernel per dilation, the output channels on
the M side in blocks of 128 rows; a conv whose reach no time tile's shared
memory holds runs as runs of taps that add into one f32 sum
(``conv_taps``), so K2 takes every chain. The narrow chain kernel
(``csrc/resblock_narrow.cu``, C <= 64) runs a whole chain per time tile in
one launch, 3xTF32 with time on the M side (A from registers) and C_out =
16, 32 or 64 on the N side, the halo recomputed once per cluster of 1 or 2
blocks (``narrow_plan`` / ``pack_narrow``): ``resblock_chain`` at those
widths, and an f32 ``mrf_stage`` in one launch that sums the chains and
scales by 1/n.

Which kernel runs is the routes' choice, and nothing else's:
``stage_route`` gives a stage tail to K1 (bf16) or to the narrow kernel
(f32, C <= 64) in one launch where that kernel's planner takes it, and
otherwise to its chains one by one (then the mean in f32); ``chain_route``
gives a chain of C <= 64 to the narrow kernel where its planner takes the
chain, else to K2. So every config the JAX package converts runs on a
kernel; a failed build or launch raises.

Both wrappers are ``torch.autograd.Function``s, on the card and on the CPU.
Their backward is what the JAX package's ``custom_vjp`` does: it recomputes
the chains through plain convolutions in the input's dtype (``_chain_direct``,
the counterpart of ``_direct_chain``) and pulls the cotangent back to x and
to every folded weight and bias, so gradients reach ``weight_v`` and
``weight_g`` through the weight-norm fold. Neither TPU kernel has a backward
kernel, so neither has one here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import H100_SMS
from ..utils import profiling
from ..utils.weight_cache import WeightCache

# shared memory a block may use on Hopper (232,448 bytes) and the registers
# of an SM
SMEM_LIMIT = 232_448
SM_REGISTERS = 65_536
# K1: channels it is built for; rows x channels of a block's buffer (two
# consumer warpgroups, 128 state registers a thread); bytes of a weight ring
# stage and the ring's greatest depth; threads and registers (setmaxnreg)
# of the consumers and of the producer's warpgroup; a consumer's registers
# for the state and for conv_d's sums
MRF_CHANNELS = (16, 32, 64, 128)
MRF_BLOCK_ELEMS = 32_768
MRF_STAGE_BYTES = 16_384
MRF_MAX_STAGES = 8
MRF_CONSUMERS, MRF_CONSUMER_REGS = 256, 240
MRF_PRODUCERS, MRF_PRODUCER_REGS = 128, 24
MRF_STATE_REGS, MRF_ACC_REGS = 128, 64
# blocks of a cluster that share one buffer, by channels the kernel runs at,
# and the guard rows above and below each block's planes: the most a tap may
# reach past a block's end
MRF_CLUSTER = {16: 1, 32: 1, 64: 2, 128: 2}
MRF_GUARD = 32
MRF_MAX_CHAINS = MRF_MAX_DILATIONS = 4
# K2's conv kernel: the time tiles it is built for, output channels per
# block, input channels per depth chunk, bytes of one weight ring stage (two
# planes)
CONV_TILES = (128, 152, 176)
CONV_BLOCK = 128
CONV_CHUNK = 32
CONV_STAGE_BYTES = 2 * CONV_BLOCK * CONV_CHUNK * 4
CONV_MAX_STAGES = 4
# the narrow chain kernel: widths it is built for; rows x channels of a
# block's buffer (two consumer warpgroups, 64 state and 64 conv_d registers
# a thread); bytes of a weight ring stage and the ring's greatest depth;
# zero guard rows above and below its plane (the most a tap may reach);
# blocks of a cluster that share one buffer, by width; threads and
# registers (setmaxnreg) of the consumers and of the producer's warpgroup;
# the ring's and the halo exchange's barriers
NARROW_CHANNELS = (16, 32, 64)
NARROW_BLOCK_ELEMS = 16_384
NARROW_STAGE_BYTES = 16_384
NARROW_MAX_STAGES = 6
NARROW_GUARD = 128
NARROW_CLUSTERS = (1, 2)
# what a block of a 2-block cluster costs over a lone block's (the halo
# exchange after every conv): the planner weighs each cluster size's waves
# of blocks by it. Measured on an H100 (tools/narrow_ab.py, PERF.md §6):
# at C = 32, T = 511 360, a cluster of 2 ran 12 % slower per wave at K = 3
# and 6 % at K = 11
NARROW_EXCHANGE_COST = 0.1
# the least share of a 2-block cluster's rows that a chain must leave
# stored for ``chain_route`` to give it to the narrow kernel: the chain's
# halo is recomputed, and its reach copied after every conv. Measured on
# an H100 (chip_smoke.py phase `kernels`, PERF.md §6): at C = 64 the
# narrow kernel beat K2 with 60 % stored (K = 3, d = 99; K = 11, d = 1, 3,
# 5, 7) and lost with 56 % (K = 15, d = 13) or less
NARROW_MIN_SHARE = 0.6
NARROW_CONSUMERS, NARROW_CONSUMER_REGS = 256, 240
NARROW_PRODUCERS, NARROW_PRODUCER_REGS = 128, 24
NARROW_ACC_REGS = 128
NARROW_BARRIERS = 2 * NARROW_MAX_STAGES + 9
launches = {"mrf_stage": 0, "resblock_chain": 0, "narrow_chain": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _chain_plain(y, w1s, b1s, w2s, b2s, dilations, slope, round_ops):
    """One residual chain in f32 on [B, C, T]; with round_ops the dot
    operands (activations and weights) are rounded to bf16 first, which with
    f32 accumulation is a bf16 x bf16 -> f32 product."""
    op = _bf16_round if round_ops else (lambda t: t)
    for d, w1, b1, w2, b2 in zip(dilations, w1s, b1s, w2s, b2s):
        k = w1.shape[-1]
        a = op(_leaky(y, slope))
        m = F.conv1d(a, op(w1.float()), b1.float(), padding=(k * d - d) // 2,
                     dilation=d)
        a2 = op(_leaky(m, slope))
        y = y + F.conv1d(a2, op(w2.float()), b2.float(), padding=(k - 1) // 2)
    return y


def mrf_stage_plain(x, chains, dilations, slope: float = 0.1):
    """Mean over chains of the residual chain output (``_direct_mrf``).

    f32 input computes in f32; bf16 input rounds the dot operands to bf16
    and accumulates in f32, as the kernel does, and returns bf16."""
    round_ops = x.dtype == torch.bfloat16
    xf = x.float()
    acc = None
    for (w1s, b1s, w2s, b2s) in chains:
        y = _chain_plain(xf, w1s, b1s, w2s, b2s, dilations, slope, round_ops)
        acc = y if acc is None else acc + y
    return (acc / len(chains)).to(x.dtype)


def resblock_chain_plain(x, w1s, b1s, w2s, b2s, dilations, slope: float = 0.1):
    """One chain (``_direct_chain``), f32 compute, I/O in x's dtype."""
    y = _chain_plain(x.float(), w1s, b1s, w2s, b2s, dilations, slope, False)
    return y.to(x.dtype)


def _memo(fn):
    """``fn`` (a pure planner or route) computed once per arguments, lists
    taken as tuples: the wrappers ask on every call of a host-bound path.
    A refusal (ValueError) is not kept."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def memoised(*args, **kwargs):
        def key(v):
            return tuple(v) if isinstance(v, list) else v
        return cached(*map(key, args), **{k: key(v) for k, v in kwargs.items()})
    return memoised


def _halo(kernel_sizes: Sequence[int], dilations: Sequence[int]) -> int:
    return max((k - 1) // 2 * sum(d + 1 for d in dilations)
               for k in kernel_sizes)


def padded_channels(channels: int) -> int:
    """Channels the kernel runs at: 16, 32 or a multiple of 64 (the extra
    channels are zero in, zero weights, and stay zero)."""
    if channels <= 32:
        return 16 if channels <= 16 else 32
    return -(-channels // 64) * 64


class StagePlan(NamedTuple):
    """K1's geometry for one stage: channels it runs at, blocks of a
    cluster, rows of a block's buffer, rows at each end of the cluster's
    buffer that are computed but not stored, output rows per cluster, weight
    ring stages, shared-memory bytes, accumulator registers a consumer
    thread."""
    cp: int
    cluster: int
    rows: int
    halo: int
    tile: int
    stages: int
    smem: int
    regs: int


@_memo
def stage_plan(channels: int, kernel_sizes: Sequence[int],
               dilations: Sequence[int]) -> StagePlan:
    """K1's plan, or ValueError where the stage does not fit the kernel.

    A block's two consumer warpgroups keep the f32 state of 32768 / cp rows
    in 128 registers a thread (bands of 64 rows, cp / 2 registers each) and
    conv_d's sums in 64 more. The blocks of a cluster hold consecutive rows
    of one buffer and write the 32 rows at their ends into their
    neighbours' guard rows, so no tap may reach further than that. Every
    conv computes all rows; a chain spoils ``halo`` rows at each end of the
    buffer, so a cluster stores cluster * rows - 2 * halo. Shared memory
    holds two bf16 planes of rows + 2 * 32 rows, the ring of 16 KB weight
    stages and the barriers."""
    if channels > MRF_CHANNELS[-1]:
        raise ValueError(f"mrf_stage: C={channels} is over {MRF_CHANNELS[-1]} "
                         "channels: wide stages run per chain (resblock_chain)")
    if any(k < 1 or k % 2 == 0 for k in kernel_sizes) or any(d < 1 for d in dilations):
        raise ValueError("mrf_stage: kernel sizes must be odd, dilations >= 1")
    if not (1 <= len(kernel_sizes) <= MRF_MAX_CHAINS
            and 1 <= len(dilations) <= MRF_MAX_DILATIONS):
        raise ValueError(f"mrf_stage: 1..{MRF_MAX_CHAINS} chains of "
                         f"1..{MRF_MAX_DILATIONS} dilations")
    cp = padded_channels(channels)
    rows = MRF_BLOCK_ELEMS // cp
    halo = _halo(kernel_sizes, dilations)
    reach = max(kernel_sizes) // 2 * max(dilations)
    cluster = MRF_CLUSTER[cp]
    tile = cluster * rows - 2 * halo
    fixed = 2 * (rows + 2 * MRF_GUARD) * cp * 2 + (2 * MRF_MAX_STAGES + 5) * 8
    stages = min(MRF_MAX_STAGES, (SMEM_LIMIT - fixed) // MRF_STAGE_BYTES)
    if tile < 1 or stages < 2 or reach > MRF_GUARD:
        raise ValueError(f"mrf_stage: kernel sizes {tuple(kernel_sizes)} with "
                         f"dilations {tuple(dilations)} do not fit {cluster} "
                         f"blocks of {rows} rows at C={cp}")
    return StagePlan(cp, cluster, rows, halo, tile, stages,
                     fixed + stages * MRF_STAGE_BYTES,
                     MRF_STATE_REGS + MRF_ACC_REGS)


def conv_tile(length: int, blocks_per_tile: int,
              tiles: Sequence[int] = CONV_TILES) -> int:
    """The time tile of K2's conv kernel for a signal of ``length`` steps,
    ``blocks_per_tile`` blocks (channel blocks x batch) on each tile: the
    one of ``tiles`` whose waves of 132 blocks cover the least time, the
    smaller on a tie (a block takes an SM to itself)."""
    def cost(tile):
        return -(-(-(-length // tile) * blocks_per_tile) // H100_SMS) * tile
    return min(tiles, key=cost)


@_memo
def conv_plan(kernel_size: int, dilation: int, tile: int) -> Tuple[int, int, int]:
    """K2's conv kernel at one (K, d, time tile): (rows of an activation
    tile, weight ring stages, shared-memory bytes), stages 0 when not even
    two fit. Shared memory holds ``stages`` weight stages of 32 KB, two
    activation tiles of rows x 32 channels in two planes (big and small),
    and the barriers; none of it depends on C."""
    rows = tile + (kernel_size - 1) * dilation
    fixed = 2 * 2 * rows * CONV_CHUNK * 4 + (2 * CONV_MAX_STAGES + 4) * 8
    stages = min(CONV_MAX_STAGES, (SMEM_LIMIT - fixed) // CONV_STAGE_BYTES)
    if stages < 2:
        return rows, 0, 0
    return rows, stages, fixed + stages * CONV_STAGE_BYTES


@_memo
def conv_taps(kernel_size: int, dilation: int) -> Tuple[Tuple[int, int], ...]:
    """K2's launches for one conv of ``kernel_size`` taps at ``dilation``:
    (first tap, taps) of each. One where the conv's reach fits the conv
    kernel's shared memory at some time tile; else the fewest runs of
    consecutive taps, as even as they come, whose reach fits: each is a
    launch that adds its taps' products into one f32 sum (a lone tap
    always fits). K2 so takes every odd K at every dilation, as JAX's
    ``fused_resblock`` does."""
    n = kernel_size
    while not conv_plan(n, dilation, min(CONV_TILES))[1]:
        n -= 1
    groups = -(-kernel_size // n)
    base, extra = divmod(kernel_size, groups)
    runs, first = [], 0
    for g in range(groups):
        size = base + (g < extra)
        runs.append((first, size))
        first += size
    return tuple(runs)


@_memo
def conv_launch(taps: int, dilation: int, length: int,
                blocks_per_tile: int) -> Tuple[int, int]:
    """(time tile, ring stages) of one K2 launch of ``taps`` taps: the best
    tile (``conv_tile``) among those whose shared memory holds the taps'
    reach."""
    tiles = [t for t in CONV_TILES if conv_plan(taps, dilation, t)[1]]
    if not tiles:
        raise ValueError(f"resblock_chain: {taps} taps at dilation {dilation} "
                         "fit no time tile (conv_taps splits them)")
    tile = conv_tile(length, blocks_per_tile, tiles)
    return tile, conv_plan(taps, dilation, tile)[1]


def narrow_channels(channels: int) -> int:
    """Channels the narrow kernel runs at: 16, 32 or 64 (the extra channels
    are zero in, zero weights, and stay zero)."""
    if channels > NARROW_CHANNELS[-1]:
        raise ValueError(f"narrow chain: C={channels} is over "
                         f"{NARROW_CHANNELS[-1]} channels")
    return next(cp for cp in NARROW_CHANNELS if channels <= cp)


class NarrowPlan(NamedTuple):
    """The narrow kernel's geometry for one launch: channels it runs at,
    blocks of a cluster, rows of a block's buffer, rows at each end of the
    cluster's buffer that the chains spoil, the furthest a tap reaches (the
    edge rows a block sends its neighbour after each plane write), rows a
    cluster stores, weight ring stages, shared-memory bytes, accumulator
    registers a consumer thread."""
    cp: int
    cluster: int
    rows: int
    halo: int
    reach: int
    tile: int
    stages: int
    smem: int
    regs: int


@_memo
def narrow_plan(channels: int, kernel_sizes: Sequence[int],
                dilations: Sequence[int], length: int = 0, batch: int = 1,
                cluster: Optional[int] = None) -> NarrowPlan:
    """The narrow kernel's plan for chains of ``kernel_sizes`` over
    ``dilations`` (one launch on [batch, channels, length]), or ValueError
    where they do not fit it.

    A block's two consumer warpgroups keep the state of 16384 / cp rows and
    conv_d's sums in 64 registers a thread each, and run every conv of
    every chain on all rows of one f32 plane between 128 guard rows above
    and below; no tap may reach further. The blocks of a cluster hold
    consecutive rows of one buffer and send the ``reach`` rows at their
    ends into their neighbours' guard rows after every plane write. A chain
    spoils ``halo`` rows at each end of the cluster's buffer, so a cluster
    stores cluster * rows - 2 * halo. Shared memory holds the plane, the
    ring of 16 KB weight stages and the barriers. The cluster size (1 or 2)
    is the one whose waves of blocks over the card cost least, a 2-block
    cluster's weighed by ``NARROW_EXCHANGE_COST``; ``cluster`` forces one."""
    if any(k < 1 or k % 2 == 0 for k in kernel_sizes) or any(d < 1 for d in dilations):
        raise ValueError("narrow chain: kernel sizes must be odd, dilations >= 1")
    if not (1 <= len(kernel_sizes) <= MRF_MAX_CHAINS
            and 1 <= len(dilations) <= MRF_MAX_DILATIONS):
        raise ValueError(f"narrow chain: 1..{MRF_MAX_CHAINS} chains of "
                         f"1..{MRF_MAX_DILATIONS} dilations")
    cp = narrow_channels(channels)
    rows = NARROW_BLOCK_ELEMS // cp
    halo = _halo(kernel_sizes, dilations)
    reach = max(kernel_sizes) // 2 * max(dilations)
    fixed = (rows + 2 * NARROW_GUARD) * cp * 4 + NARROW_BARRIERS * 8
    stages = min(NARROW_MAX_STAGES, (SMEM_LIMIT - fixed) // NARROW_STAGE_BYTES)

    def cost(n):
        tile = n * rows - 2 * halo
        waves = -(-n * batch * -(-max(length, 1) // tile) // H100_SMS)
        return waves * (1 + NARROW_EXCHANGE_COST * (n - 1)), n
    sizes = [n for n in ((cluster,) if cluster else NARROW_CLUSTERS)
             if n * rows - 2 * halo >= 1]
    if not sizes or stages < 2 or reach > NARROW_GUARD:
        raise ValueError(f"narrow chain: kernel sizes {tuple(kernel_sizes)} with "
                         f"dilations {tuple(dilations)} do not fit "
                         f"{max(NARROW_CLUSTERS)} blocks of {rows} rows at C={cp}")
    n = min(sizes, key=cost)
    return NarrowPlan(cp, n, rows, halo, reach, n * rows - 2 * halo, stages,
                      fixed + stages * NARROW_STAGE_BYTES, NARROW_ACC_REGS)


def _fits(plan: Callable, *args) -> bool:
    try:
        plan(*args)
    except ValueError:
        return False
    return True


@_memo
def stage_route(channels: int, dtype: torch.dtype, kernel_sizes: Sequence[int],
                dilations: Sequence[int]) -> str:
    """The kernel that takes a stage tail (``mrf_stage``): "k1" (one launch
    of K1, bf16), "narrow" (one launch of the narrow kernel, f32, C <= 64),
    or "chains" (each chain through ``resblock_chain``, then the mean in
    f32) where that kernel's planner refuses the stage. The narrow kernel
    was the faster at every shape of every path (chip_smoke.py phase
    `kernels`, PERF.md §6)."""
    if dtype != torch.float32:
        return "k1" if _fits(stage_plan, channels, kernel_sizes, dilations) else "chains"
    if _fits(narrow_plan, channels, kernel_sizes, dilations):  # C <= 64
        return "narrow"
    return "chains"


@_memo
def chain_route(channels: int, dtype: torch.dtype, kernel_size: int,
                dilations: Sequence[int]) -> str:
    """The kernel that takes one chain (``resblock_chain``): "narrow" at C
    <= 64 in f32 or bf16 where the narrow kernel's planner takes the chain
    and a 2-block cluster stores at least ``NARROW_MIN_SHARE`` of its rows;
    else "wide" (K2, which takes every chain)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return "wide"
    try:  # the largest cluster holds the most rows: it fits where any does;
        # the planner refuses C > 64
        plan = narrow_plan(channels, (kernel_size,), dilations, cluster=max(NARROW_CLUSTERS))
    except ValueError:
        return "wide"
    return "narrow" if plan.tile >= NARROW_MIN_SHARE * plan.cluster * plan.rows else "wide"


def _pad_weights(ws, bs, cp: int):
    """Zero-pad conv weights [C, C, K] and biases [C] to cp channels: run on
    an input zero-padded alike, the extra channels start at zero and stay
    zero."""
    c = ws[0].shape[0]
    return ([F.pad(w, (0, 0, 0, cp - c, 0, cp - c)) for w in ws],
            [F.pad(bi, (0, cp - c)) for bi in bs])


def pack_conv_bf16(w: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, K] conv weights (C_in a multiple of 8) -> the
    shared-memory image K1 copies in, flat bf16 [tap][C_in / 8][C_out][8]:
    per tap the B operand of a ``wgmma``, K-major in 16-byte depth groups of
    8 input channels. Element ((tap * C_in / 8 + ci // 8) * C_out + co) * 8
    + ci % 8 is W[co, ci, tap]."""
    c_out, c_in, k = w.shape
    wt = w.to(torch.bfloat16).permute(2, 1, 0).reshape(k, c_in // 8, 8, c_out)
    return wt.permute(0, 1, 3, 2).contiguous().reshape(-1)


def split_tf32(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 operand split of an f32 tensor: big = w with its low 13
    mantissa bits cleared (what a tensor core reads of w), small = w - big,
    exact in f32."""
    w = w.float().contiguous()
    big = (w.view(torch.int32) & -8192).view(torch.float32)
    return big, w - big


def pack_conv_tf32(w: torch.Tensor) -> torch.Tensor:
    """[C_out, C_in, K] f32 conv weights (C_in a multiple of 32) -> the
    shared-memory images K2's conv kernel copies in, flat:
    [C_out block of 128][C_in chunk of 32][tap][plane][group of 4 C_in]
    [128 C_out rows][4], plane 0 the big and plane 1 the small parts; rows
    past C_out are zero. One (block, chunk, tap) is 32 KB, contiguous."""
    c_out, c_in, k = w.shape
    blocks = -(-c_out // CONV_BLOCK)
    w = F.pad(w.float(), (0, 0, 0, 0, 0, blocks * CONV_BLOCK - c_out))
    planes = torch.stack(split_tf32(w))                  # [2, C_out, C_in, K]
    planes = planes.reshape(2, blocks, CONV_BLOCK, c_in // CONV_CHUNK, 8, 4, k)
    return planes.permute(1, 3, 6, 0, 4, 2, 5).contiguous().reshape(-1)


def pack_conv_narrow(w: torch.Tensor) -> torch.Tensor:
    """[C, C, K] f32 conv weights (C a multiple of 8) -> the shared-memory
    images the narrow kernel streams in, flat f32
    [tap][C_in / 8][plane][group of 4 C_in][C_out][4]: per (tap, 8-channel
    depth step) one unit of 64 * C bytes, plane 0 the big and plane 1 the
    small parts, each the B operand of a ``wgmma`` (K-major, two 16-byte
    depth groups). Element ((((tap * C/8 + ci // 8) * 2 + plane) * 2
    + ci % 8 // 4) * C + co) * 4 + ci % 4 is that plane of W[co, ci, tap]."""
    c_out, c_in, k = w.shape
    planes = torch.stack(split_tf32(w))                  # [2, C_out, C_in, K]
    planes = planes.reshape(2, c_out, c_in // 8, 2, 4, k)
    return planes.permute(5, 2, 0, 3, 1, 4).contiguous().reshape(-1)


class PackedStage(NamedTuple):
    """K1's (or the narrow kernel's) weights of one launch: the convs'
    images one after the other (chain-major, conv_d then conv_1 per
    dilation), biases [n_convs, cp]."""
    w: torch.Tensor
    bias: torch.Tensor


class PackedChain(NamedTuple):
    """K2's weights of one chain: per conv (conv_d then conv_1 of each
    dilation) the packed planes of each run of taps (``conv_taps``), and
    biases [n_convs + 1, blocks * 128], the last row zero (the bias of a
    conv's later runs)."""
    ws: Tuple[Tuple[torch.Tensor, ...], ...]
    bias: torch.Tensor


def _stage_convs(chains, cp: int):
    """Every conv's weights and bias, chain-major, conv_d then conv_1 per
    dilation, zero-padded to cp channels."""
    ws, bs = [], []
    for (w1s, b1s, w2s, b2s) in chains:
        for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
            ws += [w1, w2]
            bs += [b1.float(), b2.float()]
    if cp != ws[0].shape[0]:
        ws, bs = _pad_weights(ws, bs, cp)
    return ws, torch.stack(bs).contiguous()


def pack_stage(chains, cp: int) -> PackedStage:
    ws, bias = _stage_convs(chains, cp)
    return PackedStage(torch.cat([pack_conv_bf16(w) for w in ws]), bias)


def pack_narrow(chains, cp: int) -> PackedStage:
    ws, bias = _stage_convs(chains, cp)
    return PackedStage(torch.cat([pack_conv_narrow(w) for w in ws]), bias)


def pack_chain(w1s, b1s, w2s, b2s, cp: int, dilations: Sequence[int]) -> PackedChain:
    ws, bs, runs = [], [], []
    for d, w1, b1, w2, b2 in zip(dilations, w1s, b1s, w2s, b2s):
        ws += [w1, w2]
        bs += [b1.float(), b2.float()]
        runs += [conv_taps(w1.shape[-1], d), conv_taps(w2.shape[-1], 1)]
    c = ws[0].shape[0]
    rows = -(-cp // CONV_BLOCK) * CONV_BLOCK
    bias = [F.pad(bi, (0, rows - c)) for bi in bs]
    return PackedChain(
        tuple(tuple(pack_conv_tf32(F.pad(w[:, :, first:first + n], (0, 0, 0, cp - c)))
                    for first, n in run) for w, run in zip(ws, runs)),
        torch.stack(bias + [torch.zeros_like(bias[0])]).contiguous())


def _chain_tensors(chains):
    return [t for ch in chains for part in ch for t in part]


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, T], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.shape[1] > 512:
        raise ValueError(f"{name}: at most 512 channels")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _typed(lib, fn: str, argtypes):
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def _stage_fn(extra_flags: Tuple[str, ...] = ()):
    """K1's entry point; ``extra_flags`` name a timing variant of the source
    (``tools/mrf_ablation.py``), never the port's own build."""
    from ._build import load

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    return _typed(load("resblock", extra_flags), "rvc_mrf_stage",
                  [p, p, p, p, p, i, i, i, i, i, i, i, i, ip, i, ip, f, i, p])


def _conv_fn():
    from ._build import load

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _typed(load("resblock_chain"), "rvc_conv_tf32",
                  [p, i, p, i, p, i, p, p, i, i, i, i, i, i, i, i, i, i, i, f, p])


def _narrow_fn():
    from ._build import load

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    return _typed(load("resblock_narrow"), "rvc_narrow_chain",
                  [p, i, p, p, p, i, i, i, i, i, i, i, i, i, ip, i, ip, f, p])


def _chain_direct(y, w1s, b1s, w2s, b2s, dilations, slope):
    """One chain through plain convolutions in y's dtype (weights and biases
    cast to it), as the JAX package's ``_direct_chain``: the recompute the
    backward differentiates."""
    for d, w1, b1, w2, b2 in zip(dilations, w1s, b1s, w2s, b2s):
        k = w1.shape[-1]
        m = F.conv1d(_leaky(y, slope), w1.to(y.dtype), b1.to(y.dtype),
                     padding=(k * d - d) // 2, dilation=d)
        y = y + F.conv1d(_leaky(m, slope), w2.to(y.dtype), b2.to(y.dtype),
                         padding=(k - 1) // 2)
    return y


def _mrf_direct(x, chains, dilations, slope):
    """Mean over chains of ``_chain_direct`` (``_direct_mrf``)."""
    acc = None
    for chain in chains:
        y = _chain_direct(x, *chain, dilations, slope)
        acc = y if acc is None else acc + y
    return acc / len(chains)


def _unflatten_chains(flat, n_dil: int):
    """The flat tensor list of ``_chain_tensors`` -> per chain (w1s, b1s,
    w2s, b2s)."""
    parts = [list(flat[i:i + n_dil]) for i in range(0, len(flat), n_dil)]
    return [tuple(parts[i:i + 4]) for i in range(0, len(parts), 4)]


def _recompute_grads(ctx, direct, g):
    """Backward of both Functions: rerun ``direct`` on the saved inputs
    under autograd and pull the cotangent g back to the inputs that need a
    gradient (None for the others)."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[-len(saved):]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        out = direct(inputs[0], inputs[1:])
        wanted = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(out, wanted, g)) if wanted else iter(())
    return [next(got) if n else None for n in need]


class _MrfStage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel_sizes, dilations, slope, cache, x, *flat):
        ctx.dilations, ctx.slope = dilations, slope
        ctx.save_for_backward(x, *flat)
        return _mrf_stage_forward(x, _unflatten_chains(flat, len(dilations)),
                                  kernel_sizes, dilations, slope, cache)

    @staticmethod
    def backward(ctx, g):
        dil, slope = ctx.dilations, ctx.slope
        return (None, None, None, None, *_recompute_grads(
            ctx, lambda x, flat: _mrf_direct(
                x, _unflatten_chains(flat, len(dil)), dil, slope), g))


class _ResblockChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dilations, slope, cache, x, *flat):
        ctx.dilations, ctx.slope = dilations, slope
        ctx.save_for_backward(x, *flat)
        return _resblock_chain_forward(
            x, *_unflatten_chains(flat, len(dilations))[0], dilations, slope, cache)

    @staticmethod
    def backward(ctx, g):
        dil, slope = ctx.dilations, ctx.slope
        return (None, None, None, *_recompute_grads(
            ctx, lambda x, flat: _chain_direct(
                x, *_unflatten_chains(flat, len(dil))[0], dil, slope), g))


@profiling.annotated("rvc.stage_tails")
def mrf_stage(x, chains, kernel_sizes: Sequence[int],
              dilations: Sequence[int], slope: float = 0.1,
              cache: Optional[WeightCache] = None) -> torch.Tensor:
    """One decoder stage tail, the mean over the parallel chains.

    x [B, C, T] f32 or bf16; chains: per chain (w1s, b1s, w2s, b2s). bf16
    input is one launch of K1 (bf16 operands into f32 sums). f32 input keeps
    f32 precision: at C <= 64 one launch of the narrow kernel (3xTF32, the
    mean over the chains in its last store), wider each chain through K2's
    3xTF32 conv kernel and the mean in f32 (``stage_route``). With a
    ``cache`` the packed weights are kept between calls. The
    gradient with respect to x and every weight and bias is the plain-conv
    recompute's (``_MrfStage``)."""
    return _MrfStage.apply(tuple(kernel_sizes), tuple(dilations), slope, cache,
                           x, *_chain_tensors(chains))


def _mrf_stage_forward(x, chains, kernel_sizes, dilations, slope, cache):
    """The stage on the card, as ``stage_route`` says: one launch of K1
    (bf16) or of the narrow kernel (f32), or its chains one by one."""
    if x.device.type == "cpu":
        return mrf_stage_plain(x, chains, dilations, slope)
    _check_input(x, "mrf_stage")
    cache = cache or WeightCache()
    c = x.shape[1]
    route = stage_route(c, x.dtype, kernel_sizes, dilations)
    if route == "narrow":
        return _narrow_forward(x, chains, kernel_sizes, dilations, slope, cache)
    if route == "chains":
        return _stage_chains(x, chains, dilations, slope, cache)
    plan = stage_plan(c, kernel_sizes, dilations)
    packed = cache.get(_chain_tensors(chains), ("stage", plan.cp),
                       lambda: pack_stage(chains, plan.cp))
    if plan.cp != c:
        x = F.pad(x, (0, 0, 0, plan.cp - c))
    out = _launch_stage(_stage_fn(), x, plan, packed, kernel_sizes, dilations, slope)
    launches["mrf_stage"] += 1
    return out if plan.cp == c else out[:, :c].contiguous()


def _stage_chains(x, chains, dilations, slope, cache):
    """A stage as its chains one by one (each through the routed
    ``_resblock_chain_forward``), then the mean in f32, in x's dtype."""
    chain_caches = cache.get(_chain_tensors(chains), ("chains", len(chains)),
                             lambda: tuple(WeightCache() for _ in chains))
    acc = None
    for ch, chain_cache in zip(chains, chain_caches):
        y = _resblock_chain_forward(x, *ch, dilations, slope, chain_cache).float()
        acc = y if acc is None else acc.add_(y)
    return acc.div_(len(chains)).to(x.dtype)


def _launch_stage(fn, x, plan: StagePlan, packed: PackedStage, kernel_sizes,
                  dilations, slope: float) -> torch.Tensor:
    """One launch of K1 (``fn``: ``_stage_fn``'s) on bf16 x [B, plan.cp, T]."""
    b, _, t = x.shape
    out = torch.empty_like(x)
    # persistent blocks, at most one per SM, each with its scratch for the
    # sum over chains
    max_blocks = min(plan.cluster * b * -(-t // plan.tile),
                     torch.cuda.get_device_properties(x.device).multi_processor_count)
    scratch = torch.empty((max_blocks, MRF_STATE_REGS, MRF_CONSUMERS),
                          dtype=torch.float32, device=x.device)
    # the library's runtime calls (the shared-memory attribute, the cluster
    # occupancy, the launch) act on the thread's current device
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), out.data_ptr(), packed.w.data_ptr(),
            packed.bias.data_ptr(), scratch.data_ptr(), b, plan.cp, t,
            plan.cluster, plan.tile, plan.halo, plan.stages,
            len(kernel_sizes), _ints(kernel_sizes), len(dilations),
            _ints(dilations), slope, max_blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage: CUDA error {err} at launch")
    return out


@profiling.annotated("rvc.stage_tails")
def resblock_chain(x, w1s, b1s, w2s, b2s, dilations: Sequence[int],
                   slope: float = 0.1,
                   cache: Optional[WeightCache] = None) -> torch.Tensor:
    """One ResBlock chain, f32 compute (3xTF32), I/O in x's dtype. At C <=
    64 one launch of the narrow kernel (``chain_route``); wider, K2: two
    launches of the conv kernel per dilation (conv_d into an f32 scratch,
    then conv_1 with the residual), the state between dilations in f32.
    Each launch adds one to its kernel's count. With a ``cache`` the split
    and packed weights are kept between calls. The gradient is the
    plain-conv recompute's (``_ResblockChain``)."""
    return _ResblockChain.apply(tuple(dilations), slope, cache, x,
                                *_chain_tensors([(w1s, b1s, w2s, b2s)]))


def _narrow_forward(x, chains, kernel_sizes, dilations, slope, cache):
    """One launch of the narrow kernel on x [B, C <= 64, T]: one chain, or
    the mean of several (f32)."""
    b, c, t = x.shape
    plan = narrow_plan(c, kernel_sizes, dilations, t, b)
    packed = cache.get(_chain_tensors(chains), ("narrow", plan.cp),
                       lambda: pack_narrow(chains, plan.cp))
    if plan.cp != c:
        x = F.pad(x, (0, 0, 0, plan.cp - c))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):  # the launch acts on the current device
        err = _narrow_fn()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            packed.w.data_ptr(), packed.bias.data_ptr(), b, plan.cp, t,
            plan.cluster, plan.tile, plan.halo, plan.reach, plan.stages,
            len(kernel_sizes), _ints(kernel_sizes), len(dilations), _ints(dilations),
            slope, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"narrow chain: CUDA error {err} at launch")
    launches["narrow_chain"] += 1
    return out if plan.cp == c else out[:, :c].contiguous()


def _resblock_chain_forward(x, w1s, b1s, w2s, b2s, dilations, slope, cache):
    """The chain on the card through the narrow kernel or K2, as
    ``chain_route`` says."""
    if x.device.type == "cpu":
        return resblock_chain_plain(x, w1s, b1s, w2s, b2s, dilations, slope)
    _check_input(x, "resblock_chain")
    cache = cache or WeightCache()
    k = int(w1s[0].shape[-1])
    if chain_route(x.shape[1], x.dtype, k, dilations) == "narrow":
        return _narrow_forward(x, [(w1s, b1s, w2s, b2s)], (k,), dilations, slope, cache)
    return _chain_wide(x, w1s, b1s, w2s, b2s, dilations, slope, cache)


def _chain_wide(x, w1s, b1s, w2s, b2s, dilations, slope, cache):
    """K2: per dilation, conv_d into an f32 scratch m (leaky(m)), then
    conv_1 on it with the residual. A conv whose reach fits no time tile
    runs as runs of taps (``conv_taps``) that add into one f32 sum, the
    bias with the first; conv_d's sum then stays raw and conv_1 applies the
    leaky ReLU as it reads m."""
    b, c, t = x.shape
    k = int(w1s[0].shape[-1])
    cp = -(-c // CONV_CHUNK) * CONV_CHUNK
    blocks = -(-cp // CONV_BLOCK)
    packed = cache.get(
        [*w1s, *b1s, *w2s, *b2s], ("chain", cp, tuple(dilations)),
        lambda: pack_chain(w1s, b1s, w2s, b2s, cp, dilations))
    if cp != c:
        x = F.pad(x, (0, 0, 0, cp - c))
    fn = _conv_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    m = torch.empty((b, cp, t), dtype=torch.float32, device=x.device)
    state = [torch.empty_like(m) for _ in range(min(2, len(dilations) - 1))]

    def launch(w, bias, first, n, d, src, res, dst, pre, post):
        tile, stages = conv_launch(n, d, t, blocks * b)
        err = fn(src.data_ptr(), int(src.dtype == torch.bfloat16),
                 res.data_ptr() if res is not None else None,
                 int(res is not None and res.dtype == torch.bfloat16),
                 dst.data_ptr(), int(dst.dtype == torch.bfloat16),
                 w.data_ptr(), bias.data_ptr(), b, cp, blocks, t, n, d,
                 (first - k // 2) * d, tile, stages, pre, post, slope, stream)
        if err != 0:
            raise RuntimeError(f"resblock_chain: CUDA error {err} at launch")
        launches["resblock_chain"] += 1

    def conv(i, d, src, res, dst, pre, post):
        """Conv i of the chain: dst = post(bias + conv(pre(src))) + res; a
        conv of several runs of taps sums them in f32 (in dst where it is
        f32) and takes no post."""
        runs = conv_taps(k, d)
        if len(runs) == 1:
            launch(packed.ws[i][0], packed.bias[i], 0, k, d, src, res, dst, pre, post)
            return
        acc = dst if dst.dtype == torch.float32 else torch.empty_like(m)
        for j, ((first, n), w) in enumerate(zip(runs, packed.ws[i])):
            last = j == len(runs) - 1
            launch(w, packed.bias[i if j == 0 else -1], first, n, d, src,
                   res if j == 0 else acc, dst if last else acc, pre, 0)

    y = x
    with torch.cuda.device(x.device):  # the launches act on the current device
        for i, d in enumerate(dilations):
            whole = len(conv_taps(k, d)) == 1
            conv(2 * i, d, y, None, m, 1, int(whole))
            nxt = out if i == len(dilations) - 1 else state[i % 2]
            conv(2 * i + 1, 1, m, y, nxt, int(not whole), 0)
            y = nxt
    return out if cp == c else out[:, :c].contiguous()
