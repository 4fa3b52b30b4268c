"""HiFi-GAN stage tails: kernels K1 ``mrf_stage`` and K2 ``resblock_chain``.

Counterparts of ``rvc_tpu/ops/resblock_pallas.py``'s ``fused_mrf`` and
``fused_resblock``. Each wrapper launches its kernel for a CUDA tensor and
takes its plain PyTorch version (``mrf_stage_plain`` /
``resblock_chain_plain``) only for a CPU tensor.

Signals are [B, C, T]. Weights are the folded (weight-norm applied) conv
weights in torch layout [C_out, C_in, K], one per dilation, and biases [C];
each wrapper packs them for its kernel, and keeps the packed weights in the
``WeightCache`` the caller hands it, so that a module packs once.

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
of one ``wgmma`` 3xTF32 conv kernel per dilation; an f32 stage of
``mrf_stage`` runs its chains through K2 as well, then takes the mean.
Forward only: the backward for training comes with the training port.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import H100_SMS

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

launches = {"mrf_stage": 0, "resblock_chain": 0}


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


def conv_tile(length: int, blocks_per_tile: int) -> int:
    """The time tile of K2's conv kernel for a signal of ``length`` steps,
    ``blocks_per_tile`` blocks (channel blocks x batch) on each tile: the
    one whose waves of 132 blocks cover the least time, the smaller on a
    tie (a block takes an SM to itself)."""
    def cost(tile):
        return -(-(-(-length // tile) * blocks_per_tile) // H100_SMS) * tile
    return min(CONV_TILES, key=cost)


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


class WeightCache:
    """Packed weights of one module, built at first use and rebuilt when one
    of the tensors they were made from is replaced, modified in place, or
    moved (identity, ``_version``, storage, dtype, device)."""

    def __init__(self):
        self._key = None
        self._refs = None  # keeps the key's tensors alive: ids stay unique
        self._value = None
        self.builds = 0

    def get(self, tensors: Sequence[torch.Tensor], extra, build: Callable):
        key = (extra, tuple((id(t), t._version, t.data_ptr(), t.dtype, t.device)
                            for t in tensors))
        if key != self._key:
            self._value = build()
            self._key, self._refs = key, list(tensors)
            self.builds += 1
        return self._value


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


class PackedStage(NamedTuple):
    """K1's weights of one stage: the convs' images one after the other
    (chain-major, conv_d then conv_1 per dilation), biases [n_convs, cp]."""
    w: torch.Tensor
    bias: torch.Tensor


class PackedChain(NamedTuple):
    """K2's weights of one chain: per conv (conv_d then conv_1 of each
    dilation) the packed planes, and biases [n_convs, blocks * 128]."""
    ws: Tuple[torch.Tensor, ...]
    bias: torch.Tensor


def pack_stage(chains, cp: int) -> PackedStage:
    ws, bs = [], []
    for (w1s, b1s, w2s, b2s) in chains:
        for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
            ws += [w1, w2]
            bs += [b1.float(), b2.float()]
    if cp != ws[0].shape[0]:
        ws, bs = _pad_weights(ws, bs, cp)
    return PackedStage(torch.cat([pack_conv_bf16(w) for w in ws]),
                       torch.stack(bs).contiguous())


def pack_chain(w1s, b1s, w2s, b2s, cp: int) -> PackedChain:
    ws, bs = [], []
    for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
        ws += [w1, w2]
        bs += [b1.float(), b2.float()]
    c = ws[0].shape[0]
    rows = -(-cp // CONV_BLOCK) * CONV_BLOCK
    return PackedChain(
        tuple(pack_conv_tf32(F.pad(w, (0, 0, 0, cp - c))) for w in ws),
        torch.stack([F.pad(bi, (0, rows - c)) for bi in bs]).contiguous())


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
                  [p, i, p, i, p, i, p, p, i, i, i, i, i, i, i, i, i, i, f, p])


def mrf_stage(x, chains, kernel_sizes: Sequence[int],
              dilations: Sequence[int], slope: float = 0.1,
              cache: Optional[WeightCache] = None) -> torch.Tensor:
    """One decoder stage tail, the mean over the parallel chains.

    x [B, C, T] f32 or bf16; chains: per chain (w1s, b1s, w2s, b2s). bf16
    input is one launch of K1 (bf16 operands into f32 sums). f32 input keeps
    f32 precision: each chain runs through K2's 3xTF32 conv kernel
    (``resblock_chain``, which counts its launches) and the mean is taken in
    f32. With a ``cache`` the packed weights are kept between calls."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, chains, dilations, slope)
    _check_input(x, "mrf_stage")
    cache = cache or WeightCache()
    if x.dtype == torch.float32:
        chain_caches = cache.get(_chain_tensors(chains), ("stage_f32", len(chains)),
                                 lambda: tuple(WeightCache() for _ in chains))
        acc = None
        for chain, chain_cache in zip(chains, chain_caches):
            y = resblock_chain(x, *chain, dilations, slope, cache=chain_cache)
            acc = y if acc is None else acc.add_(y)
        return acc.div_(len(chains))
    c = x.shape[1]
    plan = stage_plan(c, kernel_sizes, dilations)
    packed = cache.get(_chain_tensors(chains), ("stage", plan.cp),
                       lambda: pack_stage(chains, plan.cp))
    if plan.cp != c:
        x = F.pad(x, (0, 0, 0, plan.cp - c))
    out = _launch_stage(_stage_fn(), x, plan, packed, kernel_sizes, dilations, slope)
    launches["mrf_stage"] += 1
    return out if plan.cp == c else out[:, :c].contiguous()


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


def resblock_chain(x, w1s, b1s, w2s, b2s, dilations: Sequence[int],
                   slope: float = 0.1,
                   cache: Optional[WeightCache] = None) -> torch.Tensor:
    """K2: one ResBlock chain, f32 compute (3xTF32), I/O in x's dtype: two
    launches of the conv kernel per dilation (conv_d into an f32 scratch,
    then conv_1 with the residual), the state between dilations in f32.
    Each launch adds one to the count. With a ``cache`` the split and
    packed weights are kept between calls."""
    dilations = tuple(dilations)
    if x.device.type == "cpu":
        return resblock_chain_plain(x, w1s, b1s, w2s, b2s, dilations, slope)
    _check_input(x, "resblock_chain")
    b, c, t = x.shape
    k = int(w1s[0].shape[-1])
    cp = -(-c // CONV_CHUNK) * CONV_CHUNK
    blocks = -(-cp // CONV_BLOCK)
    tile = conv_tile(t, blocks * b)
    plans = [conv_plan(k, d, tile) for d in dilations] + [conv_plan(k, 1, tile)]
    if not all(p[1] for p in plans):
        raise ValueError(f"resblock_chain: K={k}, dilations {dilations} do "
                         "not fit shared memory")
    packed = (cache or WeightCache()).get(
        [*w1s, *b1s, *w2s, *b2s], ("chain", cp),
        lambda: pack_chain(w1s, b1s, w2s, b2s, cp))
    if cp != c:
        x = F.pad(x, (0, 0, 0, cp - c))
    fn = _conv_fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty_like(x)
    m = torch.empty((b, cp, t), dtype=torch.float32, device=x.device)
    state = [torch.empty_like(m) for _ in range(min(2, len(dilations) - 1))]

    def conv(i, src, res, dst, d, stages, act):
        err = fn(src.data_ptr(), int(src.dtype == torch.bfloat16),
                 res.data_ptr() if res is not None else None,
                 int(res is not None and res.dtype == torch.bfloat16),
                 dst.data_ptr(), int(dst.dtype == torch.bfloat16),
                 packed.ws[i].data_ptr(), packed.bias[i].data_ptr(), b, cp,
                 blocks, t, k, d, tile, stages, act, act, slope, stream)
        if err != 0:
            raise RuntimeError(f"resblock_chain: CUDA error {err} at launch")
        launches["resblock_chain"] += 1

    y = x
    for i, d in enumerate(dilations):
        conv(2 * i, y, None, m, d, plans[i][1], 1)
        nxt = out if i == len(dilations) - 1 else state[i % 2]
        conv(2 * i + 1, m, y, nxt, 1, plans[-1][1], 0)
        y = nxt
    return out if cp == c else out[:, :c].contiguous()
