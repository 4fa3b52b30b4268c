"""HiFi-GAN stage tails: kernels K1 ``mrf_stage`` and K2 ``resblock_chain``.

Counterparts of ``rvc_tpu/ops/resblock_pallas.py``'s ``fused_mrf`` and
``fused_resblock``. Each wrapper launches its kernel for a CUDA tensor and
takes its plain PyTorch version (``mrf_stage_plain`` /
``resblock_chain_plain``) only for a CPU tensor.

Signals are [B, C, T]. Weights are the folded (weight-norm applied) conv
weights in torch layout [C_out, C_in, K], one per dilation, and biases [C];
each wrapper packs them for its kernel, and keeps the packed weights in the
``WeightCache`` the caller hands it, so that a module packs once.

K1 (``csrc/resblock.cu``, C <= 128) runs every chain of a stage in one
``mma.sync`` launch, bf16 products on bf16 input and 3xTF32 on f32 input.
K2 (``csrc/resblock_chain.cu``, wide stages) runs a chain as two launches
of one ``wgmma`` 3xTF32 conv kernel per dilation.
Forward only: the backward for training comes with the training port.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import H100_SMS

# shared memory a block may use on Hopper (232,448 bytes); K1's warps and
# the rows of one warp item
SMEM_LIMIT = 232_448
WARPS = 8
WARP_ROWS = 32
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


def plan(channels: int, kernel_sizes: Sequence[int], dilations: Sequence[int],
         ops_bf16: bool) -> Tuple[int, int]:
    """K1's (nt, tile) of one launch, or (0, 0) when the buffers do not fit
    shared memory. nt: 8-channel tiles per warp item; tile: output rows per
    block. Each buffer row holds the f32 state and the conv1 operand (bf16
    or f32), padded by 8 (bf16) or 4 (f32) channels. The tile is 32 rows per
    warp row of the last conv, so the sum over chains stays in registers;
    the widest nt whose tile fits."""
    cp = padded_channels(channels)
    row_bytes = (cp + 8) * 6 if ops_bf16 else (cp + 4) * 8
    halo = _halo(kernel_sizes, dilations)
    for nt in (8, 4, 2):
        ncg = cp // (8 * nt)
        if cp % (8 * nt) == 0 and WARPS % ncg == 0:
            tile = WARPS * WARP_ROWS // ncg
            if (tile + 2 * halo) * row_bytes <= SMEM_LIMIT:
                return nt, tile
    return 0, 0


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


def _pack_fragments(ws, ops_bf16: bool) -> torch.Tensor:
    """[C_out, C_in, K] conv weights -> the B fragments of one lane each,
    per conv [K][C_in/kk][C_out/8][32 lanes][e]; lane 4g + q holds
    c_out = 8 nt + g and
      bf16 (``mma.sync.m16n8k16``, kk = 16, e = 4): c_in = 16 kc + (2q,
        2q+1, 2q+8, 2q+9), as bf16;
      f32 (``mma.sync.m16n8k8`` tf32, kk = 8, e = 2): c_in = 8 kc + (q, q+4).
    """
    packed = []
    for w in ws:
        c_out, c_in, k = w.shape
        wt = w.float().permute(2, 1, 0)                    # [K, C_in, C_out]
        if ops_bf16:
            wt = wt.reshape(k, c_in // 16, 2, 4, 2, c_out // 8, 8)  # k kc h q p nt g
            packed.append(wt.permute(0, 1, 5, 6, 3, 2, 4).reshape(-1))
        else:
            wt = wt.reshape(k, c_in // 8, 2, 4, c_out // 8, 8)  # k kc h q nt g
            packed.append(wt.permute(0, 1, 4, 5, 3, 2).reshape(-1))
    w = torch.cat(packed)
    return (w.to(torch.bfloat16) if ops_bf16 else w).contiguous()


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
    """K1's weights of one stage: B fragments, biases [n_convs, cp]."""
    w: torch.Tensor
    bias: torch.Tensor


class PackedChain(NamedTuple):
    """K2's weights of one chain: per conv (conv_d then conv_1 of each
    dilation) the packed planes, and biases [n_convs, blocks * 128]."""
    ws: Tuple[torch.Tensor, ...]
    bias: torch.Tensor


def pack_stage(chains, cp: int, ops_bf16: bool) -> PackedStage:
    ws, bs = [], []
    for (w1s, b1s, w2s, b2s) in chains:
        for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
            ws += [w1, w2]
            bs += [b1.float(), b2.float()]
    if cp != ws[0].shape[0]:
        ws, bs = _pad_weights(ws, bs, cp)
    return PackedStage(_pack_fragments(ws, ops_bf16), torch.stack(bs).contiguous())


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


def _stage_fn():
    from ._build import load

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    return _typed(load("resblock"), "rvc_resblock_stage",
                  [p, p, p, p, i, i, i, i, i, i, ip, i, ip, f, i, p])


def _conv_fn():
    from ._build import load

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _typed(load("resblock_chain"), "rvc_conv_tf32",
                  [p, i, p, i, p, i, p, p, i, i, i, i, i, i, i, i, i, i, f, p])


def mrf_stage(x, chains, kernel_sizes: Sequence[int],
              dilations: Sequence[int], slope: float = 0.1,
              cache: Optional[WeightCache] = None) -> torch.Tensor:
    """K1: one decoder stage tail, the mean over the parallel chains.

    x [B, C, T] f32 or bf16; chains: per chain (w1s, b1s, w2s, b2s). bf16
    input multiplies bf16 operands into f32, f32 input runs 3xTF32. With a
    ``cache`` the packed weights are kept between calls."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, chains, dilations, slope)
    _check_input(x, "mrf_stage")
    b, c, t = x.shape
    ops_bf16 = x.dtype == torch.bfloat16
    nt, tile = plan(c, kernel_sizes, dilations, ops_bf16)
    if not tile:
        raise ValueError(f"mrf_stage: C={c} does not fit shared memory")
    cp = padded_channels(c)
    packed = (cache or WeightCache()).get(
        _chain_tensors(chains), ("stage", cp, ops_bf16),
        lambda: pack_stage(chains, cp, ops_bf16))
    if cp != c:
        x = F.pad(x, (0, 0, 0, cp - c))
    out = torch.empty_like(x)
    err = _stage_fn()(
        x.data_ptr(), out.data_ptr(), packed.w.data_ptr(),
        packed.bias.data_ptr(), b, cp, t, tile, nt, len(kernel_sizes),
        _ints(kernel_sizes), len(dilations), _ints(dilations), slope,
        int(ops_bf16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mrf_stage: CUDA error {err} at launch")
    launches["mrf_stage"] += 1
    return out if cp == c else out[:, :c].contiguous()


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
