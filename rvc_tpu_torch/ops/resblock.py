"""HiFi-GAN stage tails: kernels K1 ``mrf_stage`` and K2 ``resblock_chain``.

Counterparts of ``rvc_tpu/ops/resblock_pallas.py``'s ``fused_mrf`` and
``fused_resblock``; the CUDA source is ``csrc/resblock.cu``. Each wrapper
launches its kernel for a CUDA tensor and takes its plain PyTorch version
(``mrf_stage_plain`` / ``resblock_chain_plain``) only for a CPU tensor.

Signals are [B, C, T]. Weights are the folded (weight-norm applied) conv
weights in torch layout [C_out, C_in, K], one per dilation, and biases [C];
each wrapper packs them for its kernel. Both run the one tensor-core kernel
of the source: K1 with bf16 products on bf16 input and 3xTF32 on f32
input, K2 in 3xTF32.
Forward only: the backward for training comes with the training port.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# shared memory a block may use on Hopper (232,448 bytes); the kernel's
# warps and the rows of one warp item; K2's tile candidates (output rows
# per block)
SMEM_LIMIT = 232_448
WARPS = 8
WARP_ROWS = 32
_TILES = (512, 448, 384, 320, 256, 192, 128, 96, 64, 48, 32)

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
         ops_bf16: bool, mean: bool) -> Tuple[int, int]:
    """(nt, tile) of one launch, or (0, 0) when the buffers do not fit
    shared memory. nt: 8-channel tiles per warp item; tile: output rows per
    block. Each buffer row holds the f32 state and the conv1 operand (bf16
    or f32), padded by 8 (bf16) or 4 (f32) channels.

    mean (K1): the tile is 32 rows per warp row of the last conv, so the sum
    over chains stays in registers; the widest nt whose tile fits. Else (K2,
    one chain): nt = min(C, 64) / 8 and the largest candidate tile."""
    cp = padded_channels(channels)
    row_bytes = (cp + 8) * 6 if ops_bf16 else (cp + 4) * 8
    halo = _halo(kernel_sizes, dilations)

    def fits(tile: int) -> bool:
        return (tile + 2 * halo) * row_bytes <= SMEM_LIMIT

    if mean:
        for nt in (8, 4, 2):
            ncg = cp // (8 * nt)
            if cp % (8 * nt) == 0 and WARPS % ncg == 0 \
                    and fits(WARPS * WARP_ROWS // ncg):
                return nt, WARPS * WARP_ROWS // ncg
        return 0, 0
    for tile in _TILES:
        if fits(tile):
            return min(cp, 64) // 8, tile
    return 0, 0


def _pad_channels(x, ws, bs, cp: int):
    """Zero-pad x [B, C, T], conv weights [C, C, K] and biases [C] to cp
    channels: the extra channels start at zero and stay zero."""
    c = x.shape[1]
    return (F.pad(x, (0, 0, 0, cp - c)),
            [F.pad(w, (0, 0, 0, cp - c, 0, cp - c)) for w in ws],
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


def _lib():
    from ._build import load

    lib = load("resblock")
    if not getattr(lib, "_rvc_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        lib.rvc_resblock_stage.argtypes = [p, p, p, p, i, i, i, i, i, i, ip, i,
                                           ip, f, i, i, i, p]
        lib.rvc_resblock_stage.restype = i
        lib._rvc_typed = True
    return lib


def _launch(name: str, x: torch.Tensor, convs, kernel_sizes, dilations,
            slope: float, ops_bf16: bool, mean: bool) -> torch.Tensor:
    """One launch of the stage kernel over ``convs`` ((w, b) pairs, chain
    by chain, conv1 then conv2 per dilation)."""
    b, c, t = x.shape
    nt, tile = plan(c, kernel_sizes, dilations, ops_bf16, mean)
    if not tile:
        raise ValueError(f"{name}: C={c} does not fit shared memory")
    cp = padded_channels(c)
    ws = [w for w, _ in convs]
    bs = [bi.float() for _, bi in convs]
    if cp != c:
        x, ws, bs = _pad_channels(x, ws, bs, cp)
    w = _pack_fragments(ws, ops_bf16)
    bias = torch.stack(bs).contiguous()
    out = torch.empty_like(x)
    err = _lib().rvc_resblock_stage(
        x.data_ptr(), out.data_ptr(), w.data_ptr(), bias.data_ptr(), b, cp, t,
        tile, nt, len(kernel_sizes), _ints(kernel_sizes), len(dilations),
        _ints(dilations), slope, int(x.dtype == torch.bfloat16), int(ops_bf16),
        int(mean), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    launches[name] += 1
    return out if cp == c else out[:, :c].contiguous()


def mrf_stage(x, chains, kernel_sizes: Sequence[int],
              dilations: Sequence[int], slope: float = 0.1) -> torch.Tensor:
    """K1: one decoder stage tail, the mean over the parallel chains.

    x [B, C, T] f32 or bf16; chains: per chain (w1s, b1s, w2s, b2s). bf16
    input multiplies bf16 operands into f32, f32 input runs 3xTF32."""
    kernel_sizes, dilations = tuple(kernel_sizes), tuple(dilations)
    if x.device.type == "cpu":
        return mrf_stage_plain(x, chains, dilations, slope)
    _check_input(x, "mrf_stage")
    convs = []
    for (w1s, b1s, w2s, b2s) in chains:
        for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
            convs += [(w1, b1), (w2, b2)]
    return _launch("mrf_stage", x, convs, kernel_sizes, dilations, slope,
                   ops_bf16=x.dtype == torch.bfloat16, mean=True)


def resblock_chain(x, w1s, b1s, w2s, b2s, dilations: Sequence[int],
                   slope: float = 0.1) -> torch.Tensor:
    """K2: one ResBlock chain, f32 compute (3xTF32), I/O in x's dtype. When
    the whole chain's buffers leave a tile under 64 rows it runs one launch
    per dilation pair, the split the JAX kernel makes at C = 256."""
    dilations = tuple(dilations)
    if x.device.type == "cpu":
        return resblock_chain_plain(x, w1s, b1s, w2s, b2s, dilations, slope)
    _check_input(x, "resblock_chain")
    k = int(w1s[0].shape[-1])
    groups = [tuple(range(len(dilations)))]
    if plan(x.shape[1], (k,), dilations, False, False)[1] < 64:
        groups = [(i,) for i in range(len(dilations))]
    y = x
    for g in groups:
        convs = []
        for i in g:
            convs += [(w1s[i], b1s[i]), (w2s[i], b2s[i])]
        y = _launch("resblock_chain", y, convs, (k,),
                    tuple(dilations[i] for i in g), slope, ops_bf16=False,
                    mean=False)
    return y
