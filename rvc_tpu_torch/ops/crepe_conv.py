"""CREPE's conv blocks: kernel C ``crepe_block``.

A block of CREPE's salience network is a "same"-padded conv over time, a
ReLU, a batch norm and a 2x max pool (``predictors/crepe.py``). For a CUDA
float32 tensor, ``crepe_blocks`` runs each block as one launch of C
(``csrc/crepe_conv.cu``: a ``wgmma`` tf32 implicit GEMM with the bias, ReLU,
folded batch norm and pool in its epilogue, channels-last [frames, T, C]
between blocks, conv1's 512 taps over the frame held once in shared
memory), and raises for any other CUDA dtype; ``blocks_plain`` is the same
function in plain PyTorch (NCHW convs, as torchcrepe writes it), which a CPU
tensor takes. C replaces no TPU kernel: the JAX package runs CREPE through
``lax`` convolutions. It is bound by operations at TF32's 495 TFLOP/s.

The products are single-pass tf32 (both operands rounded to nearest, f32
sums) where ``torch.backends.cudnn.allow_tf32`` is set, as cuDNN's
convolutions are, and 3xTF32 where it is not, the tensor cores' sums
promoted into CUDA-core registers every 16 stages after conv1, so a caller
who turned TF32 off keeps float32's precision. conv1 runs in 3xTF32 at either setting,
as cuDNN ran it in f32: in single-pass tf32 it would add a sixth block's
operand rounding to the chain's error. ``pack_blocks`` packs every block's
weights for C and folds its batch norm into a scale and shift; ``CrepeModel``
keeps the packs in a ``WeightCache`` (counter ``crepe_packs``), rebuilt when
a weight or running statistic changes.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .resblock import SMEM_LIMIT, split_tf32

WINDOW = 1024        # samples of a frame
BLOCK_ROWS = 256     # output rows (steps x frames) of one block of C
N_TILES = (16, 32, 64, 128)
MAX_STAGES = 8
FIRST_ROWS = 384     # rows of 4 samples holding conv1's padded frame
BARRIER_BYTES = (2 * MAX_STAGES + 4) * 8

launches = {"crepe_conv": 0}


def reset_launches() -> None:
    launches["crepe_conv"] = 0


class BlockPlan(NamedTuple):
    """One block's launch geometry (``csrc/crepe_conv.cu``'s arguments)."""
    first: bool      # conv1: one input channel, stride 4, taps over samples
    length: int      # T: output steps before the pool
    c_in: int
    c_out: int
    n_tile: int      # output channels a block of C computes
    fi: int          # frames interleaved row by row in a frame group
    fg: int          # frame groups a block (fi * fg frames, T * fi * fg = 256 rows)
    pad_lo: int      # zero steps (conv1: samples) before the signal
    k_lo: int        # the first tap that reaches the signal (conv1: 0)
    taps: int        # stages a depth chunk runs: the taps that reach it
    w_taps: int      # taps a chunk has in the packed weights
    dk: int          # depth of a stage (input channels; conv1: samples)
    three: bool      # 3xTF32 (else single-pass tf32)
    rs: int          # rows of one depth group in shared memory
    rg: int          # rows of one frame group
    stages: int      # depth of the weight ring
    smem: int        # dynamic shared memory bytes


def _group_rows(rows: int, dk: int) -> int:
    """``rows`` rounded up so that the loaders' 16-byte stores (consecutive
    threads: consecutive depth groups of a row, then the next row) meet no
    bank conflict: rs = 32 / dk modulo 8."""
    return rows + (32 // dk - rows) % 8


def plan(c_in: int, c_out: int, length: int, kernel: int, stride: int,
         pad_lo: int, three: bool) -> BlockPlan:
    """C's geometry for a block whose conv takes ``c_in`` channels to
    ``c_out`` over ``kernel`` taps at ``stride``, ``length`` output steps
    and ``pad_lo`` zero steps before the signal: conv1 (one channel, stride
    4, 512 taps, 256 steps; always 3xTF32) or a stride-1 conv of 256 /
    length frames a block. The deepest depth chunk whose buffers leave four
    weight stages (or up to eight) wins, else the one that leaves the most
    (at least two)."""
    first = c_in == 1
    # conv1 in 3xTF32 at either setting (the module's docstring)
    three = three or first
    planes = 2 if three else 1
    # 64 channels a block after conv1: in 3xTF32, whose promoted sums take a
    # second set of accumulator registers (conv1's 512-deep sums are not
    # promoted); and at T <= 32, where a block covers 8 frames or more, so a
    # 512-frame batch gives 64 row blocks or fewer for 132 SMs: 64 channels
    # a block doubles them
    n_tile = min(128, c_out)
    if c_out >= 128 and not first and (three or length <= 32):
        n_tile = 64
    if n_tile not in N_TILES or c_out % n_tile:
        raise ValueError(f"crepe_conv: {c_out} output channels (needs 16, 32, 64 "
                         "or a multiple of 128)")
    if first:
        if ((stride, kernel, length) != (4, 512, BLOCK_ROWS)
                or not 0 <= pad_lo <= 4 * FIRST_ROWS - WINDOW):
            raise ValueError(f"crepe_conv: conv1 must be 512 taps at stride 4 over "
                             f"{WINDOW} samples, got {kernel} at {stride}, {length} steps")
        fi = fg = 1
        k_lo, depth = 0, kernel
    else:
        if stride != 1 or BLOCK_ROWS % length or length % 2 or length < 8:
            raise ValueError(f"crepe_conv: a stride-1 conv of 8-256 steps dividing "
                             f"{BLOCK_ROWS}, got stride {stride}, {length} steps")
        fi = min(8, max(1, 64 // length))
        fg = BLOCK_ROWS // (length * fi)
        k_lo = max(0, pad_lo - (length - 1))
        depth = c_in
    best = None
    for dk in (32, 16, 8):
        if dk * planes > 32 or depth % dk:
            continue
        if first:
            taps = w_taps = kernel // dk
            rg = rs = 0
            plane = FIRST_ROWS * 16
            buffers = 1
        else:
            taps = min(kernel - 1, pad_lo + length - 1) - k_lo + 1
            w_taps = kernel
            rg = (length + taps - 1) * fi
            rs = _group_rows(fg * rg, dk)
            plane = dk // 4 * rs * 16
            buffers = 2
        act = buffers * planes * plane
        stage = planes * dk * n_tile * 4
        stages = min(MAX_STAGES, (SMEM_LIMIT - BARRIER_BYTES - act) // stage)
        if stages < 2:
            continue
        p = BlockPlan(first, length, c_in, c_out, n_tile, fi, fg, pad_lo, k_lo, taps,
                      w_taps, dk, three, rs, rg, stages,
                      stages * stage + act + BARRIER_BYTES)
        if best is None or p.stages > best.stages:
            best = p
        if stages >= 4:
            break
    if best is None:
        raise ValueError(f"crepe_conv: no depth chunk of {depth} fits shared memory "
                         f"at {length} steps")
    return best


def tf32_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to the nearest tf32 value, ties away from zero (the
    kernel's ``cvt.rna.tf32.f32`` of its activations)."""
    bits = w.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def pack_weights(w: torch.Tensor, p: BlockPlan) -> torch.Tensor:
    """A conv's weights [C_out, C_in, K] (conv1: [C_out, 1, 512]) -> the
    stage images C's weight loader copies, flat f32
    [C_out block][depth chunk][tap][plane][group of 4 in the chunk][C_out
    in the block][4]: each (block, chunk, tap) one contiguous stage, the B
    operand of its ``wgmma``s (K-major, 16-byte depth groups). Plane 0 holds
    the tf32-rounded weights (3xTF32: their big parts, ``split_tf32``), plane
    1 the small parts. conv1's depth is its 512 samples, as chunks of one
    tap."""
    w = w.detach().float()
    if p.first:
        w = w.reshape(w.shape[0], -1, 1)
    c_out, depth, k = w.shape
    planes = torch.stack(split_tf32(w)) if p.three else tf32_round(w)[None]
    planes = planes.reshape(planes.shape[0], c_out // p.n_tile, p.n_tile,
                            depth // p.dk, p.dk // 4, 4, k)
    return planes.permute(1, 3, 6, 0, 4, 2, 5).contiguous().reshape(-1)


def fold_norm(bn: torch.nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch norm at inference as (scale, shift), f32: its running
    statistics and its own epsilon."""
    scale = bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.detach().float() - bn.running_mean.float() * scale
    return scale.contiguous(), shift.contiguous()


class PackedBlock(NamedTuple):
    plan: BlockPlan
    w: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor


def pack_blocks(blocks: Sequence[Tuple[torch.nn.Conv2d, torch.nn.BatchNorm2d]],
                geometry: Sequence[Tuple[int, int, int]], three: bool) -> List[PackedBlock]:
    """Every block's plan, packed weights, bias and folded batch norm.
    ``geometry``: each block's (output steps, stride, left padding)."""
    out = []
    for (conv, bn), (length, stride, pad_lo) in zip(blocks, geometry):
        c_out, c_in, k = conv.weight.shape[:3]
        p = plan(c_in, c_out, length, k, stride, pad_lo, three)
        scale, shift = fold_norm(bn)
        out.append(PackedBlock(p, pack_weights(conv.weight[..., 0], p),
                               conv.bias.detach().float().contiguous(), scale, shift))
    return out


def blocks_plain(x: torch.Tensor, blocks, pads) -> torch.Tensor:
    """C's function in plain PyTorch, as torchcrepe writes it: frames [N,
    1024] (or a later block's input as NCHW [N, C, T, 1]) -> [N, T, C]
    after the last block (time-major, channels inner), each block conv,
    ReLU, batch norm, pool on NCHW [N, C, T, 1]."""
    if x.dim() == 2:
        x = x[:, None, :, None]
    for (conv, bn), pad in zip(blocks, pads):
        x = F.pad(x, (0, 0) + tuple(pad))
        x = bn(F.relu(conv(x)))
        x = F.max_pool2d(x, (2, 1), (2, 1))
    return x[..., 0].transpose(1, 2)


def _lib():
    from ._build import load

    lib = load("crepe_conv")
    if not getattr(lib, "_rvc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rvc_crepe_conv.argtypes = [p] * 6 + [i] * 17 + [p]
        lib.rvc_crepe_conv.restype = i
        lib._rvc_typed = True
    return lib


def crepe_block(x: torch.Tensor, b: PackedBlock) -> torch.Tensor:
    """One block of C: x [N, T, C_in] f32 channels-last on the card, T the
    block's output steps (conv1: the normalised frames [N, 1024]) -> [N,
    T / 2, C_out]; raises for any other tensor."""
    p, n = b.plan, x.shape[0]
    want = (WINDOW,) if p.first else (p.length, p.c_in)
    if x.device.type != "cuda":
        raise ValueError(f"crepe_conv: a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"crepe_conv: float32 input, got {x.dtype}")
    if tuple(x.shape[1:]) != want or not x.is_contiguous():
        raise ValueError(f"crepe_conv: a contiguous [N, {', '.join(map(str, want))}] "
                         f"input, got {tuple(x.shape)}")
    if b.w.device != x.device:
        raise ValueError("crepe_conv: the packed weights lie on another device")
    out = torch.empty((n, p.length // 2, p.c_out), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):  # the launch acts on the current device
        err = _lib().rvc_crepe_conv(
            x.data_ptr(), out.data_ptr(), b.w.data_ptr(), b.bias.data_ptr(),
            b.scale.data_ptr(), b.shift.data_ptr(), n, p.length, p.c_in, p.c_out,
            p.n_tile, int(p.first), p.fi, p.fg, p.pad_lo, p.k_lo, p.taps, p.w_taps, p.dk,
            int(p.three), p.rs, p.rg, p.stages,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"crepe_conv: CUDA error {err} at launch ({p})")
    launches["crepe_conv"] += 1
    return out


def crepe_blocks(frames: torch.Tensor, packed: Sequence[PackedBlock]) -> torch.Tensor:
    """Every block through C: normalised frames [N, 1024] f32 on the card
    -> [N, T, C] after the last block (time-major, channels inner);
    ``crepe_block`` checks each input."""
    x = frames.contiguous()
    for b in packed:
        x = crepe_block(x, b)
    return x
