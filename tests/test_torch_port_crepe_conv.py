"""Kernel C (``ops/crepe_conv.py``, ``csrc/crepe_conv.cu``): CREPE's conv
blocks.

On the CPU: ``CrepeModel`` takes the plain blocks and launches nothing, its
salience held to the benchmark's reference as the parity tests hold it; the
planner's geometry for every block of both capacities at both precisions;
the kernel's addressing emulated (the loaders' shared-memory rows, the
packed stages, the ``wgmma`` descriptors' start and strides, the
epilogue's pool partners and stores) against ``blocks_plain``; the packs
built once per weight version (counter ``crepe_packs``). This file imports
no JAX: its ``cuda``-marked tests run on the card (``python -m pytest
--noconftest -m cuda tests/test_torch_port_crepe_conv.py``), where C is held
to the plain blocks in float64 at both capacities, batches of 1, 17 and 512
frames, in single-pass tf32 and in 3xTF32.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import copy
import math

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import crepe as ref
from benchmark.traffic import voice
from rvc_tpu_torch.ops import crepe_conv
from rvc_tpu_torch.ops.crepe_conv import BLOCK_ROWS, PackedBlock
from rvc_tpu_torch.predictors import crepe
from rvc_tpu_torch.utils import profiling

SIGNAL = {**weights.CALIBRATION_SIGNAL, "f0_hz": [110, 660]}
# C against the plain blocks in float64, as the norm of the difference of
# the last block's output over its norm: single-pass tf32
# rounds both operands to 11 significant bits (2^-11 relative each) over
# sums of up to 65 536 products; 3xTF32 drops only the small x small term
# (about 2^-20 relative), as K2 and N do (1.1e-5 there)
TF32_LIMIT = 5e-3
THREE_LIMIT = 5e-5


def _arch(mult):
    return {"filters": [f * mult for f in crepe.BASE_FILTERS], "kernels": list(crepe.KERNELS),
            "strides": list(crepe.STRIDES), "classifier": [64 * mult, 360], "hop": 160}


def _seeded(capacity, mult, seed, monkeypatch, device="cpu"):
    """A CrepeModel at ``mult`` times the base filters, its weights by the
    benchmark's rules and its batch norms calibrated by the reference."""
    monkeypatch.setitem(crepe.CAPACITIES, capacity, mult)
    model = crepe.CrepeModel(capacity)
    sd = weights.seeded_state(weights.float_shapes(model), seed, "crepe", device)
    rng = np.random.default_rng(seed)
    ref.calibrate(sd, torch.from_numpy(voice(16000, rng, SIGNAL)).to(device), _arch(mult))
    model.load_state_dict(sd, strict=False)
    return model.to(device).eval(), sd


def _frames(n, seed, device="cpu"):
    audio = voice(160 * (n - 1), np.random.default_rng(seed), SIGNAL)
    frames = ref.frames_of(torch.from_numpy(audio).to(device))
    mu = frames.mean(dim=1, keepdim=True)
    return (frames - mu) / torch.clamp(frames.std(dim=1, keepdim=True), min=1e-10)


def test_cpu_takes_the_plain_blocks(monkeypatch):
    """CREPE's structure at 2x the base filters on 120 frames: the CPU's
    salience is the reference's within the parity tests' 1e-5, and no
    kernel launched."""
    model, sd = _seeded("full", 2, 5, monkeypatch)
    crepe_conv.reset_launches()
    frames = ref.frames_of(torch.from_numpy(voice(160 * 119, np.random.default_rng(6), SIGNAL)))
    got = crepe.CREPE("full", model, device="cpu").salience(frames)
    want = ref.salience(sd, frames, _arch(2), block=64)
    assert float((got - want).norm() / want.norm()) <= 1e-5
    assert crepe_conv.launches["crepe_conv"] == 0


@pytest.mark.parametrize("capacity", ["full", "tiny"])
@pytest.mark.parametrize("three", [False, True])
def test_plans_cover_every_block(capacity, three):
    """Each block: 256 rows a block of C, whole frames, each 64-row tile in
    one frame group, the taps that reach the signal and no other, the
    shared memory within a block's, four to eight weight stages; conv1 in
    3xTF32 at either setting, 128 channels a block."""
    model = crepe.CrepeModel(capacity)
    for (conv, _), (length, stride, pad_lo) in zip(model.blocks(), crepe.GEOMETRY):
        c_out, c_in, k = conv.weight.shape[:3]
        p = crepe_conv.plan(c_in, c_out, length, k, stride, pad_lo, three)
        assert p.length * p.fi * p.fg == BLOCK_ROWS and (p.length * p.fi) % 64 == 0
        assert 4 <= p.stages <= crepe_conv.MAX_STAGES and p.smem <= crepe_conv.SMEM_LIMIT
        assert p.three == (three or p.first)
        assert p.dk * (2 if p.three else 1) <= 32 and p.c_out % p.n_tile == 0
        if p.first:
            assert p.taps * p.dk == k and (p.fi, p.fg) == (1, 1)
            assert p.n_tile == min(128, c_out)
            continue
        reach = [kk for kk in range(k) if any(0 <= t + kk - pad_lo < length
                                              for t in range(length))]
        assert (p.k_lo, p.taps) == (reach[0], len(reach))
        assert p.rs >= p.fg * p.rg == p.fg * (length + p.taps - 1) * p.fi
        assert p.rs % 8 == 32 // p.dk


def _loaded(x, p, n0, c):
    """The activation buffer the loaders fill for chunk ``c`` of the block
    whose first frame is ``n0``, as a flat float array (16 bytes = 4)."""
    planes = 2 if p.three else 1
    if p.first:
        buf = torch.zeros(planes * crepe_conv.FIRST_ROWS * 4, dtype=torch.float64)
        for s in range(crepe_conv.FIRST_ROWS * 4):
            if 0 <= s - p.pad_lo < crepe_conv.WINDOW:
                buf[s] = x[n0, s - p.pad_lo]
        return buf
    g_n = p.dk // 4
    buf = torch.zeros(planes * g_n * p.rs * 4, dtype=torch.float64)
    for row in range(p.fg * p.rg):
        grp, rr = divmod(row, p.rg)
        step, f = divmod(rr, p.fi)
        n, t = n0 + grp * p.fi + f, step + p.k_lo - p.pad_lo
        if n < x.shape[0] and 0 <= t < p.length:
            for g in range(g_n):
                buf[(g * p.rs + row) * 4:(g * p.rs + row) * 4 + 4] = \
                    x[n, t, c * p.dk + 4 * g:c * p.dk + 4 * g + 4]
    return buf


def _operand(buf, start, lbo, rows):
    """A K-major operand of ``rows`` x 8 at float offset ``start``, layout
    without swizzle: core matrices of 8 rows x 4 floats, ``lbo`` floats to
    the next depth group, 32 to the next 8 rows."""
    r = torch.arange(rows)[:, None]
    d = torch.arange(8)[None, :]
    return buf[start + (d // 4) * lbo + (r // 8) * 32 + (r % 8) * 4 + d % 4]


def emulate(x, b: PackedBlock):
    """C's arithmetic, step by step as the kernel addresses it, in float64
    (3xTF32: the weights' two planes summed, the activations unsplit): x as
    the block takes it -> [N, T / 2, C_out]."""
    p, n_tile = b.plan, b.plan.n_tile
    w = b.w.double()
    stage = (2 if p.three else 1) * p.dk * n_tile
    per_block = p.fi * p.fg
    chunks = 1 if p.first else p.c_in // p.dk
    tf = p.length * p.fi
    tap_rows, lbo = (p.dk // 4, 4) if p.first else (p.fi, p.rs * 4)
    out = torch.zeros(x.shape[0], p.length // 2, p.c_out, dtype=torch.float64)
    for n0 in range(0, x.shape[0], per_block):
        bufs = [_loaded(x.double(), p, n0, c) for c in range(chunks)]
        for nb in range(p.c_out // n_tile):
            acc = torch.zeros(BLOCK_ROWS, n_tile, dtype=torch.float64)
            for c in range(chunks):
                for k in range(p.taps):
                    base = ((nb * chunks + c) * p.w_taps + p.k_lo + k) * stage
                    for j in range(p.dk // 8):
                        bmat = _operand(w, base + j * 2 * n_tile * 4, n_tile * 4, n_tile)
                        if p.three:  # big + small: the weights as they were
                            bmat = bmat + _operand(w, base + p.dk * n_tile + j * 2 * n_tile * 4,
                                                   n_tile * 4, n_tile)
                        for m0 in range(0, BLOCK_ROWS, 64):
                            grp = m0 // tf
                            row0 = grp * p.rg + m0 - grp * tf
                            a = _operand(bufs[c], (row0 + k * tap_rows) * 4 + j * 2 * lbo,
                                         lbo, 64)
                            acc[m0:m0 + 64] += a @ bmat.T
            co = slice(nb * n_tile, (nb + 1) * n_tile)
            v = torch.relu(acc + b.bias[co].double()) * b.scale[co].double() + b.shift[co].double()
            v = torch.maximum(v, v[torch.arange(BLOCK_ROWS) ^ p.fi])  # the pool partner
            for m in range(BLOCK_ROWS):
                grp, rem = divmod(m, tf)
                t, f = divmod(rem, p.fi)
                n = n0 + grp * p.fi + f
                if t % 2 == 0 and n < x.shape[0]:
                    out[n, t // 2, co] = v[m]
    return out


@pytest.mark.parametrize("c_in, c_out, length, three", [
    (1, 256, 256, False),     # conv1, two channel blocks
    (1, 128, 256, True),
    (32, 16, 128, False),     # n 16, two frames a block, every tap
    (16, 32, 64, True),
    (16, 128, 32, False),     # fi 2, two blocks of 64 channels
    (32, 256, 16, True),      # fi 4, taps 16..46, four channel blocks
    (32, 64, 8, False),       # fi 8: the partner in the thread
])
def test_emulated_kernel_matches_the_plain_block(c_in, c_out, length, three):
    """One block's conv through C's addressing (the loaders' rows, the
    packed stages, the descriptors, the pool's partner rows) against
    ``blocks_plain`` on the same conv and batch norm, over frame counts that
    leave the last block of C part empty."""
    torch.manual_seed(c_in + c_out + length)
    first = c_in == 1
    k, stride, pad = (512, 4, (254, 254)) if first else (64, 1, (31, 32))
    conv = torch.nn.Conv2d(c_in, c_out, (k, 1), (stride, 1))
    bn = torch.nn.BatchNorm2d(c_out, eps=1e-3).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.normal_()
        bn.weight.mul_(torch.where(torch.rand(c_out) < 0.3, -1.0, 1.0))  # negative scales
        bn.running_var.uniform_(0.5, 2.0)
    b = crepe_conv.pack_blocks([(conv, bn)], [(length, stride, pad[0])], three)[0]
    frames = 2 if first else BLOCK_ROWS // length + 1
    if first:
        x = torch.randn(frames, crepe_conv.WINDOW)
        plain_in = x[:, None, :, None]
    else:
        x = torch.randn(frames, length, c_in)
        plain_in = x.transpose(1, 2)[..., None]
    with torch.no_grad():
        want = torch.nn.functional.max_pool2d(
            bn(torch.relu(conv(torch.nn.functional.pad(plain_in, (0, 0) + pad)))),
            (2, 1), (2, 1))[..., 0].transpose(1, 2)
    got = emulate(x, b)
    err = float((got - want.double()).norm() / want.double().norm())
    assert b.plan.three == (three or first)
    assert err <= (1e-6 if b.plan.three else TF32_LIMIT), err


def test_packs_build_once_per_weight_version(monkeypatch):
    """The first ``packed()`` builds (one ``crepe_packs``), a second reads
    the cache; an in-place ``load_state_dict`` and a change of the TF32
    switch each build once more. conv1 is 3xTF32 at either setting."""
    model = crepe.CrepeModel("tiny").eval()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)

    def builds(fn):
        before = profiling.counters().get("crepe_packs", 0)
        out = fn()
        return out, profiling.counters().get("crepe_packs", 0) - before

    first, n = builds(model.packed)
    assert n == 1 and len(first) == 6 and first[0].plan.three
    assert not any(b.plan.three for b in first[1:])
    assert builds(model.packed) == (first, 0)
    sd = {k: v + 0.5 if v.is_floating_point() else v for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    again, n = builds(model.packed)
    assert n == 1 and torch.equal(again[1].bias, model.conv2.bias)
    assert builds(model.packed)[1] == 0
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    three, n = builds(model.packed)
    assert n == 1 and all(b.plan.three for b in three)


def test_blocks_take_only_cuda_float32():
    packed = crepe.CrepeModel("tiny").packed()
    with pytest.raises(ValueError, match="CUDA"):
        crepe_conv.crepe_blocks(torch.zeros(3, 1024), packed)


# ---- on the card ----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("capacity, mult", [("full", 32), ("tiny", 4)])
@pytest.mark.parametrize("tf32", [True, False])
def test_kernel_matches_the_plain_blocks_on_card(capacity, mult, tf32, monkeypatch):
    """C against the plain blocks in float64 on 1, 17 and 512 frames: the
    last block's output within ``TF32_LIMIT`` (single pass) or
    ``THREE_LIMIT`` (3xTF32), six launches a batch, and the salience through
    ``CrepeModel`` equal to the blocks' classifier."""
    _card()
    model, _ = _seeded(capacity, mult, 21, monkeypatch, device="cuda")
    exact = copy.deepcopy(model).double()
    frames = _frames(512, 22, device="cuda")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    packed = model.packed()
    for n in (1, 17, 512):
        crepe_conv.reset_launches()
        with torch.no_grad():
            got = crepe_conv.crepe_blocks(frames[:n], packed)
            with monkeypatch.context() as m:
                m.setattr(torch.backends.cudnn, "allow_tf32", False)
                want = crepe_conv.blocks_plain(frames[:n].double(), exact.blocks(), crepe.PADS)
                plain = crepe_conv.blocks_plain(frames[:n], model.blocks(), crepe.PADS)
        torch.cuda.synchronize()
        assert crepe_conv.launches["crepe_conv"] == 6
        err = float((got.double() - want).norm() / want.norm())
        plain_err = float((plain.double() - want).norm() / want.norm())
        print(f"{capacity} tf32={tf32} frames={n}: rel err {err:.3e} "
              f"(the plain blocks in f32: {plain_err:.3e})")
        assert err <= (TF32_LIMIT if tf32 else THREE_LIMIT), err
        with torch.no_grad():
            sal = model(frames[:n])
        want_sal = torch.sigmoid(model.classifier(got.reshape(n, -1)))
        assert torch.equal(sal, want_sal)


@pytest.mark.cuda
def test_packs_rebuild_once_after_load_on_card(monkeypatch):
    """One ``crepe_packs`` build after ``load_state_dict``, none on a second
    forward; a CUDA input that is not float32 raises."""
    _card()
    model, sd = _seeded("tiny", 4, 23, monkeypatch, device="cuda")
    frames = _frames(40, 24, device="cuda")
    with torch.no_grad():
        model(frames)
        before = profiling.counters().get("crepe_packs", 0)
        model.load_state_dict(sd, strict=False)
        model(frames)
        model(frames)
    assert profiling.counters().get("crepe_packs", 0) - before == 1
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32"), torch.no_grad():
            model(frames.to(dtype))


def test_geometry_is_torchcrepes():
    """Each block's steps follow the 1024-sample frame: 256 after conv1's
    stride 4, then half each block, four left for the classifier."""
    assert [g[0] for g in crepe.GEOMETRY] == [256, 128, 64, 32, 16, 8]
    assert crepe.CrepeModel("tiny").classifier.in_features == 4 * 64
    assert math.prod(crepe.STRIDES) == 4
