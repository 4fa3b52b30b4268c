"""Kernel V (``ops/viterbi.py``, ``csrc/viterbi.cu``): CREPE's Viterbi decode
on the card.

On the CPU: a CPU salience keeps the host's numpy ``_viterbi_path`` (V's
plain version) and never reaches the wrapper, which raises for it; the
card's read-out around V (range mask, weighted cents, pitch, voicing)
equals the host decode given the host's path; the kernel's row sums,
emulated lane by lane, are numpy's pairwise sums to the bit; and where the
reference's path leaves the host's, two sources tie and the two take
different ones. This file imports no JAX: its ``cuda``-marked tests run on
the card (``python -m pytest --noconftest -m cuda tests/test_torch_port_viterbi.py``),
where V's path is held to the host's and the reference's, bit for bit, and
``CREPE.predict`` to the host decode.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import math
from decimal import Decimal, localcontext

import numpy as np
import pytest
import torch

from benchmark.reference import crepe as ref
from rvc_tpu_torch.ops import viterbi
from rvc_tpu_torch.predictors import crepe
from rvc_tpu_torch.utils import profiling
from test_torch_port_crepe import _salience

COUNTER = "viterbi_device_frames"


def _outside(fmin=50.0, fmax=1100.0):
    cents = crepe.CENTS_MAPPING
    return (cents < 1200 * np.log2(fmin / 10.0)) | (cents > 1200 * np.log2(fmax / 10.0))


def _host_f0(sal: np.ndarray) -> np.ndarray:
    """``CREPE.predict``'s host decode of a salience (copied, then masked)."""
    sal = sal.copy()
    sal[:, _outside()] = 0.0
    f0 = 10.0 * (2.0 ** (crepe._decode_viterbi(sal) / 1200.0))
    f0[sal.max(axis=1) < 1e-3] = 0.0
    return f0.astype(np.float32)


def _spread_salience(frames, seed):
    """Sigmoid-like salience whose values span many exponents (so that the
    order of a row's sum shows in its bits), with masked bins and silent
    rows."""
    rng = np.random.default_rng(seed)
    sal = rng.random((frames, 360)) ** rng.uniform(1, 40, (frames, 1))
    sal[:, _outside()] = 0.0
    sal[::9] = 0.0
    return sal.astype(np.float32)


# ---- on the CPU -----------------------------------------------------------


def test_cpu_route_never_reaches_the_kernel(monkeypatch):
    """A CPU ``CREPE`` decodes on the host: the wrapper is never called and
    ``viterbi_device_frames`` is not counted."""
    def refused(*a, **k):
        raise AssertionError("the CPU route called kernel V's wrapper")

    monkeypatch.setattr(viterbi, "viterbi_path", refused)
    monkeypatch.setattr(viterbi, "observations", refused)
    pred = crepe.CREPE("tiny", device="cpu")
    audio = np.sin(2 * np.pi * 220 * np.arange(8000) / 16000).astype(np.float32)
    before = profiling.counters().get(COUNTER, 0)
    f0 = pred.predict(audio)
    assert f0.shape == (8000 // 160 + 1,) and f0.dtype == np.float32
    assert profiling.counters().get(COUNTER, 0) == before
    assert viterbi.launches["viterbi"] == 0


@pytest.mark.parametrize("sal", [torch.zeros(3, 360), torch.zeros(3, 360, dtype=torch.float64)])
def test_wrapper_raises_on_a_cpu_tensor(sal):
    with pytest.raises(ValueError, match="CUDA"):
        viterbi.viterbi_path(sal)
    with pytest.raises(ValueError, match="CUDA"):
        viterbi.observations(sal)


@pytest.mark.parametrize("frames, kind, silent", [(1, "random", False), (400, "random", True),
                                                  (400, "peaked", False)])
def test_card_readout_matches_the_host_decode(frames, kind, silent, monkeypatch):
    """``_decode_viterbi_card`` (mask, cents, pitch, voicing in torch) with
    V's path replaced by the host's: the host decode's f0 within one part in
    10^6 (the pitch's power in torch against numpy), the unvoiced frames
    exactly 0."""
    monkeypatch.setattr(viterbi, "viterbi_path",
                        lambda s: torch.from_numpy(crepe._viterbi_path(s.numpy())))
    raw = _salience(frames, kind, silent).float().numpy()
    raw[:, _outside()] = 0.5  # the read-out masks them again
    got = crepe._decode_viterbi_card(torch.from_numpy(raw), _outside())
    want = _host_f0(raw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got == 0, want == 0)


def _lane_sums(x: np.ndarray) -> np.ndarray:
    """``viterbi_obs``'s row sums, lane by lane: lane 8 L + m adds every
    eighth value of leaf L (88 values from 88 L; the last 96) in order from
    88 L + m, then xor shuffles 1, 2, 4, 8, 16 add the lanes. Every lane's
    sum, [rows, 32]."""
    lanes = []
    for lane in range(32):
        leaf, m = divmod(lane, 8)
        first, n = 88 * leaf + m, 96 if leaf == 3 else 88
        r = x[:, first].copy()
        for q in range(8, n, 8):
            r = r + x[:, first + q]
        lanes.append(r)
    v = np.stack(lanes, axis=1)
    for d in (1, 2, 4, 8, 16):
        v = v + v[:, np.arange(32) ^ d]
    return v


@pytest.mark.parametrize("seed", [1, 2])
def test_row_sums_are_numpys_to_the_bit(seed):
    """The kernel's order of a row's 360 adds is numpy's pairwise one: the
    same bits on a salience whose rows a sequential sum gets wrong."""
    x = _spread_salience(600, seed).astype(np.float64)
    lanes = _lane_sums(x)
    want = x.sum(axis=1)
    assert (lanes == lanes[:, :1]).all()
    assert np.array_equal(lanes[:, 0], want)
    assert not np.array_equal(np.cumsum(x, axis=1)[:, -1], want)  # the order shows


def _ln(x: float) -> float:
    """The correctly rounded natural log (Decimal at 40 digits, rounded once)."""
    with localcontext() as ctx:
        ctx.prec = 40
        return float(Decimal(x).ln())


def _reference_last_max(sal: torch.Tensor) -> np.ndarray:
    """``benchmark/reference/crepe.py``'s ``viterbi``, step for step, but of
    equal sources its max keeps the highest bin, as the host's band order
    (offset -11, the source j + 11, first) does; torch's max keeps the
    lowest. The band and its row sums are symmetric, so the sources are
    read in reverse: the same values, the ties taken the other way."""
    n = sal.shape[1]
    idx = torch.arange(n)
    tri = torch.clamp(ref.VITERBI_WIDTH - (idx[:, None] - idx[None, :]).abs(), min=0).double()
    log_trans = torch.log(tri / tri.sum(dim=1, keepdim=True)).flip(0)
    obs = sal / torch.clamp(sal.sum(dim=1, keepdim=True), min=1e-12)
    log_obs = torch.log(obs + 1e-12)
    value = math.log(1.0 / n) + log_obs[0]
    back = torch.zeros(sal.shape, dtype=torch.long)
    for t in range(1, sal.shape[0]):
        value, b = (value.flip(0)[:, None] + log_trans).max(dim=0)
        back[t] = n - 1 - b
        value = value + log_obs[t]
    path = np.zeros(sal.shape[0], np.int64)
    path[-1] = int(value.argmax())
    for t in range(sal.shape[0] - 2, -1, -1):
        path[t] = back[t + 1, path[t + 1]]
    return path


@pytest.mark.parametrize("first", [11600, 14800])
def test_reference_leaves_the_host_only_on_ties(first):
    """Where the reference's path leaves the host's (100 frames of the
    24 001-frame peaked salience, two frames each), two sources tie: the
    reference with its ties taken as the host takes them is the host's path
    to the frame."""
    sal = _salience(24001, "peaked", False)[first:first + 100].float()
    host = crepe._viterbi_path(sal.numpy())
    assert (ref.viterbi(sal.double()).numpy() != host).sum() == 2
    np.testing.assert_array_equal(_reference_last_max(sal.double()), host)


# ---- on the card ----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("frames, kind, silent", [
    (1, "random", False), (2, "random", False), (400, "random", False),
    (400, "peaked", False), (400, "random", True), (400, "peaked", True),
    (24001, "peaked", False)])
def test_path_matches_the_host_and_the_reference_on_card(frames, kind, silent):
    """V's path equals the host's ``_viterbi_path`` to the bin, and the
    reference's dense Viterbi where ``test_torch_port_crepe.py`` holds the
    host to it (up to 400 frames without silent ties); on 24 001 frames,
    where two sources tie on a few frames, the reference with its ties
    taken as the host takes them; two launches a decode, one count of each
    frame. V's observations are within an ulp of the exact log."""
    _card()
    sal = _salience(frames, kind, silent).float()
    host = sal.numpy()
    card = sal.cuda()
    viterbi.reset_launches()
    before = profiling.counters().get(COUNTER, 0)
    got = viterbi.viterbi_path(card)
    torch.cuda.synchronize()
    assert viterbi.launches["viterbi"] == 2
    assert profiling.counters().get(COUNTER, 0) - before == frames
    want = crepe._viterbi_path(host)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if frames > 400:
        np.testing.assert_array_equal(want, _reference_last_max(sal.double()))
        return
    if not silent:
        np.testing.assert_array_equal(want, ref.viterbi(sal.double().cuda()).cpu().numpy())
    x = host.astype(np.float64)
    x = x / np.maximum(x.sum(axis=1, keepdims=True), 1e-12) + 1e-12
    lo = viterbi.observations(card).cpu().numpy()
    for v, mine in zip(x[lo != np.log(x)], lo[lo != np.log(x)]):
        exact = _ln(float(v))
        assert abs(mine - exact) <= np.spacing(abs(exact)), (v, mine, exact)


@pytest.mark.cuda
def test_predict_on_card_matches_the_host_decode():
    """``CREPE.predict`` on the card (C, then V) against the host decode of
    the same salience: f0 within 1e-5, the same unvoiced frames; V counts
    the song's frames and launches twice."""
    _card()
    torch.manual_seed(5)
    pred = crepe.CREPE("tiny", device="cuda")
    t = np.arange(48000) / 16000
    audio = (0.5 * np.sin(2 * np.pi * 220 * t * (1 + 0.1 * t))
             * (np.sin(2 * np.pi * 2 * t) > -0.3)).astype(np.float32)
    frames = len(audio) // 160 + 1
    viterbi.reset_launches()
    before = profiling.counters().get(COUNTER, 0)
    f0 = pred.predict(audio)
    assert viterbi.launches["viterbi"] == 2
    assert profiling.counters().get(COUNTER, 0) - before == frames
    padded = torch.from_numpy(np.pad(audio, (512, 512))).cuda()
    sal = pred.salience(padded.unfold(0, 1024, 160)).float().cpu().numpy()
    want = _host_f0(sal)
    assert (want > 0).any()
    np.testing.assert_allclose(f0, want, rtol=1e-5)
    assert np.array_equal(f0 == 0, want == 0)


@pytest.mark.cuda
def test_wrapper_raises_on_what_it_does_not_take():
    _card()
    sal = torch.rand(5, 360, device="cuda")
    for bad, match in ((sal.double(), "float32"), (sal.half(), "float32"),
                       (torch.rand(360, 5, device="cuda").t(), "contiguous"),
                       (torch.rand(5, 361, device="cuda"), "contiguous"),
                       (sal[None], "contiguous")):
        with pytest.raises(ValueError, match=match):
            viterbi.viterbi_path(bad)
