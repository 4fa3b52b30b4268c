"""The port's output effects on the CPU against the JAX package's.

The JAX side is numpy and scipy (``rvc_tpu/infer/postprocess.py``,
``rvc_tpu/infer/formant.py``, ``rvc_tpu/train/preprocess.spectral_gate``);
the port runs the same inputs, made from numpy seeds, as tensors. Stated
tolerances, absolute:

- the STFT pair against ``scipy.signal.stft`` / ``istft``: 1e-6 on a
  float32 signal, 1e-12 on a float64 one;
- the doubling scans against ``scipy.signal.lfilter`` and a sample loop in
  float64: 1e-12 relative to the largest sample;
- each of the ten effects, the whole chain and the spectral gate: 1e-5;
  with every effect on, a sample whose bitcrush input lies within that
  of a rounding boundary may land one step (1/128 at 8 bits) away, so
  there up to 1 sample in 5 000 may differ by at most one step;
- formant shifting: 5e-5 (its cepstrum is a float32 FFT, as numpy's is).
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

from rvc_tpu.infer import formant as jax_formant
from rvc_tpu.infer import postprocess as jax_fx
from rvc_tpu.train.preprocess import spectral_gate as jax_gate
from rvc_tpu_torch.infer import formant, postprocess
from rvc_tpu_torch.ops.scan import decay_max, linear_recurrence
from rvc_tpu_torch.ops.sps_stft import istft, stft

TOL = 1e-5
TOL_FORMANT = 5e-5


def _voice(sr, seconds=1.2, seed=0):
    """A 220 Hz tone with a slow tremolo and gaps, over a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    tone = np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 660 * t)
    env = (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t)) * ((t % 0.4) < 0.3)
    return (0.5 * env * tone + 0.03 * rng.normal(size=t.size)).astype(np.float32)


def _close(want, got, tol):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.mark.parametrize("n_fft", [1024, 2048])
@pytest.mark.parametrize("length", ["hops", "not_hops", "one_frame", "under_frame",
                                    "under_overlap"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stft_pair_matches_scipy(n_fft, length, dtype):
    hop = n_fft // 4
    n = {"hops": 40 * hop, "not_hops": 40 * hop + 77, "one_frame": n_fft,
         "under_frame": n_fft - hop // 2, "under_overlap": n_fft - hop}[length]
    x = np.random.default_rng(n).normal(size=n).astype(dtype)
    if length == "under_overlap":  # scipy refuses: the overlap is not below nperseg
        with pytest.raises(ValueError):
            sps.stft(x, nperseg=n_fft, noverlap=n_fft - hop)
        with pytest.raises(ValueError):
            stft(torch.from_numpy(x), n_fft, hop)
        return
    tol = 1e-6 if dtype == np.float32 else 1e-12
    _, _, want = sps.stft(x, nperseg=n_fft, noverlap=n_fft - hop)
    got = stft(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= tol
    if length == "under_frame":  # nperseg was cut to the signal: no inverse
        assert want.shape[0] < n_fft // 2 + 1
        with pytest.raises(ValueError):
            istft(torch.from_numpy(want), n_fft, hop)
        return
    _, back = sps.istft(want, nperseg=n_fft, noverlap=n_fft - hop)
    got_back = istft(torch.from_numpy(want), n_fft, hop).numpy()
    assert got_back.dtype == back.dtype and got_back.shape == back.shape
    assert np.abs(got_back - back).max() <= tol
    assert np.abs(got_back[:n] - x).max() <= 10 * tol  # and it inverts


def _recurrence_loop(u, a):
    y = np.zeros_like(u)
    for k in range(len(u)):
        y[k] = u[k] + (a * y[k - 1] if k else 0.0)
    return y


def _decay_max_loop(x, rel):
    r = np.zeros_like(x)
    for k in range(len(x)):
        r[k] = max(x[k], rel * r[k - 1] if k else 0.0)
    return r


@pytest.mark.parametrize("d", [605, 1214])
@pytest.mark.parametrize("a", [0.5, 0.672, 1.0])
def test_linear_recurrence_matches_lfilter(d, a):
    rng = np.random.default_rng(d)
    u = rng.normal(size=(480000 // d + 1, d))
    want = sps.lfilter([1.0], [1.0, -a], u, axis=0)
    got = linear_recurrence(torch.from_numpy(u), a).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    lane = _recurrence_loop(u[:, 7], a)
    assert np.abs(got[:, 7] - lane).max() <= 1e-12 * np.abs(lane).max()


@pytest.mark.parametrize("rel", [0.5, 0.9995, 1.0])
def test_decay_max_matches_a_sample_loop(rel):
    x = np.abs(np.random.default_rng(3).normal(size=30000)) ** 3
    want = _decay_max_loop(x, rel)
    got = decay_max(torch.from_numpy(x), rel).numpy()
    assert np.abs(got - want).max() <= 1e-12 * want.max()
    lanes = np.stack([x, x[::-1]], axis=1)  # columns are independent lanes
    got2 = decay_max(torch.from_numpy(lanes), rel).numpy()
    np.testing.assert_array_equal(got2[:, 0], got)


EFFECT_CASES = [
    ("gain", {"gain_db": 6.0}), ("distortion", {}), ("clipping", {}),
    ("bitcrush", {"bit_depth": 6}),
    ("compressor", {"ratio": 4.0, "threshold_db": -12.0}),
    ("compressor", {"ratio": 1.0}),          # ratio <= 1: unchanged
    ("limiter", {}), ("limiter", {"threshold_db": -12.0, "release_s": 0.1}),
    ("delay", {"feedback": 0.5, "seconds": 0.2}),
    ("delay", {}),                           # feedback 0: one tap
    ("delay", {"seconds": 2.0, "feedback": 0.5}),  # audio shorter than the delay
    ("chorus", {"feedback": 0.3}),
    ("chorus", {}),                          # feedback 0
    ("reverb", {}), ("reverb", {"freeze_mode": 1.0}),  # feedback 1.0
    ("reverb", {"room_size": 0.9, "wet_gain": 3.0}),   # peak normalised
    ("pitch_shift", {"semitones": 2.0}),
    ("pitch_shift", {"semitones": -5.0}),
    ("pitch_shift", {"semitones": 0.0}),
]


@pytest.mark.parametrize("sr", [16000, 40000, 48000])
@pytest.mark.parametrize("name,kw", EFFECT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(EFFECT_CASES)])
def test_effect_matches_jax(sr, name, kw):
    audio = _voice(sr)
    want = getattr(jax_fx, name)(audio, sr, **kw)
    got = getattr(postprocess, name)(torch.from_numpy(audio), sr, **kw)
    _close(want, got, TOL)


def test_effects_on_a_clip_shorter_than_their_delays():
    short = _voice(16000, 0.01)
    for name in ("gain", "compressor", "limiter", "delay", "chorus", "reverb"):
        kw = {"ratio": 3.0} if name == "compressor" else {}
        _close(getattr(jax_fx, name)(short, 16000, **kw),
               getattr(postprocess, name)(torch.from_numpy(short), 16000, **kw), TOL)


ALL_ON = dict(
    reverb=True, pitch_shift=True, limiter=True, gain=True, distortion=True,
    chorus=True, bitcrush=True, clipping=True, compressor=True, delay=True,
    pitch_shift_semitones=2.0, compressor_ratio=4.0)


@pytest.mark.parametrize("flags", [
    ALL_ON,
    dict(reverb=True, delay=True, delay_feedback=0.4, reverb_room_size=0.8),
    dict(pitch_shift=True, pitch_shift_semitones=-3.0, chorus=True,
         chorus_feedback=0.2),
    dict(compressor=True, compressor_ratio=6.0, compressor_threshold=-20.0,
         limiter=True, gain=True, gain_db=9.0, clipping=True),
    dict(),
], ids=["all", "space", "pitch_chorus", "dynamics", "none"])
def test_apply_post_process_matches_jax(flags):
    sr = 48000
    audio = _voice(sr, 1.5, seed=4)
    want = jax_fx.apply_post_process(audio, sr, **flags)
    got = postprocess.apply_post_process(torch.from_numpy(audio), sr, **flags)
    if not flags.get("bitcrush"):
        _close(want, got, TOL)
    else:
        err = np.abs(got.numpy() - want)
        assert (err > TOL).sum() <= want.size // 5000
        assert err.max() <= 1.0 / 128 + TOL
    assert postprocess.EFFECT_ORDER == jax_fx.EFFECT_ORDER


@pytest.mark.parametrize("timbre", [0.8, 1.0, 1.25])
@pytest.mark.parametrize("quefrency", [1.0, 3.0])
def test_formant_shift_matches_jax(timbre, quefrency):
    audio = _voice(16000, 2.0, seed=5)
    want = jax_formant.formant_shift(audio, 16000, quefrency, timbre)
    got = formant.formant_shift(torch.from_numpy(audio), 16000, quefrency, timbre)
    _close(want, got, TOL_FORMANT)


def test_formant_shift_one_bin_lifter():
    """quefrency under one sample: JAX's cutoff == 1 lifter keeps bin 0."""
    audio = _voice(16000, 1.0, seed=6)
    want = jax_formant.formant_shift(audio, 16000, 0.01, 1.2)
    _close(want, formant.formant_shift(torch.from_numpy(audio), 16000, 0.01, 1.2),
           TOL_FORMANT)


@pytest.mark.parametrize("prop", [0.3, 0.7])
@pytest.mark.parametrize("sr,dtype", [(48000, np.float32), (40000, np.float64)])
def test_spectral_gate_matches_jax(prop, sr, dtype):
    audio = _voice(sr, 1.5, seed=7).astype(dtype)
    want = jax_gate(audio, sr, prop)
    _close(want, postprocess.spectral_gate(torch.from_numpy(audio), sr, prop), TOL)
