"""PESQ-WB (ITU-T P.862.2) perceptual quality estimator in pure numpy (a
copy of ``rvc_tpu/utils/pesq_np.py``, which imports no JAX).

The reference gates validation on PESQ through the C `pesq` wheel
(rvc/train/train.py:1549-1561), which does not exist in this environment.
This module implements the P.862 perceptual model so the validation gate is
measurable everywhere:

  fixed-level normalization -> global + per-utterance time alignment ->
  Hann-framed power spectra -> Bark-band grouping (Sp scaling) -> absolute
  hearing threshold (Terhardt) -> partial frequency compensation (bounded
  +/-20 dB) -> smoothed short-term gain compensation -> Zwicker loudness
  (Sl scaling) -> center-clipped disturbance + asymmetric disturbance ->
  per-frame Bark norms with energy weighting -> L6-over-syllables /
  L2-over-time aggregation -> raw = 4.5 - 0.1*D - 0.0309*DA ->
  P.862.2 logistic MOS-LQO map.

Fidelity note (honest): the model structure, the aggregation constants
(0.1 / 0.0309), the logistic map, and the published Sp/Sl power scalings
follow ITU-T P.862 as published; the Bark filter bank uses analytic
equal-Bark bands rather than the ITU table, the absolute threshold is the
Terhardt analytic curve, and the utterance alignment is envelope-correlation
(not the ITU's iterative utterance splitting). Scores are NOT conformance-
tested against the ITU vectors (unavailable offline — docs/PARITY.md) and
the trainer therefore logs them as `pesq_est`, reserving `pesq` for the C
wheel when importable (trainer.validate).
"""

from __future__ import annotations

import numpy as np

SR = 16000
FRAME = 512          # 32 ms @ 16 kHz
HOP = 256
N_BARK = 49          # P.862 wideband band count
# published P.862 power scalings (pesqpar.h, 16 kHz mode)
SP_16K = 6.910853e-6   # published value, kept for documentation
SL_16K = 1.866055e-1
# Internal spectrum scale: with Hann analysis (mean window power 0.375) and
# active level normalized to TARGET_POW per frame, 2/(0.375*FRAME) makes the
# summed Bark-band power of an active frame ~= TARGET_POW (Parseval).
SP_EFF = 2.0 / (0.375 * FRAME)
# P.862.2 logistic MOS-LQO map: y = 0.999 + 4.0 / (1 + exp(-1.3669x + 3.8224))
P862_2_A = (0.999, 4.0, -1.3669, 3.8224)
TARGET_POW = 1e7     # fixed active-band power both signals are scaled to
# Disturbance scalings bridging this model's internal loudness scale to the
# ITU aggregation constants (0.1 / 0.0309). Fitted by grid search so that
# speech + white noise lands on the canonical PESQ-WB MOS curve
# (identity 4.64, 30 dB SNR ~4.2, 20 dB ~3.3, 10 dB ~2.5, 0 dB ~1.7,
# unrelated ~1.1) — see tests/test_round2_fixes.py::test_pesq_wb_estimator.
# This is anchor calibration, NOT ITU conformance (docs/PARITY.md).
D_SCALE = 4.534
DA_SCALE = 0.256


def _hz_to_bark(f: np.ndarray) -> np.ndarray:
    return 6.0 * np.arcsinh(np.asarray(f, np.float64) / 600.0)


def _bark_matrix(n_fft: int, sr: int, n_bands: int) -> np.ndarray:
    """[n_bands, n_bins] summing matrix over equal-Bark slices up to sr/2."""
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    bark = _hz_to_bark(freqs)
    edges = np.linspace(0.5, _hz_to_bark(np.array([sr / 2.0]))[0], n_bands + 1)
    mat = np.zeros((n_bands, len(freqs)))
    for b in range(n_bands):
        sel = (bark >= edges[b]) & (bark < edges[b + 1])
        if sel.any():
            mat[b, sel] = 1.0   # SUM bin powers within the band (ITU-style)
    return mat


def _abs_threshold(n_bands: int, sr: int) -> np.ndarray:
    """Absolute hearing threshold per Bark band (Terhardt analytic curve),
    expressed in the internal power scale: P0[b] such that a band power at
    P0 sits at the threshold of hearing. Stands in for the ITU
    abs_thresh_power table."""
    edges = np.linspace(0.5, _hz_to_bark(np.array([sr / 2.0]))[0],
                        n_bands + 1)
    centers_bark = 0.5 * (edges[:-1] + edges[1:])
    f_khz = 0.6 * np.sinh(centers_bark / 6.0)  # inverse of _hz_to_bark, kHz
    f_khz = np.maximum(f_khz, 0.02)
    thr_db = (3.64 * f_khz ** -0.8
              - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
              + 1e-3 * f_khz ** 4)
    thr_db = np.clip(thr_db, -10.0, 60.0)
    # anchor: the curve minimum (~-3.4 dB near 3.3 kHz) maps to internal
    # power ~50, i.e. ~70 dB below the active mid-band speech power under
    # the TARGET_POW normalization — mirroring the ITU abs_thresh_power
    # table's relation to its fixed calibration level.
    return 1e2 * 10.0 ** (thr_db / 10.0)


def _active_level(x: np.ndarray) -> float:
    """Active speech power (frames above -35 dB of peak RMS)."""
    n = (len(x) // HOP) * HOP
    if n == 0:
        return float(np.mean(x ** 2) + 1e-12)
    frames = x[:n].reshape(-1, HOP)
    p = np.mean(frames ** 2, axis=1)
    thr = p.max() * 10 ** (-3.5)
    active = p[p > thr]
    return float(active.mean() if len(active) else p.mean()) + 1e-12


def _align_global(ref: np.ndarray, deg: np.ndarray,
                  max_delay: int = SR // 2):
    """Global delay via envelope cross-correlation (coarse alignment)."""
    n = min(len(ref), len(deg))
    n64 = (n // 64) * 64
    env_r = np.abs(ref[:n64]).reshape(-1, 64).mean(axis=1) \
        if n64 >= 64 else np.abs(ref[:n])
    env_d = np.abs(deg[:n64]).reshape(-1, 64).mean(axis=1) \
        if n64 >= 64 else np.abs(deg[:n])
    env_r = env_r - env_r.mean()
    env_d = env_d - env_d.mean()
    m = min(len(env_r), len(env_d))
    if m < 4:
        return ref[:n], deg[:n]
    corr = np.correlate(env_d[:m], env_r[:m], mode="full")
    lag = (np.argmax(corr) - (m - 1)) * 64
    lag = int(np.clip(lag, -max_delay, max_delay))
    # sample-level refinement around the envelope estimate (the 64-sample
    # envelope leaves up to +/-32 samples of residual skew, which otherwise
    # reads as disturbance)
    span = min(n, SR * 2)
    best, best_c = 0, -np.inf
    for off in range(-96, 97):
        L = lag + off
        if L >= 0:
            a, b = ref[: span], deg[L : L + span]
        else:
            a, b = ref[-L : -L + span], deg[: span]
        k = min(len(a), len(b))
        if k < FRAME:
            continue
        c = float(np.dot(a[:k], b[:k]))
        if c > best_c:
            best, best_c = L, c
    lag = int(np.clip(best, -max_delay, max_delay))
    if lag > 0:
        deg = deg[lag:]
    elif lag < 0:
        ref = ref[-lag:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


def _align_utterances(ref: np.ndarray, deg: np.ndarray,
                      max_fine: int = SR // 8) -> np.ndarray:
    """Per-utterance fine alignment: split `ref` into active utterances by
    an energy VAD, refine each utterance's delay by sample-level cross-
    correlation against `deg`, and rebuild a delay-compensated degraded
    signal. Approximates P.862's utterance-based alignment (the ITU
    iterative splitting is replaced by VAD segmentation)."""
    n = min(len(ref), len(deg))
    ref, deg = ref[:n], deg[:n]
    nf = n // HOP
    if nf < 8:
        return deg
    p = (ref[: nf * HOP].reshape(-1, HOP) ** 2).mean(axis=1)
    act = p > p.max() * 10 ** (-3.5)
    # merge activity into utterances (close 3-frame gaps, drop <5-frame runs)
    utts = []
    i = 0
    while i < nf:
        if act[i]:
            j = i
            gap = 0
            while j < nf and gap <= 3:
                gap = gap + 1 if not act[j] else 0
                j += 1
            if j - i >= 5:
                utts.append((i * HOP, min(j * HOP, n)))
            i = j
        else:
            i += 1
    if not utts:
        return deg
    out = deg.copy()
    for (s, e) in utts:
        r = ref[s:e]
        lo = max(0, s - max_fine)
        hi = min(n, e + max_fine)
        d = deg[lo:hi]
        if len(d) <= len(r) or len(r) < HOP:
            continue
        # coarse-to-fine: decimate 8x for the search, refine +/-16 samples
        rd, dd = r[::8], d[::8]
        corr = np.correlate(dd - dd.mean(), rd - rd.mean(), mode="valid")
        off8 = int(np.argmax(corr))
        best, best_c = 0, -np.inf
        for off in range(max(0, off8 * 8 - 16),
                         min(len(d) - len(r), off8 * 8 + 17)):
            c = float(np.dot(d[off:off + len(r)], r))
            if c > best_c:
                best, best_c = off, c
        out[s:e] = d[best:best + len(r)]
    return out


def _bark_power(x: np.ndarray, bark_mat: np.ndarray) -> np.ndarray:
    n_frames = max(1, (len(x) - FRAME) // HOP + 1)
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[np.minimum(idx, len(x) - 1)] * np.hanning(FRAME)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    return (spec @ bark_mat.T) * SP_EFF


def _loudness(p: np.ndarray, p0: np.ndarray) -> np.ndarray:
    """Modified Zwicker loudness (P.862 Sl scaling, gamma 0.23)."""
    g = 0.23
    safe_p0 = np.maximum(p0, 1e-20)
    loud = SL_16K * ((safe_p0 / 0.5) ** g) * (
        ((0.5 + 0.5 * p / safe_p0) ** g) - 1.0
    )
    return np.maximum(loud, 0.0)  # below hearing threshold -> silent


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = SR) -> float:
    """Wideband PESQ MOS-LQO estimate in [1.0, 4.64]."""
    ref = np.asarray(ref, np.float64)
    deg = np.asarray(deg, np.float64)
    if sr != SR:
        from .audio_io import resample

        ref = resample(ref.astype(np.float32), sr, SR).astype(np.float64)
        deg = resample(deg.astype(np.float32), sr, SR).astype(np.float64)
    if min(len(ref), len(deg)) < FRAME * 2:
        raise ValueError("inputs too short for PESQ framing")

    # fixed-level normalization: both signals to the same active power
    # (P.862 normalizes to a fixed internal level; relative gain errors are
    # then handled by the bounded gain compensation below)
    ref = ref * np.sqrt(TARGET_POW / FRAME / _active_level(ref))
    deg = deg * np.sqrt(TARGET_POW / FRAME / _active_level(deg))
    ref, deg = _align_global(ref, deg)
    deg = _align_utterances(ref, deg)

    bark_mat = _bark_matrix(FRAME, SR, N_BARK)
    pr = _bark_power(ref, bark_mat)
    pd = _bark_power(deg, bark_mat)
    t = min(len(pr), len(pd))
    pr, pd = pr[:t], pd[:t]
    p0 = _abs_threshold(N_BARK, SR)

    # partial frequency compensation over speech-active frames, +/-20 dB
    # (equalizes the degraded chain's linear frequency response)
    active = pr.sum(axis=1) > pr.sum(axis=1).max() * 1e-3
    mean_r = pr[active].mean(axis=0) + 1e3 if active.any() else \
        pr.mean(axis=0) + 1e3
    mean_d = pd[active].mean(axis=0) + 1e3 if active.any() else \
        pd.mean(axis=0) + 1e3
    band_eq = np.clip(mean_r / mean_d, 1e-2, 1e2)
    pd = pd * band_eq[None, :]

    # short-term gain compensation, first-order smoothed, bounded
    num = pr.sum(axis=1) + 5e5
    den = pd.sum(axis=1) + 5e5
    raw_gain = num / den
    gain = np.empty_like(raw_gain)
    g_prev = 1.0
    for i in range(len(raw_gain)):
        g_prev = 0.8 * g_prev + 0.2 * raw_gain[i]
        gain[i] = np.clip(g_prev, 3e-4, 5.0)
    pd = pd * gain[:, None]

    lr = _loudness(pr, p0)
    ld = _loudness(pd, p0)

    # center-clipped disturbance (deadzone 0.25 * min loudness)
    dead = 0.25 * np.minimum(lr, ld)
    raw = ld - lr
    disturbance = np.sign(raw) * np.maximum(np.abs(raw) - dead, 0.0)

    # asymmetry factor: additive distortions hurt more than omissions
    asym = ((pd + 50.0) / (pr + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    # per-frame norms over bands: L2 for D, L1*asym for DA (ITU weights the
    # bands by width; equal-Bark bands make that uniform here)
    d_frame = np.sqrt(np.mean(disturbance ** 2, axis=1) * N_BARK) * D_SCALE
    da_frame = np.sum(np.abs(disturbance) * asym, axis=1) * DA_SCALE

    # silent-frame weighting: frames with little reference energy count less
    w = ((pr.sum(axis=1) + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / w, 45.0)
    da_frame = np.minimum(da_frame / w, 45.0)

    def lp_time(d: np.ndarray, p_syl: float = 6.0, p_t: float = 2.0,
                chunk: int = 20) -> float:
        n = max(1, len(d) // chunk)
        syl = [
            (np.mean(d[i * chunk:(i + 1) * chunk] ** p_syl)) ** (1 / p_syl)
            for i in range(n)
        ]
        syl = np.asarray(syl)
        return float((np.mean(syl ** p_t)) ** (1 / p_t))

    d_total = lp_time(d_frame)
    da_total = lp_time(da_frame)

    # official P.862 combination + P.862.2 wideband logistic map
    raw_score = 4.5 - 0.1 * d_total - 0.0309 * da_total
    a0, a1, a2, a3 = P862_2_A
    mos_lqo = a0 + a1 / (1.0 + np.exp(a2 * raw_score + a3))
    return float(np.clip(mos_lqo, 1.0, 4.64))
