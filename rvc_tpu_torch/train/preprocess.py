"""Dataset preprocessing: slice, filter, normalize, write at two rates
(port of ``rvc_tpu/train/preprocess.py``).

Walks the dataset (speaker ids from the subfolder names) and for each file:
load and resample, optionally the 48 Hz Butterworth high-pass and the
alpha-blend normalization (a take with peak > 2.5 or peak 0 is rejected),
optionally the spectral-gate denoise, then one of three cut modes (Skip,
Simple fixed chunks, Automatic silence slicing into 3 s pieces with 0.3 s
overlap), and writes ``<sid>_<idx0>_<idx1>.wav`` as float WAV at the model
rate and at 16 kHz. The total duration goes into ``model_info.json``.

Host work in numpy and scipy (and the C++ engine of ``utils/native.py``
where it is built), over files in a thread pool: the resampler and the
filters are native code that releases the interpreter lock.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
from typing import List, Optional

import numpy as np
from scipy import signal as sps

from ..utils.audio_io import load_audio, resample, write_wav

OVERLAP = 0.3
PERCENTAGE = 3.0
MAX_AMPLITUDE = 0.9
ALPHA = 0.75
HIGH_PASS_CUTOFF = 48
SR16K = 16000


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """RMS per frame with centered zero padding; the C++ scanner when it
    is built."""
    from ..utils import native

    out = native.frame_rms(y, frame_length, hop_length)
    if out is not None:
        return out
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    n = (len(y) - frame_length) // hop_length + 1
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    return np.sqrt(np.mean(y[idx] ** 2, axis=1))


class Slicer:
    """Silence-based slicer: the leading, short, medium and long silence
    cases keyed on ``max_sil_kept``."""

    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,
        min_interval: int = 300,
        hop_size: int = 20,
        max_sil_kept: int = 5000,
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if not max_sil_kept >= hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _cut(self, waveform: np.ndarray, begin: int, end: int) -> np.ndarray:
        start = begin * self.hop_size
        stop = min(waveform.shape[0], end * self.hop_size)
        return waveform[start:stop]

    def slice(self, waveform: np.ndarray) -> List[np.ndarray]:
        samples = waveform
        if samples.shape[0] <= self.min_length * self.hop_size:
            return [waveform]
        rms = frame_rms(samples, self.win_size, self.hop_size)

        sil_tags: List[tuple] = []
        silence_start: Optional[int] = None
        clip_start = 0
        K = self.max_sil_kept
        for i, r in enumerate(rms):
            if r < self.threshold:
                if silence_start is None:
                    silence_start = i
                continue
            if silence_start is None:
                continue
            leading = silence_start == 0 and i > K
            middle = (
                i - silence_start >= self.min_interval
                and i - clip_start >= self.min_length
            )
            if not leading and not middle:
                silence_start = None
                continue
            if i - silence_start <= K:
                pos = int(rms[silence_start : i + 1].argmin()) + silence_start
                if silence_start == 0:
                    sil_tags.append((0, pos))
                else:
                    sil_tags.append((pos, pos))
                clip_start = pos
            elif i - silence_start <= K * 2:
                pos = int(rms[i - K : silence_start + K + 1].argmin()) + i - K
                pos_l = int(rms[silence_start : silence_start + K + 1].argmin()) + silence_start
                pos_r = int(rms[i - K : i + 1].argmin()) + i - K
                if silence_start == 0:
                    sil_tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    sil_tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = int(rms[silence_start : silence_start + K + 1].argmin()) + silence_start
                pos_r = int(rms[i - K : i + 1].argmin()) + i - K
                if silence_start == 0:
                    sil_tags.append((0, pos_r))
                else:
                    sil_tags.append((pos_l, pos_r))
                clip_start = pos_r
            silence_start = None

        total = len(rms)
        if silence_start is not None and total - silence_start >= self.min_interval:
            end = min(total, silence_start + K)
            pos = int(rms[silence_start : end + 1].argmin()) + silence_start
            sil_tags.append((pos, total + 1))

        if not sil_tags:
            return [waveform]
        chunks = []
        if sil_tags[0][0] > 0:
            chunks.append(self._cut(waveform, 0, sil_tags[0][0]))
        for a, b in zip(sil_tags[:-1], sil_tags[1:]):
            chunks.append(self._cut(waveform, a[1], b[0]))
        if sil_tags[-1][1] < total:
            chunks.append(self._cut(waveform, sil_tags[-1][1], total))
        return [c for c in chunks if len(c) > 0]


def spectral_gate(
    audio: np.ndarray,
    sr: int,
    prop_decrease: float = 0.7,
    n_fft: int = 1024,
    n_std_thresh: float = 1.5,
    freq_mask_smooth_hz: float = 500.0,
    time_mask_smooth_ms: float = 50.0,
) -> np.ndarray:
    """Stationary spectral-gate denoise after noisereduce's algorithm:
    per-frequency noise statistics in dB over the clip, a mean + n_std
    threshold, a boolean gate smoothed by a separable time-frequency fade,
    scaled by ``prop_decrease``."""
    hop = n_fft // 4
    _, _, Z = sps.stft(audio, sr, nperseg=n_fft, noverlap=n_fft - hop)
    mag_db = 20.0 * np.log10(np.abs(Z) + 1e-12)

    # noise profile from the quietest 20% of frames (no noise clip is
    # given, so the low-energy frames stand in for one)
    frame_db = mag_db.mean(axis=0)
    noise_sel = frame_db <= np.quantile(frame_db, 0.2)
    if not noise_sel.any():
        noise_sel[:] = True
    noise = mag_db[:, noise_sel]
    mean_db = noise.mean(axis=1, keepdims=True)
    std_db = noise.std(axis=1, keepdims=True)
    thresh = mean_db + n_std_thresh * std_db
    mask = (mag_db > thresh).astype(np.float32)

    # separable triangular smoothing (noisereduce's fade filter)
    n_freq = max(1, int(freq_mask_smooth_hz / (sr / n_fft)))
    n_time = max(1, int(time_mask_smooth_ms / 1000.0 * sr / hop))
    kf = np.concatenate([np.linspace(0, 1, n_freq + 1),
                         np.linspace(1, 0, n_freq + 2)[1:-1]])
    kt = np.concatenate([np.linspace(0, 1, n_time + 1),
                         np.linspace(1, 0, n_time + 2)[1:-1]])
    kern = np.outer(kf, kt)
    kern = kern / kern.sum()
    mask = sps.fftconvolve(mask, kern, mode="same")
    mask = np.clip(mask, 0.0, 1.0)

    gain = 1.0 - prop_decrease * (1.0 - mask)
    _, out = sps.istft(Z * gain, sr, nperseg=n_fft, noverlap=n_fft - hop)
    return out[: len(audio)].astype(np.float32)


class PreProcess:
    def __init__(self, sr: int, exp_dir: str):
        self.sr = sr
        self.exp_dir = exp_dir
        self.slicer = Slicer(
            sr=sr, threshold=-42, min_length=1500, min_interval=400,
            hop_size=15, max_sil_kept=500,
        )
        self.b_high, self.a_high = sps.butter(
            5, HIGH_PASS_CUTOFF, btype="high", fs=sr
        )
        self.gt_wavs_dir = os.path.join(exp_dir, "sliced_audios")
        self.wavs16k_dir = os.path.join(exp_dir, "sliced_audios_16k")
        os.makedirs(self.gt_wavs_dir, exist_ok=True)
        os.makedirs(self.wavs16k_dir, exist_ok=True)

    def _normalize(self, audio: np.ndarray) -> Optional[np.ndarray]:
        peak = np.abs(audio).max()
        if peak > 2.5 or peak == 0:
            # a clipped or broken take; peak 0 would divide to NaN
            return None
        # the C++ engine computes the same blend in one pass
        from ..utils import native

        try:
            out = native.normalize_blend(audio, MAX_AMPLITUDE, ALPHA)
        except ValueError:
            return None
        if out is not None:
            return out
        return (audio / peak * (MAX_AMPLITUDE * ALPHA)) + (1 - ALPHA) * audio

    def _write_segment(self, seg: Optional[np.ndarray], sid, idx0, idx1) -> None:
        if seg is None or len(seg) == 0:
            return
        name = f"{sid}_{idx0}_{idx1}.wav"
        write_wav(
            os.path.join(self.gt_wavs_dir, name), seg.astype(np.float32),
            self.sr, subtype="FLOAT",
        )
        seg16 = resample(seg.astype(np.float32), self.sr, SR16K)
        write_wav(
            os.path.join(self.wavs16k_dir, name), seg16, SR16K, subtype="FLOAT"
        )

    def process_file(
        self,
        path: str,
        idx0: int,
        sid: int,
        cut_preprocess: str = "Automatic",
        process_effects: bool = True,
        noise_reduction: bool = False,
        reduction_strength: float = 0.7,
        chunk_len: float = 3.0,
        overlap_len: float = 0.3,
    ) -> float:
        audio = load_audio(path, self.sr)
        duration = len(audio) / self.sr
        if process_effects:
            audio = sps.lfilter(self.b_high, self.a_high, audio)
            audio = self._normalize(audio)
            if audio is None:
                return 0.0
        if noise_reduction:
            audio = spectral_gate(audio, self.sr, reduction_strength)

        if cut_preprocess == "Skip":
            self._write_segment(audio, sid, idx0, 0)
        elif cut_preprocess == "Simple":
            chunk = int(self.sr * chunk_len)
            step = chunk - int(self.sr * overlap_len)
            i = 0
            while i < len(audio):
                seg = audio[i : i + chunk]
                if len(seg) == chunk:
                    self._write_segment(seg, sid, idx0, i // step)
                i += step
        elif cut_preprocess == "Automatic":
            idx1 = 0
            for piece in self.slicer.slice(audio):
                i = 0
                while True:
                    start = int(self.sr * (PERCENTAGE - OVERLAP) * i)
                    i += 1
                    if len(piece[start:]) > (PERCENTAGE + OVERLAP) * self.sr:
                        self._write_segment(
                            piece[start : start + int(PERCENTAGE * self.sr)],
                            sid, idx0, idx1,
                        )
                        idx1 += 1
                    else:
                        self._write_segment(piece[start:], sid, idx0, idx1)
                        idx1 += 1
                        break
        else:
            raise ValueError(f"unknown cut mode {cut_preprocess!r}")
        return duration


def preprocess_training_set(
    dataset_path: str,
    sample_rate: int,
    exp_dir: str,
    cut_preprocess: str = "Automatic",
    process_effects: bool = True,
    noise_reduction: bool = False,
    reduction_strength: float = 0.7,
    chunk_len: float = 3.0,
    overlap_len: float = 0.3,
    num_workers: Optional[int] = None,
) -> float:
    """Process every audio file under ``dataset_path`` and return the total
    hours: files in the dataset root get sid 0, a subfolder whose name ends
    in ``_<digits>`` (or is digits) gives its sid."""
    os.makedirs(exp_dir, exist_ok=True)
    jobs = []
    idx0 = 0
    for root, _, files in sorted(os.walk(dataset_path)):
        base = os.path.basename(root)
        try:
            sid = int(base.split("_")[-1]) if root != dataset_path else 0
        except ValueError:
            sid = 0
        for fn in sorted(files):
            if fn.lower().endswith((".wav", ".flac", ".mp3", ".ogg")):
                jobs.append((os.path.join(root, fn), idx0, sid))
                idx0 += 1

    pp = PreProcess(sample_rate, exp_dir)
    kwargs = dict(
        cut_preprocess=cut_preprocess, process_effects=process_effects,
        noise_reduction=noise_reduction, reduction_strength=reduction_strength,
        chunk_len=chunk_len, overlap_len=overlap_len,
    )
    total_sec = 0.0
    workers = num_workers or min(8, (os.cpu_count() or 1))
    with cf.ThreadPoolExecutor(workers) as ex:
        futures = [
            ex.submit(pp.process_file, path, i0, sid, **kwargs)
            for path, i0, sid in jobs
        ]
        for f in futures:
            total_sec += f.result()

    info_path = os.path.join(exp_dir, "model_info.json")
    info = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
    info["total_dataset_duration"] = total_sec
    with open(info_path, "w") as f:
        json.dump(info, f, indent=4)
    return total_sec / 3600.0
