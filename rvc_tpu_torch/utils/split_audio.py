"""Silence split and gap-restoring merge for ``split_audio`` conversions
(port of ``rvc_tpu/utils/split_audio.py``): a frame-RMS detector at -60 dB
below the peak over 250 ms frames, and a merge that restores the silent
gaps at the output rate with length-drift compensation."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _frame_db(audio: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n = max(1, 1 + (len(audio) - frame_length) // hop_length)
    pad_to = (n - 1) * hop_length + frame_length
    y = np.pad(audio.astype(np.float32), (0, max(0, pad_to - len(audio))))
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    rms = np.sqrt(np.mean(y[idx] ** 2, axis=1))
    ref = np.max(rms) + 1e-10
    return 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)


def process_audio(audio: np.ndarray, sr: int = 16000,
                  silence_thresh: float = -60.0, min_silence_len: float = 250.0
                  ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Split on silence: (segments, intervals [n, 2] in samples)."""
    frame_length = max(1, int(min_silence_len / 1000 * sr))
    hop_length = max(1, frame_length // 2)
    loud = _frame_db(audio, frame_length, hop_length) > silence_thresh

    intervals, start = [], None
    for i, v in enumerate(loud):
        if v and start is None:
            start = i
        elif not v and start is not None:
            intervals.append((start, i))
            start = None
    if start is not None:
        intervals.append((start, len(loud)))

    out = [[a * hop_length, min(len(audio), b * hop_length + frame_length)]
           for a, b in intervals]
    # the tail extension may run past the next run's start: no overlaps
    for j in range(len(out) - 1):
        out[j][1] = min(out[j][1], out[j + 1][0])
    if not out:
        out = [[0, len(audio)]]
    intervals_arr = np.asarray(out, dtype=np.int64)
    return [audio[s:e] for s, e in intervals_arr], intervals_arr


def merge_audio(segments_org: List[np.ndarray], segments_new: List[np.ndarray],
                intervals: np.ndarray, sr_orig: int, sr_new: int) -> np.ndarray:
    """Reassemble converted segments with the silent gaps restored."""
    merged = np.array([], dtype=np.float32)
    ratio = sr_new / sr_orig
    for i, (start, end) in enumerate(intervals):
        start_new, end_new = int(start * ratio), int(end * ratio)
        diff = len(segments_new[i]) / sr_new - len(segments_org[i]) / sr_orig
        comp = np.zeros(int(abs(diff) * sr_new), np.float32)
        if i == 0 and start_new > 0:
            merged = np.concatenate([merged, np.zeros(start_new, np.float32)])
        if diff > 0:
            merged = np.concatenate([merged, comp])
        merged = np.concatenate([merged, segments_new[i].astype(np.float32)])
        if diff < 0:
            merged = np.concatenate([merged, comp])
        if i < len(intervals) - 1:
            gap = int(intervals[i + 1][0] * ratio) - end_new
            if gap > 0:
                merged = np.concatenate([merged, np.zeros(gap, np.float32)])
    return merged
