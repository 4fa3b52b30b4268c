"""f0 contour -> MIDI transcription (port of ``rvc_tpu/predictors/f0_midi.py``,
the reference's f0-to-MIDI tool, torchfcpe's ``f02midi``).

Self-contained numpy and scipy:

  - ``estimate_tempo``: spectral-flux onset envelope + autocorrelation with
    a log-normal prior around 120 BPM (the shape of librosa.beat.tempo).
  - ``refine_note``: the reference's three cascaded beat-scaled median
    filters, voicing gate, short-run and short-segment cleanup, and
    octave-error correction, at its thresholds (1/6, 1/3, 1/2 beat filters;
    1/4-beat minimum note length).
  - ``write_midi`` / ``read_midi_notes``: a minimal Standard MIDI File
    type-0 writer and reader (tempo meta event + note on/off, 480 ticks per
    beat).

Host-side tooling, not on the serving path.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.signal import medfilt

Segment = Tuple[float, float, int]  # (start_s, end_s, midi_pitch)

_FPS = 100  # f0 frames per second (10 ms hop, the project-wide f0 rate)
_TICKS_PER_BEAT = 480


# ---------------------------------------------------------------------------
# pitch -> note numbers
# ---------------------------------------------------------------------------

def hz_to_note(f0: np.ndarray) -> np.ndarray:
    """Hz -> rounded MIDI note numbers; unvoiced (f0<=0) maps to 0.

    Matches f02midi/transpose.py:12-19 (note = 69 + 12*log2(f0/440 + 1e-4),
    rounded, clipped to [0, 127])."""
    f0 = np.asarray(f0, np.float64)
    note = 69.0 + 12.0 * np.log2(np.maximum(f0, 0.0) / 440.0 + 1e-4)
    note = np.round(note).astype(np.int64)
    return np.clip(note, 0, 127)


def one_beat_frames(tempo: float, fps: int = _FPS) -> int:
    """Frames per beat at `tempo` BPM (quantization.py:31-40)."""
    return int(np.round(60.0 / float(tempo) * fps))


# ---------------------------------------------------------------------------
# note refinement (quantization.py semantics)
# ---------------------------------------------------------------------------

def _median_filter_pitch(note: np.ndarray, size: int,
                         weight: float) -> np.ndarray:
    k = int(size * weight)
    if k % 2 == 0:
        k += 1
    return np.round(medfilt(note.astype(np.float64), max(k, 1)))


def _clean_note_frames(note: np.ndarray, min_len: int) -> np.ndarray:
    """Zero out pitch runs shorter than min_len frames."""
    out = note.copy()
    prev, start = None, 0
    for i in range(len(note) + 1):
        cur = note[i] if i < len(note) else None
        if cur != prev:
            if prev is not None and prev != 0 and i - start < min_len:
                out[start:i] = 0
            prev, start = cur, i
    return out


def _segments_idx(note: np.ndarray) -> Tuple[List[int], List[int]]:
    """Start/end frame indices of nonzero constant-pitch segments."""
    starts, ends = [], []
    n = len(note)
    i = 0
    while i < n:
        if note[i] > 0:
            j = i
            while j + 1 < n and note[j + 1] == note[i]:
                j += 1
            starts.append(i)
            ends.append(j)
            i = j + 1
        else:
            i += 1
    return starts, ends


def _clean_segments(note: np.ndarray, min_len: int) -> np.ndarray:
    """Drop isolated short segments; snap octave errors to the neighbors.

    Reference behavior (quantization.py:125-192): a segment shorter than
    min_len whose gaps to both neighbors exceed min_len is removed; a
    segment whose two neighbors agree on pitch while it differs by an exact
    octave multiple is rewritten to the neighbor pitch."""
    out = note.copy()
    starts, ends = _segments_idx(out)
    for i in range(1, len(starts) - 1):
        seg_len = ends[i] - starts[i]
        if seg_len < min_len:
            gap_next = starts[i + 1] - ends[i]
            gap_prev = starts[i] - ends[i - 1]
            if gap_next > min_len and gap_prev > min_len:
                out[starts[i]:ends[i] + 1] = 0
        prev_p, cur_p, next_p = (out[starts[i - 1]], out[starts[i]],
                                 out[starts[i + 1]])
        if (prev_p == next_p and cur_p != next_p
                and cur_p > 0 and next_p > 0
                and abs(int(cur_p) - int(next_p)) % 12 == 0):
            out[max(starts[i] - 1, 0):ends[i] + 1] = next_p
    return out


def refine_note(note: np.ndarray, tempo: float,
                fps: int = _FPS) -> np.ndarray:
    """Beat-aware smoothing of a frame-level note track
    (quantization.py:199-217): three cascaded median filters at 1/6, 1/3
    and 1/2 beat, voicing taken from the lightest filter, then short-run
    and short-segment cleanup at 1/4 beat."""
    beat = one_beat_frames(tempo, fps)
    note = np.asarray(note, np.float64)
    mf1 = _median_filter_pitch(note, beat, 1 / 6)
    mf2 = _median_filter_pitch(mf1, beat, 1 / 3)
    mf3 = _median_filter_pitch(mf2, beat, 1 / 2)
    voiced = (mf1 > 0).astype(np.float64)
    out = (voiced * mf3).astype(np.int64)
    out = _clean_note_frames(out, int(beat / 4))
    out = _clean_segments(out, int(beat / 4))
    return out


def note_to_segments(note: np.ndarray, fps: int = _FPS) -> List[Segment]:
    """Frame-level notes -> [(start_s, end_s, pitch)] (MIDI.py:95-128)."""
    starts, ends = _segments_idx(np.asarray(note))
    return [(s / fps, e / fps, int(note[s])) for s, e in zip(starts, ends)]


# ---------------------------------------------------------------------------
# tempo estimation (librosa.beat.tempo stand-in)
# ---------------------------------------------------------------------------

def onset_envelope(audio: np.ndarray, sr: int,
                   hop_s: float = 0.01) -> Tuple[np.ndarray, float]:
    """Spectral-flux onset strength at `hop_s` hops; returns (env, fps)."""
    audio = np.asarray(audio, np.float64)
    hop = max(int(sr * hop_s), 1)
    win = 4 * hop
    n = max((len(audio) - win) // hop + 1, 1)
    if len(audio) < win:
        audio = np.pad(audio, (0, win - len(audio)))
    idx = np.arange(win)[None, :] + hop * np.arange(n)[:, None]
    frames = audio[idx] * np.hanning(win)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1))
    logmag = np.log1p(1000.0 * mag)
    flux = np.diff(logmag, axis=0, prepend=logmag[:1])
    env = np.maximum(flux, 0.0).sum(axis=1)
    if env.std() > 0:
        env = (env - env.mean()) / env.std()
    return env, 1.0 / hop_s


def estimate_tempo(audio: np.ndarray, sr: int,
                   min_bpm: float = 30.0, max_bpm: float = 300.0) -> float:
    """Autocorrelation tempo with a log-normal prior around 120 BPM."""
    env, fps = onset_envelope(audio, sr)
    if len(env) < 8:
        return 120.0
    ac = np.correlate(env, env, mode="full")[len(env) - 1:]
    lags = np.arange(len(ac))
    with np.errstate(divide="ignore"):
        bpm = np.where(lags > 0, 60.0 * fps / np.maximum(lags, 1), np.inf)
    valid = (bpm >= min_bpm) & (bpm <= max_bpm)
    if not valid.any() or ac[valid].max() <= 0:
        return 120.0
    # log-normal prior: librosa's default (std 1.0 octave around start_bpm)
    prior = np.exp(-0.5 * ((np.log2(np.where(valid, bpm, 1.0))
                            - math.log2(120.0)) ** 2))
    score = np.where(valid, ac * prior, -np.inf)
    return float(bpm[int(np.argmax(score))])


# ---------------------------------------------------------------------------
# minimal Standard MIDI File writer/reader (pretty_midi stand-in)
# ---------------------------------------------------------------------------

def _vlq(value: int) -> bytes:
    """MIDI variable-length quantity."""
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def write_midi(segments: Sequence[Segment], path: str,
               tempo: float = 120.0, velocity: int = 100,
               program: int = 0) -> None:
    """Write note segments as a type-0 SMF (MIDI.py:128 segment_to_midi:
    one instrument, velocity 100, Acoustic Grand Piano)."""
    tempo = float(tempo)
    tick_per_s = tempo / 60.0 * _TICKS_PER_BEAT
    events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
    for start_s, end_s, pitch in segments:
        p = int(np.clip(pitch, 0, 127))
        on, off = int(round(start_s * tick_per_s)), int(round(end_s * tick_per_s))
        off = max(off, on + 1)
        events.append((on, 1, bytes([0x90, p, velocity & 0x7F])))
        events.append((off, 0, bytes([0x80, p, 0])))
    events.sort(key=lambda e: (e[0], e[1]))

    track = bytearray()
    # tempo meta event (microseconds per quarter note)
    mpqn = int(round(60_000_000 / tempo))
    track += b"\x00\xff\x51\x03" + mpqn.to_bytes(3, "big")
    track += b"\x00" + bytes([0xC0, program & 0x7F])  # program change
    tick = 0
    for t, _, payload in events:
        track += _vlq(t - tick) + payload
        tick = t
    track += b"\x00\xff\x2f\x00"  # end of track

    header = (b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big")
              + (1).to_bytes(2, "big") + _TICKS_PER_BEAT.to_bytes(2, "big"))
    with open(path, "wb") as f:
        f.write(header + b"MTrk" + len(track).to_bytes(4, "big") + track)


def read_midi_notes(path: str) -> List[Segment]:
    """Parse note on/off pairs from an SMF written by write_midi (also
    handles running status and other channels; test/verification use —
    the reference's MIDI.py:58-73 midi_to_segment equivalent)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"not a MIDI file: {path}")
    division = int.from_bytes(data[12:14], "big")
    pos = 14
    tempo = 120.0
    notes: List[Segment] = []
    while pos < len(data):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError(f"bad MIDI chunk at byte {pos} of {path}")
        length = int.from_bytes(data[pos + 4:pos + 8], "big")
        p, end = pos + 8, pos + 8 + length
        tick = 0
        sec = 0.0
        status = 0
        active: dict = {}
        while p < end:
            delta = 0
            while True:
                b = data[p]; p += 1
                delta = (delta << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            # accumulate seconds under the tempo in effect DURING this
            # delta, so notes after a mid-track tempo change stay correct
            sec += delta * 60.0 / (tempo * division)
            tick += delta
            b = data[p]
            if b & 0x80:
                status = b
                p += 1
            if status == 0xFF:  # meta
                mtype = data[p]; p += 1
                mlen = 0
                while True:
                    c = data[p]; p += 1
                    mlen = (mlen << 7) | (c & 0x7F)
                    if not c & 0x80:
                        break
                if mtype == 0x51:
                    tempo = 60_000_000 / int.from_bytes(data[p:p + 3], "big")
                p += mlen
            elif status in (0xF0, 0xF7):  # sysex
                mlen = 0
                while True:
                    c = data[p]; p += 1
                    mlen = (mlen << 7) | (c & 0x7F)
                    if not c & 0x80:
                        break
                p += mlen
            else:
                kind = status & 0xF0
                n_data = 1 if kind in (0xC0, 0xD0) else 2
                d = data[p:p + n_data]; p += n_data
                if kind == 0x90 and d[1] > 0:
                    active[d[0]] = sec
                elif kind == 0x80 or (kind == 0x90 and d[1] == 0):
                    if d[0] in active:
                        notes.append((active.pop(d[0]), sec, int(d[0])))
        pos = end
    notes.sort()
    return notes


# ---------------------------------------------------------------------------
# top level (transpose.py f02midi)
# ---------------------------------------------------------------------------

def f0_to_midi(
    f0: np.ndarray,
    tempo: Optional[float] = None,
    audio: Optional[np.ndarray] = None,
    sr: Optional[int] = None,
    output_path: Optional[str] = None,
    fps: int = _FPS,
) -> List[Segment]:
    """Transcribe an f0 contour (Hz per 10 ms frame) to note segments and
    optionally a .mid file. Mirrors f02midi/transpose.py:21-43: tempo from
    the audio when not given (120 BPM fallback), note rounding, beat-aware
    refinement, segment extraction, MIDI write."""
    if tempo is None:
        tempo = (estimate_tempo(audio, int(sr))
                 if audio is not None and sr else 120.0)
    note = hz_to_note(f0)
    refined = refine_note(note, tempo, fps)
    segments = note_to_segments(refined, fps)
    if output_path is not None:
        write_midi(segments, output_path, tempo=tempo)
    return segments
