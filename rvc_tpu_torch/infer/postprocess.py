"""The ten-effect post-FX chain on the device (port of
``rvc_tpu/infer/postprocess.py``).

The same effects as the JAX package, with its knob names, defaults and
chain order (``EFFECT_ORDER``): a Schroeder/freeverb-style reverb, an STFT
phase-vocoder pitch shift, one-pole envelope dynamics, a modulated-delay
chorus, and the elementwise gain, distortion, bitcrush and clipping. Each
function takes a [T] tensor and returns a float32 [T] tensor on the same
device, and computes each step in the dtype numpy computes it in: float32
where the JAX module's arrays stay float32, float64 where they promote
(the envelope, the combs and allpasses, chorus' positions, the phase
vocoder's phases).

The recursions run as doubling scans (``ops/scan.py``): the envelope's
release as a decay-max, its attack and every comb and allpass as a linear
recurrence over the rows of the signal viewed as (rows, delay). The STFT
pair is scipy's (``ops/sps_stft.py``). No step loops over samples or rows,
and no step reads a value back to the host.
"""

from __future__ import annotations

import math

import torch

from ..ops.scan import decay_max, linear_recurrence
from ..ops.sps_stft import istft, stft

F64 = torch.float64


def _f32(audio: torch.Tensor) -> torch.Tensor:
    return audio.to(torch.float32)


def gain(audio: torch.Tensor, sr: int, gain_db: float = 0.0) -> torch.Tensor:
    return _f32(audio * (10.0 ** (gain_db / 20.0)))


def distortion(audio: torch.Tensor, sr: int, drive_db: float = 25.0) -> torch.Tensor:
    """Tanh waveshaper with drive."""
    return _f32(torch.tanh(audio * (10.0 ** (drive_db / 20.0))))


def clipping(audio: torch.Tensor, sr: int, threshold_db: float = -6.0) -> torch.Tensor:
    t = 10.0 ** (threshold_db / 20.0)
    return _f32(torch.clamp(audio, -t, t))


def bitcrush(audio: torch.Tensor, sr: int, bit_depth: int = 8) -> torch.Tensor:
    half = (2 ** int(bit_depth)) / 2
    return _f32(torch.round(audio * half) / half)


def _envelope(audio: torch.Tensor, sr: int, attack_ms: float,
              release_ms: float) -> torch.Tensor:
    """Peak envelope follower in float64: the release r[k] = max(|x[k]|,
    rel * r[k-1]), then the one-pole attack env[k] = atk * env[k-1] +
    (1 - atk) * r[k]; returned as float32."""
    atk = math.exp(-1.0 / max(sr * attack_ms / 1000.0, 1.0))
    rel = math.exp(-1.0 / max(sr * release_ms / 1000.0, 1.0))
    r = decay_max(torch.abs(audio).to(F64), rel)
    return _f32(linear_recurrence((1.0 - atk) * r, atk))


def compressor(audio: torch.Tensor, sr: int, threshold_db: float = 0.0,
               ratio: float = 1.0, attack_ms: float = 1.0,
               release_ms: float = 100.0) -> torch.Tensor:
    if ratio <= 1.0:
        return _f32(audio)
    env = _envelope(audio, sr, attack_ms, release_ms)
    env_db = 20.0 * torch.log10(torch.clamp(env, min=1e-9))
    over = torch.clamp(env_db - threshold_db, min=0.0)
    gain_db = -over * (1.0 - 1.0 / ratio)
    return _f32(audio * (10.0 ** (gain_db / 20.0)))


def limiter(audio: torch.Tensor, sr: int, threshold_db: float = -6.0,
            release_s: float = 0.01) -> torch.Tensor:
    env = _envelope(audio, sr, 0.1, release_s * 1000.0)
    t = 10.0 ** (threshold_db / 20.0)
    g = torch.clamp(t / torch.clamp(env, min=1e-9), max=1.0)
    return _f32(audio * g)


def delay(audio: torch.Tensor, sr: int, seconds: float = 0.5,
          feedback: float = 0.0, mix: float = 0.5) -> torch.Tensor:
    """Up to 7 taps d, 2d, ... after the signal, each ``feedback`` times
    the last, stopped when a tap's gain falls under 1e-3 or leaves the
    clip."""
    audio = _f32(audio)
    d = max(1, int(seconds * sr))
    n = audio.shape[0]
    wet = torch.zeros_like(audio)
    g = 1.0
    for k in range(1, 8):
        off = d * k
        if off >= n or g < 1e-3:
            break
        wet[off:] += g * audio[:n - off]
        g *= feedback
        if feedback <= 0:
            break
    return _f32((1 - mix) * audio + mix * wet)


def _interp(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y read at fractional float64 positions (clipped to y), linearly."""
    idx = torch.clamp(idx, 0, y.shape[0] - 1)
    lo = torch.floor(idx).long()
    hi = torch.clamp(lo + 1, max=y.shape[0] - 1)
    frac = idx - lo
    return y[lo] * (1 - frac) + y[hi] * frac


def chorus(audio: torch.Tensor, sr: int, rate_hz: float = 1.0,
           depth: float = 0.25, center_delay_ms: float = 7.0,
           feedback: float = 0.0, mix: float = 0.5) -> torch.Tensor:
    """A sine-modulated fractional delay around ``center_delay_ms``, read
    by linear interpolation in float64; feedback adds the wet signal
    delayed by the center (zero-padded, not circular)."""
    audio = _f32(audio)
    n = audio.shape[0]
    t = torch.arange(n, dtype=F64, device=audio.device)
    center = center_delay_ms * sr / 1000.0
    mod = center * (1.0 + depth * torch.sin(2 * math.pi * rate_hz * t / sr))
    wet = _interp(audio, t - mod)
    if feedback > 0:
        d = int(center)
        if d <= 0:
            fb = wet
        else:
            fb = torch.zeros_like(wet)
            if d < n:
                fb[d:] = wet[:n - d]
        wet = wet + feedback * fb
    return _f32((1 - mix) * audio + mix * wet)


def _delayed_recursion(x: torch.Tensor, d: int, b0: float, b1: float,
                       a1: float) -> torch.Tensor:
    """y[n] = b0*x[n] + b1*x[n-d] + a1*y[n-d] in float64: the d interleaved
    first-order recursions it decomposes into, as the rows of x viewed as
    (m, d)."""
    n = x.shape[0]
    m = -(-n // d)
    xp = torch.nn.functional.pad(x.to(F64), (0, m * d - n)).view(m, d)
    u = b0 * xp
    if b1:
        u = u + b1 * torch.nn.functional.pad(xp[:-1], (0, 0, 1, 0))
    return linear_recurrence(u, a1).reshape(-1)[:n]


COMB_DELAYS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASS_DELAYS = (556, 441, 341, 225)


def reverb(audio: torch.Tensor, sr: int, room_size: float = 0.5,
           damping: float = 0.5, wet_gain: float = 0.33,
           dry_gain: float = 0.4, width: float = 1.0,
           freeze_mode: float = 0.0) -> torch.Tensor:
    """Schroeder/freeverb-style: 8 damped combs, then 4 allpasses (mono);
    the mix is scaled down to a peak of 1 where it exceeds it."""
    audio = _f32(audio)
    scale = sr / 44100.0
    feedback = 0.7 + 0.28 * room_size if freeze_mode < 0.5 else 1.0
    damp = damping * 0.4
    x = audio.to(F64)
    out = torch.zeros_like(x)
    for cd in COMB_DELAYS:
        # damped comb y[n] = x[n-d] + f*(1-damp)*y[n-d]
        out = out + _delayed_recursion(x, max(1, int(cd * scale)), 0.0, 1.0,
                                       feedback * (1.0 - damp))
    out = out / len(COMB_DELAYS)
    for ad in ALLPASS_DELAYS:
        # allpass y[n] = -0.5 x[n] + x[n-d] + 0.5 y[n-d]
        out = _delayed_recursion(out, max(1, int(ad * scale)), -0.5, 1.0, 0.5)
    mixed = dry_gain * audio + wet_gain * _f32(out)
    return _f32(mixed / torch.clamp(torch.abs(mixed).max(), min=1.0))


def pitch_shift(audio: torch.Tensor, sr: int, semitones: float = 0.0) -> torch.Tensor:
    """STFT phase-vocoder stretch by 1/factor, then a linear resample back
    to the input's length: the pitch moves by ``semitones``."""
    audio = _f32(audio)
    if abs(semitones) < 1e-6:
        return audio
    factor = 2.0 ** (semitones / 12.0)
    n_fft, hop = 2048, 512
    z = stft(audio, n_fft, hop)
    mag, phase = torch.abs(z), torch.angle(z)
    n_bins, n_frames = z.shape
    step = 1.0 / factor
    # np.arange(0, n_frames, step): ceil(n_frames / step) points i * step
    steps = torch.arange(math.ceil(n_frames / step), dtype=F64,
                         device=audio.device) * step
    dphi = torch.diff(phase, dim=1, prepend=phase[:, :1])
    omega = (2 * math.pi * hop / n_fft) * torch.arange(
        n_bins, dtype=F64, device=audio.device)[:, None]
    wrapped = torch.remainder(dphi - omega + math.pi, 2 * math.pi) - math.pi + omega
    lo = torch.clamp(torch.floor(steps).long(), max=n_frames - 1)
    acc = torch.cumsum(wrapped[:, lo], dim=1)
    y = istft(torch.polar(mag[:, lo].to(F64), acc), n_fft, hop)
    idx = torch.arange(audio.shape[0], dtype=F64, device=audio.device) * factor
    return _f32(_interp(y, idx))


def _fade(n: int, device) -> torch.Tensor:
    """noisereduce's triangular fade: 0 up to 1 in n steps, back in n."""
    up = torch.linspace(0, 1, n + 1, dtype=F64, device=device)
    return torch.cat([up, torch.linspace(1, 0, n + 2, dtype=F64, device=device)[1:-1]])


def spectral_gate(audio: torch.Tensor, sr: int, prop_decrease: float = 0.7,
                  n_fft: int = 1024, n_std_thresh: float = 1.5,
                  freq_mask_smooth_hz: float = 500.0,
                  time_mask_smooth_ms: float = 50.0) -> torch.Tensor:
    """Stationary spectral-gate denoise (``clean_audio``; port of the JAX
    package's ``train/preprocess.spectral_gate``): per-frequency mean and
    standard deviation in dB over the quietest 20% of frames, a gate above
    mean + ``n_std_thresh`` deviations, smoothed by a triangular
    time-frequency fade and scaled by ``prop_decrease``. The frame
    selection is a weight, not an index, so nothing waits for the device;
    the fade is scipy's ``fftconvolve(mode="same")`` as a float64 conv2d
    with the flipped kernel."""
    hop = n_fft // 4
    z = stft(audio, n_fft, hop)
    mag_db = 20.0 * torch.log10(torch.abs(z) + 1e-12)
    frame_db = mag_db.mean(dim=0)
    sel = frame_db <= torch.quantile(frame_db, 0.2)
    sel = (sel | ~sel.any()).to(mag_db.dtype)  # never an empty selection
    count = sel.sum()
    mean_db = (mag_db * sel).sum(dim=1, keepdim=True) / count
    std_db = torch.sqrt(((mag_db - mean_db) ** 2 * sel).sum(dim=1, keepdim=True)
                        / count)
    mask = (mag_db > mean_db + n_std_thresh * std_db).to(F64)

    n_freq = max(1, int(freq_mask_smooth_hz / (sr / n_fft)))
    n_time = max(1, int(time_mask_smooth_ms / 1000.0 * sr / hop))
    kern = torch.outer(_fade(n_freq, audio.device), _fade(n_time, audio.device))
    kern = kern / kern.sum()
    kf, kt = kern.shape
    # "same": the centre of the full convolution, (k - 1) // 2 past its start
    mask = torch.nn.functional.pad(
        mask[None, None], (kt // 2, (kt - 1) // 2, kf // 2, (kf - 1) // 2))
    mask = torch.nn.functional.conv2d(mask, kern.flip(0, 1)[None, None])[0, 0]
    gain = 1.0 - prop_decrease * (1.0 - torch.clamp(mask, 0.0, 1.0))
    return _f32(istft(z * gain, n_fft, hop)[:audio.shape[0]])


EFFECT_ORDER = (
    "reverb", "pitch_shift", "limiter", "gain", "distortion",
    "chorus", "bitcrush", "clipping", "compressor", "delay",
)


def apply_post_process(audio: torch.Tensor, sr: int, **kw) -> torch.Tensor:
    """Apply the enabled effects in the chain order. Flags: reverb=True,
    gain=True, ... with their parameter kwargs (reverb_room_size=...,
    gain_db=..., the CLI's names and defaults)."""
    if kw.get("reverb"):
        audio = reverb(
            audio, sr,
            kw.get("reverb_room_size", 0.5), kw.get("reverb_damping", 0.5),
            kw.get("reverb_wet_gain", 0.33), kw.get("reverb_dry_gain", 0.4),
            kw.get("reverb_width", 1.0), kw.get("reverb_freeze_mode", 0.0))
    if kw.get("pitch_shift"):
        audio = pitch_shift(audio, sr, kw.get("pitch_shift_semitones", 0.0))
    if kw.get("limiter"):
        audio = limiter(audio, sr, kw.get("limiter_threshold", -6.0),
                        kw.get("limiter_release_time", 0.01))
    if kw.get("gain"):
        audio = gain(audio, sr, kw.get("gain_db", 0.0))
    if kw.get("distortion"):
        audio = distortion(audio, sr, kw.get("distortion_gain", 25.0))
    if kw.get("chorus"):
        audio = chorus(
            audio, sr, kw.get("chorus_rate", 1.0), kw.get("chorus_depth", 0.25),
            kw.get("chorus_center_delay", 7.0), kw.get("chorus_feedback", 0.0),
            kw.get("chorus_mix", 0.5))
    if kw.get("bitcrush"):
        audio = bitcrush(audio, sr, kw.get("bitcrush_bit_depth", 8))
    if kw.get("clipping"):
        audio = clipping(audio, sr, kw.get("clipping_threshold", -6.0))
    if kw.get("compressor"):
        audio = compressor(
            audio, sr, kw.get("compressor_threshold", 0.0),
            kw.get("compressor_ratio", 1.0), kw.get("compressor_attack", 1.0),
            kw.get("compressor_release", 100.0))
    if kw.get("delay"):
        audio = delay(audio, sr, kw.get("delay_seconds", 0.5),
                      kw.get("delay_feedback", 0.0), kw.get("delay_mix", 0.5))
    return audio
