"""The voice-conversion serving pipeline (port of the fused single-file
path of ``rvc_tpu/infer/pipeline.py``).

One conversion runs, on the device: RMVPE f0 (mel, DeepUnet, BiGRU,
salience decode), median filter, autotune, pitch shift and 255-bin
quantization, HuBERT features, the retrieval blend (kernel K3), the protect
blend and ``Synthesizer.infer`` (stage tails on kernels K1 and K2). The
host does the 48 Hz high-pass, padding, the RMS envelope and the peak
normalization. With ``precision="bf16"`` the weights and activations are
bf16 and audio crosses the host link as int16 both ways.

Not ported yet: the windowed long-audio path (inputs longer than
``t_max``), the unfused f0 path, batch and mesh modes.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Union

import numpy as np
import torch
from scipy import signal as sps

from ..device import resolve_device
from ..ops.retrieval import retrieve_blend
from ..predictors.rmvpe import decode_salience, rmvpe_mel

AUTOTUNE_REF_FREQS = np.array([
    49.00, 51.91, 55.00, 58.27, 61.74, 65.41, 69.30, 73.42, 77.78, 82.41,
    87.31, 92.50, 98.00, 103.83, 110.00, 116.54, 123.47, 130.81, 138.59,
    146.83, 155.56, 164.81, 174.61, 185.00, 196.00, 207.65, 220.00, 233.08,
    246.94, 261.63, 277.18, 293.66, 311.13, 329.63, 349.23, 369.99, 392.00,
    415.30, 440.00, 466.16, 493.88, 523.25, 554.37, 587.33, 622.25, 659.25,
    698.46, 739.99, 783.99, 830.61, 880.00, 932.33, 987.77, 1046.50,
], dtype=np.float32)

F0_MIN, F0_MAX = 50.0, 1100.0
SAMPLE_RATE = 16000
WINDOW = 160


def _frame_rms(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    pad = frame_length // 2
    y = np.pad(x.astype(np.float32), (pad, pad))
    n = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    return np.sqrt(np.mean(y[idx] ** 2, axis=1))


def _linear_resize_np(x: np.ndarray, size: int) -> np.ndarray:
    n = len(x)
    if n == size:
        return x.astype(np.float32)
    pos = np.clip((np.arange(size, dtype=np.float64) + 0.5) * n / size - 0.5,
                  0, n - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    frac = pos - lo
    return (x[lo] * (1 - frac) + x[hi] * frac).astype(np.float32)


def change_rms(source: np.ndarray, source_rate: int, target: np.ndarray,
               target_rate: int, rate: float) -> np.ndarray:
    """Blend the target's RMS envelope toward the source's."""
    rms1 = _frame_rms(source, source_rate // 2 * 2, source_rate // 2)
    rms2 = _frame_rms(target, target_rate // 2 * 2, target_rate // 2)
    rms1 = _linear_resize_np(rms1, len(target))
    rms2 = np.maximum(_linear_resize_np(rms2, len(target)), 1e-6)
    return (target * (rms1 ** (1 - rate)) * (rms2 ** (rate - 1))).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Windowing parameters (seconds); defaults are the >= 6 GB tier."""

    x_pad: int = 3
    x_query: int = 10
    x_center: int = 60
    x_max: int = 65


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


class Pipeline:
    """Host orchestrator around the device conversion."""

    def __init__(self, tgt_sr: int, synthesizer, embedder,
                 cfg: PipelineConfig = PipelineConfig(),
                 upsample_factor: Optional[int] = None,
                 precision: str = "fp32",
                 device: Union[str, torch.device] = "cuda"):
        """``synthesizer`` and ``embedder`` are moved to ``device`` and, for
        ``precision="bf16"``, cast to bf16 (every floating parameter and
        buffer), in place."""
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")
        self.device = resolve_device(device)
        self.tgt_sr, self.cfg, self.precision = tgt_sr, cfg, precision
        self.dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        self.synthesizer = synthesizer.to(self.device, self.dtype).eval()
        self.embedder = embedder.to(self.device, self.dtype).eval()
        self.t_pad = SAMPLE_RATE * cfg.x_pad
        self.t_pad_tgt = tgt_sr * cfg.x_pad
        self.t_query = SAMPLE_RATE * cfg.x_query
        self.t_center = SAMPLE_RATE * cfg.x_center
        self.t_max = SAMPLE_RATE * cfg.x_max
        self.upp = upsample_factor or (tgt_sr // 100)
        self._rmvpe = None

    def set_rmvpe(self, rmvpe) -> None:
        """Attach an RMVPE predictor (``predictors.rmvpe.RMVPE``); its model
        runs in the pipeline's precision, the decode in float32."""
        rmvpe.model.to(self.device, self.dtype).eval()
        self._rmvpe = rmvpe

    # -- device graph ---------------------------------------------------------

    @torch.no_grad()
    def _convert_core(self, audio16k, pitch, pitchf, p_len: torch.Tensor,
                      sid, index_vectors, index_rate: float, protect: float,
                      generator=None) -> torch.Tensor:
        feats = self.embedder(audio16k).float()
        feats0 = feats
        if index_vectors is not None:
            b, tt, dd = feats.shape
            feats = retrieve_blend(feats.reshape(b * tt, dd).contiguous(),
                                   index_vectors, index_rate).reshape(b, tt, dd)
        feats = torch.repeat_interleave(feats, 2, dim=1)
        feats0 = torch.repeat_interleave(feats0, 2, dim=1)
        t = min(feats.shape[1], pitch.shape[1])
        feats, feats0 = feats[:, :t], feats0[:, :t]
        pitch, pitchf = pitch[:, :t], pitchf[:, :t]
        if protect < 0.5:
            pitchff = torch.where(pitchf > 0, torch.ones_like(pitchf),
                                  torch.full_like(pitchf, protect))[..., None]
            feats = feats * pitchff + feats0 * (1.0 - pitchff)
        lengths = torch.clamp(p_len, max=t)
        audio, _ = self.synthesizer.infer(feats, lengths, pitch, pitchf, sid,
                                          generator=generator)
        audio = audio[..., 0]
        if self.precision == "bf16":
            return torch.clamp(audio.float() * 32767.0, -32768, 32767).to(torch.int16)
        return audio

    @torch.no_grad()
    def _convert_fused(self, audio16k, p_len, sid, index_vectors,
                       index_rate: float, protect: float, pitch_shift: float,
                       autotune_strength: float, generator=None,
                       use_autotune: bool = False, filter_radius: int = 3,
                       f0_frames: int = 0) -> torch.Tensor:
        dev = audio16k.device
        if not torch.is_floating_point(audio16k):
            audio16k = audio16k.float() / 32767.0
        mel = rmvpe_mel(audio16k)[:, :f0_frames]
        pad = (-f0_frames) % 32
        if pad:
            mel = torch.nn.functional.pad(mel.transpose(1, 2), (0, pad),
                                          mode="reflect").transpose(1, 2)
        hidden = self._rmvpe.model(mel.to(self.dtype)).float()
        f0 = torch.stack([decode_salience(h) for h in hidden[:, :f0_frames]])

        if filter_radius >= 3:  # median filter with zero-padded edges
            r = filter_radius if filter_radius % 2 == 1 else filter_radius + 1
            padded = torch.nn.functional.pad(f0, (r // 2, r // 2))
            f0 = torch.sort(padded.unfold(1, r, 1), dim=-1).values[..., r // 2]
        if use_autotune:
            freqs = torch.from_numpy(AUTOTUNE_REF_FREQS).to(dev)
            idx = torch.argmin(torch.abs(f0[..., None] - freqs), dim=-1)
            f0 = f0 + (freqs[idx] - f0) * _f32(autotune_strength, dev)
        f0 = f0 * (2.0 ** (_f32(pitch_shift, dev) / 12.0))

        f0_mel_min = 1127.0 * torch.log(_f32(1.0 + F0_MIN / 700.0, dev))
        f0_mel_max = 1127.0 * torch.log(_f32(1.0 + F0_MAX / 700.0, dev))
        f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
        scaled = (f0_mel - f0_mel_min) * 254.0 / (f0_mel_max - f0_mel_min) + 1.0
        f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
        coarse = torch.round(torch.clamp(f0_mel, 1.0, 255.0)).to(torch.int64)

        frames = audio16k.shape[1] // WINDOW
        return self._convert_core(
            audio16k.to(self.dtype), coarse[:, :frames], f0[:, :frames], p_len,
            sid, index_vectors, index_rate, protect, generator)

    # -- host entry points ----------------------------------------------------

    def _quantize_in(self, arr: np.ndarray) -> np.ndarray:
        if self.precision == "bf16":
            return np.clip(arr * 32767.0, -32768, 32767).astype(np.int16)
        return arr

    @staticmethod
    def _to_host(audio_out) -> np.ndarray:
        out = audio_out.cpu().numpy() if torch.is_tensor(audio_out) else audio_out
        if out.dtype == np.int16:
            out = out.astype(np.float32) / 32767.0
        return out

    def _bucket_len(self, t: int) -> int:
        """Pad a 16 kHz length up to a whole second."""
        step = SAMPLE_RATE
        return ((t + step - 1) // step) * step

    def _p_len(self, t_real: int, t_pad: int) -> int:
        emb_frames = 2 * ((t_pad - 400) // 320 + 1)
        return min(t_real // WINDOW, emb_frames)

    def _highpass(self, audio: np.ndarray) -> np.ndarray:
        bh, ah = sps.butter(5, 48, btype="high", fs=SAMPLE_RATE)
        return sps.filtfilt(bh, ah, audio).astype(np.float32)

    def _find_cut_points(self, audio: np.ndarray) -> List[int]:
        """Quietest-sample search every t_center within +-t_query."""
        if audio.shape[0] <= self.t_max:
            return []
        audio_pad = np.pad(audio, (WINDOW // 2, WINDOW // 2), mode="reflect")
        audio_sum = np.zeros_like(audio)
        for i in range(WINDOW):
            audio_sum += audio_pad[i:i - WINDOW]
        return [t - self.t_query + int(np.argmin(
                    np.abs(audio_sum[t - self.t_query:t + self.t_query])))
                for t in range(self.t_center, audio.shape[0], self.t_center)]

    def _prepare(self, seg: np.ndarray):
        """Pad one segment to its bucket: (host input, p_len, f0_frames)."""
        t_real = seg.shape[0]
        t_pad = self._bucket_len(t_real)
        audio_in = np.zeros(t_pad, np.float32)
        audio_in[:t_real] = seg
        return self._quantize_in(audio_in)[None], self._p_len(t_real, t_pad), \
            t_pad // WINDOW + 1

    def _index_on_device(self, index_vectors):
        if index_vectors is None:
            return None
        if torch.is_tensor(index_vectors):
            return index_vectors.to(self.device, torch.float32).contiguous()
        return torch.from_numpy(
            np.ascontiguousarray(index_vectors, np.float32)).to(self.device)

    def _dispatch(self, host_in: torch.Tensor, p_len: int, f0_frames: int,
                  sid: int, index_vectors, index_rate, protect, generator,
                  pitch_shift, f0_autotune, f0_autotune_strength,
                  filter_radius) -> torch.Tensor:
        if self._rmvpe is None:
            raise RuntimeError("attach an RMVPE predictor with set_rmvpe first")
        return self._convert_fused(
            host_in.to(self.device, non_blocking=True),
            torch.tensor([p_len], device=self.device),
            torch.tensor([sid], device=self.device),
            index_vectors, float(index_rate), float(protect),
            float(pitch_shift), float(f0_autotune_strength), generator,
            use_autotune=bool(f0_autotune), filter_radius=int(filter_radius),
            f0_frames=f0_frames)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def voice_conversion_fused(
        self, audio_seg: np.ndarray, sid: int, index_vectors,
        index_rate: float, protect: float, generator=None,
        pitch_shift: float = 0, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, filter_radius: int = 3,
    ) -> np.ndarray:
        """f0 (RMVPE) + quantize + convert for one segment."""
        host_in, p_len, f0_frames = self._prepare(audio_seg)
        out = self._dispatch(
            torch.from_numpy(host_in), p_len, f0_frames, sid,
            self._index_on_device(index_vectors), index_rate, protect,
            generator if generator is not None else self._generator(0),
            pitch_shift, f0_autotune, f0_autotune_strength, filter_radius)
        return self._to_host(out)[0][: p_len * self.upp]

    def voice_conversion_fused_stream(
        self, audio_segs: List[np.ndarray], sid: int, index_vectors,
        index_rate: float, protect: float, seed: int = 0,
        pitch_shift: float = 0, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, filter_radius: int = 3,
        depth: int = 2, prep=None, generators=None,
    ) -> List[np.ndarray]:
        """Serve a stream of requests: the host prepares and enqueues request
        i+1 (pinned upload, device work, pinned download all enqueued on the
        current CUDA stream without waiting) while the device computes
        request i; a drain thread waits for each result in order. At most
        ``depth + 2`` results are in flight. Request i uses
        ``generators[i]``, by default a generator seeded with ``seed + i``."""
        index_vectors = self._index_on_device(index_vectors)
        cuda = self.device.type == "cuda"
        max_inflight = max(int(depth), 2) + 2

        def drain(out_host, done, p_len):
            if done is not None:
                done.synchronize()
            return self._to_host(out_host)[0][: p_len * self.upp]

        futures = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            for i, seg in enumerate(audio_segs):
                if prep is not None:
                    seg = prep(seg)
                host_in, p_len, f0_frames = self._prepare(seg)
                host_in = torch.from_numpy(host_in)
                if cuda:
                    host_in = host_in.pin_memory()
                gen = (generators[i] if generators is not None
                       else self._generator(seed + i))
                out = self._dispatch(
                    host_in, p_len, f0_frames, sid, index_vectors, index_rate,
                    protect, gen, pitch_shift, f0_autotune,
                    f0_autotune_strength, filter_radius)
                done = None
                if cuda:
                    out_host = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=True)
                    out_host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    out_host = out
                futures.append(pool.submit(drain, out_host, done, p_len))
                if i >= max_inflight:
                    futures[i - max_inflight].result()
            return [f.result() for f in futures]

    def pipeline(
        self, audio: np.ndarray, sid: int = 0, pitch_shift: float = 0,
        f0_method: str = "rmvpe", index_vectors=None, index_rate: float = 0.0,
        volume_envelope: float = 1.0, protect: float = 0.5,
        f0_autotune: bool = False, f0_autotune_strength: float = 1.0,
        generator=None, filter_radius: float = 3,
    ) -> np.ndarray:
        """Full conversion of a 16 kHz waveform -> tgt_sr waveform, for
        inputs up to ``t_max`` with the attached RMVPE predictor."""
        if f0_method != "rmvpe" or self._rmvpe is None:
            raise NotImplementedError(
                "the port serves f0_method='rmvpe' with set_rmvpe() only")
        index_arr = (self._index_on_device(index_vectors)
                     if index_vectors is not None and index_rate > 0 else None)
        audio = self._highpass(audio)
        if self._find_cut_points(audio):
            raise NotImplementedError(
                "inputs longer than t_max need the windowed path, not ported yet")
        audio_pad = np.pad(audio, (self.t_pad, self.t_pad), mode="reflect")
        seg_out = self.voice_conversion_fused(
            audio_pad, sid, index_arr, index_rate, protect, generator,
            pitch_shift=pitch_shift, f0_autotune=f0_autotune,
            f0_autotune_strength=f0_autotune_strength,
            filter_radius=int(filter_radius or 0))
        audio_opt = seg_out[self.t_pad_tgt: -self.t_pad_tgt]
        if volume_envelope != 1.0:
            audio_opt = change_rms(audio, SAMPLE_RATE, audio_opt, self.tgt_sr,
                                   volume_envelope)
        peak = np.abs(audio_opt).max() / 0.99
        if peak > 1.0:
            audio_opt = audio_opt / peak
        return audio_opt.astype(np.float32)
