"""The voice-conversion pipeline (port of ``rvc_tpu/infer/pipeline.py``).

One fused conversion runs, on the device: RMVPE f0 (mel, DeepUnet, BiGRU,
salience decode), median filter, autotune, pitch shift and 255-bin
quantization, HuBERT features, the retrieval blend (kernel K3), the protect
blend and ``Synthesizer.infer`` (stage tails on kernels K1 and K2). The
host does the 48 Hz high-pass, padding, the RMS envelope and the peak
normalization. With ``precision="bf16"`` the weights and activations are
bf16 and the fused path's audio crosses the host link as int16 both ways.

Inputs longer than ``t_max`` take the windowed path: f0 for the whole
padded input on the host side (``get_f0``: the RMVPE predictor in float32,
``scipy.signal.medfilt``, autotune, shift, an external f0 splice), then cut
at the quietest points into windows that ``voice_conversion_stream``
converts with ``_convert_core`` (float32 audio upload, cast on the device).
Batches of whole files go through ``convert_segments_batch`` (windowed
form) or ``voice_conversion_fused_many`` (fused form) as device rows;
``enable_batch_sharding`` splits those rows over several devices, one
replica of the models on each. Every f0 method serves the windowed path
(``get_f0``); the fused path runs RMVPE.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from scipy import signal as sps

from ..device import resolve_device
from ..models.commons import RowDraws
from ..ops.retrieval import retrieve_blend
from ..predictors.f0_extractor import (check_f0_method, interp_f0_to_grid,
                                       parse_f0_methods)
from ..predictors.rmvpe import decode_salience, rmvpe_mel
from ..utils import profiling
from ..utils.profiling import span

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


def autotune_f0(f0: np.ndarray, strength: float = 1.0) -> np.ndarray:
    """Snap each f0 value toward the nearest chromatic reference."""
    idx = np.abs(f0[:, None] - AUTOTUNE_REF_FREQS[None, :]).argmin(axis=1)
    closest = AUTOTUNE_REF_FREQS[idx]
    return f0 + (closest - f0) * strength


def coarse_f0(f0: np.ndarray) -> np.ndarray:
    """Quantize f0 to 255 mel-scale bins + 1."""
    f0_mel_min = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
    f0_mel_max = 1127.0 * np.log(1.0 + F0_MAX / 700.0)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * 254.0 / (f0_mel_max - f0_mel_min) + 1.0
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.clip(f0_mel, 1.0, 255.0)
    return np.rint(f0_mel).astype(np.int32)


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

    @classmethod
    def from_device(cls, device: Union[str, torch.device] = "cuda"
                    ) -> "PipelineConfig":
        """The tier for the device's memory: 5 GB or less gets the low-memory
        windows (1/6/38/41); the CPU counts as 16 GB."""
        dev = torch.device(device)
        gb = 16.0
        if dev.type == "cuda":
            gb = torch.cuda.get_device_properties(dev).total_memory / (1 << 30)
        if gb <= 5:
            return cls(x_pad=1, x_query=6, x_center=38, x_max=41)
        return cls()


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
        self.t_pad2 = self.t_pad * 2
        self.t_query = SAMPLE_RATE * cfg.x_query
        self.t_center = SAMPLE_RATE * cfg.x_center
        self.t_max = SAMPLE_RATE * cfg.x_max
        self.upp = upsample_factor or (tgt_sr // 100)
        self._rmvpe = None
        self._rmvpe_model = None
        self._replicas: Optional[List["Pipeline"]] = None
        self._index_copy = None  # (source index, its copy on this device)

    def set_rmvpe(self, rmvpe) -> None:
        """Attach an RMVPE predictor (``predictors.rmvpe.RMVPE``) for the
        fused graph. Its model runs there in the pipeline's precision, on a
        copy where that differs from the predictor's own device or dtype:
        the predictor itself stays as it is (float32, for the windowed
        path's f0). The salience decode runs in float32."""
        model = rmvpe.model
        p = next(model.parameters())
        if p.device != self.device or p.dtype != self.dtype:
            model = copy.deepcopy(model).to(self.device, self.dtype)
        self._rmvpe, self._rmvpe_model = rmvpe, model.eval()
        for rep in self._replicas or ():
            rep._rmvpe = rmvpe
            rep._rmvpe_model = copy.deepcopy(model).to(rep.device).eval()

    # -- several devices ------------------------------------------------------

    def enable_batch_sharding(self, devices=None) -> None:
        """Split the rows of the batched paths (``convert_segments_batch``,
        ``voice_conversion_fused_many`` and the streams over them) over
        ``devices``, as JAX's shards them over a ``dp`` mesh: every file's
        conversion is independent, so N devices convert N shares of a batch
        with nothing exchanged. Each device gets a replica of the models
        (with its own weight caches) and of the index, made once; a batch is
        padded to a multiple of the device count with copies of its row 0,
        and each replica is driven under ``torch.cuda.device`` by
        asynchronous launches from the calling thread, its rows' noise drawn
        as the unsharded batch draws it. The rows come back in order, equal
        to the unsharded batch's. With no list: every card of the machine,
        and nothing when there are fewer than two."""
        if devices is None:
            n = torch.cuda.device_count() if self.device.type == "cuda" else 0
            if n < 2:
                return
            devices = [f"cuda:{i}" for i in range(n)]
        self._replicas = [self._replica(resolve_device(d)) for d in devices]

    def _replica(self, device: torch.device) -> "Pipeline":
        rep = copy.copy(self)
        rep.device, rep._replicas, rep._index_copy = device, None, None
        rep.synthesizer = copy.deepcopy(self.synthesizer).to(device)
        rep.embedder = copy.deepcopy(self.embedder).to(device)
        if self._rmvpe_model is not None:
            rep._rmvpe_model = copy.deepcopy(self._rmvpe_model).to(device)
        return rep

    def _replica_index(self, index_vectors):
        """The index on this replica's device, copied once per index."""
        if index_vectors is None or index_vectors.device == self.device:
            return index_vectors
        if self._index_copy is None or self._index_copy[0] is not index_vectors:
            self._index_copy = (index_vectors, index_vectors.to(self.device))
        return self._index_copy[1]

    def _sharded(self, n_rows: int, generator, dispatch) -> Tuple[List, List[int]]:
        """Call ``dispatch(replica, rows, draws)`` for each replica's rows of
        a batch of ``n_rows`` (padded with row 0), each with a copy of
        ``generator`` at its current state that draws that replica's rows of
        the whole batch's draws; ``generator`` then stands where the
        unsharded batch leaves it. Returns the replicas' device results, in
        order, and the p_lens of the real rows."""
        n = len(self._replicas)
        per = -(-n_rows // n)
        order = list(range(n_rows)) + [0] * (per * n - n_rows)
        gen = generator if generator is not None else self._generator(0)
        outs, p_lens = [], []
        for r, rep in enumerate(self._replicas):
            rows = order[r * per:(r + 1) * per]
            own = torch.Generator(gen.device)
            own.set_state(gen.get_state())
            with (torch.cuda.device(rep.device) if rep.device.type == "cuda"
                  else contextlib.nullcontext()):
                out, pl = dispatch(rep, rows, RowDraws(own, rows, n_rows))
            outs.append(out)
            p_lens += pl
        gen.set_state(own.get_state())
        return outs, p_lens[:n_rows]

    # -- device graph ---------------------------------------------------------

    @torch.no_grad()
    def _convert_core(self, audio16k, pitch, pitchf, p_len: torch.Tensor,
                      sid, index_vectors, index_rate: float, protect: float,
                      generator=None) -> torch.Tensor:
        """audio16k [B, T] float (cast to the serving dtype here), pitch
        [B, P] int and pitchf [B, P], or both None for a model without
        pitch -> audio [B, T_out] (int16 in bf16 serving)."""
        use_pitch = pitch is not None
        with span("rvc.hubert"):
            feats = self.embedder(audio16k.to(self.dtype)).float()
        feats0 = feats
        if index_vectors is not None:
            b, tt, dd = feats.shape
            with span("rvc.retrieval"):
                feats = retrieve_blend(feats.reshape(b * tt, dd).contiguous(),
                                       index_vectors, index_rate).reshape(b, tt, dd)
        feats = torch.repeat_interleave(feats, 2, dim=1)
        feats0 = torch.repeat_interleave(feats0, 2, dim=1)
        t = min(feats.shape[1], pitch.shape[1]) if use_pitch else feats.shape[1]
        feats, feats0 = feats[:, :t], feats0[:, :t]
        if use_pitch:
            pitch, pitchf = pitch[:, :t], pitchf[:, :t]
            if protect < 0.5:
                pitchff = torch.where(pitchf > 0, torch.ones_like(pitchf),
                                      torch.full_like(pitchf, protect))[..., None]
                feats = feats * pitchff + feats0 * (1.0 - pitchff)
        lengths = torch.clamp(p_len, max=t)
        with span("rvc.synth"):
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
        with span("rvc.mel"):
            if not torch.is_floating_point(audio16k):
                audio16k = audio16k.float() / 32767.0
            mel = rmvpe_mel(audio16k)[:, :f0_frames]
            pad = (-f0_frames) % 32
            if pad:
                mel = torch.nn.functional.pad(mel.transpose(1, 2), (0, pad),
                                              mode="reflect").transpose(1, 2)
        with span("rvc.rmvpe"):
            hidden = self._rmvpe_model(mel.to(self.dtype)).float()
        with span("rvc.f0"):
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
            audio16k, coarse[:, :frames], f0[:, :frames], p_len,
            sid, index_vectors, index_rate, protect, generator)

    # -- host helpers ---------------------------------------------------------

    def _quantize_in(self, arr: np.ndarray) -> np.ndarray:
        if self.precision == "bf16":
            return np.clip(arr * 32767.0, -32768, 32767).astype(np.int16)
        return arr

    @staticmethod
    def _to_host(audio_out, done=(), req=None) -> np.ndarray:
        """A device result (or the replicas' results, rows in order), once
        the ``done`` events have passed, as a float array; its span is
        ``req``'s, by default the current request's."""
        with span("rvc.download", req):
            for event in done:
                event.synchronize()
            if isinstance(audio_out, list):
                audio_out = torch.cat([o.cpu() for o in audio_out])
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

    def _rows(self, segments: List[np.ndarray], pitches=None, pitchfs=None,
              t_pad: Optional[int] = None):
        """Pad segments to ``t_pad``, by default the bucket of the longest,
        as one batch of rows: (float32 audio [B, T_pad], p_lens, pitch
        [B, T_pad/160] int with ones past each row's pitch, pitchf with
        zeros there, or None)."""
        t_pad = t_pad or self._bucket_len(max(len(s) for s in segments))
        frames_pad = t_pad // WINDOW
        audio_in = np.zeros((len(segments), t_pad), np.float32)
        p_lens = [self._p_len(len(s), t_pad) for s in segments]
        for i, s in enumerate(segments):
            audio_in[i, :len(s)] = s
        if pitches is None or pitches[0] is None:
            return audio_in, p_lens, None, None
        pit = np.ones((len(segments), frames_pad), np.int64)
        pif = np.zeros((len(segments), frames_pad), np.float32)
        for i in range(len(segments)):
            n = min(p_lens[i], len(pitches[i]))
            pit[i, :n] = pitches[i][:n]
            pif[i, :n] = pitchfs[i][:n]
        return audio_in, p_lens, pit, pif

    def _index_on_device(self, index_vectors):
        if index_vectors is None:
            return None
        if torch.is_tensor(index_vectors):
            return index_vectors.to(self.device, torch.float32).contiguous()
        return torch.from_numpy(
            np.ascontiguousarray(index_vectors, np.float32)).to(self.device)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
            profiling.count("pinned_allocs")
        return t.to(self.device, non_blocking=True)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _stream(self, dispatched: Iterable[Tuple[torch.Tensor, Callable]],
                depth: int = 2) -> List[Any]:
        """Drain a stream of dispatched device results in order. Each item of
        ``dispatched`` is (device output, finish), produced lazily so that
        the host prepares and enqueues item i+1 (device work and a pinned
        download on the current CUDA stream, no wait) while the device
        computes item i; a drain thread waits for each download and applies
        ``finish`` to the host array. At most ``depth + 2`` results are in
        flight."""
        max_inflight = max(int(depth), 2) + 2

        def drain(out_host, done, finish, req):
            return finish(self._to_host(out_host, done, req))

        futures = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            for i, (out, finish) in enumerate(dispatched):
                with span("rvc.download_enqueue"):
                    out_host, done = self._download(out)
                futures.append(pool.submit(drain, out_host, done, finish,
                                           profiling.current()))
                if i >= max_inflight:
                    futures[i - max_inflight].result()
            return [f.result() for f in futures]

    @staticmethod
    def _download(out) -> Tuple[Any, List]:
        """Enqueue the copy of a device result (or the replicas' results,
        rows in order) into pinned host memory, on each device's current
        stream: (the host tensor, the events that mark the copies done)."""
        outs = out if isinstance(out, list) else [out]
        if outs[0].device.type != "cuda":
            return out, []
        host = torch.empty((sum(o.shape[0] for o in outs), *outs[0].shape[1:]),
                           dtype=outs[0].dtype, pin_memory=True)
        profiling.count("pinned_allocs")
        events, r0 = [], 0
        for o in outs:
            with torch.cuda.device(o.device):
                host[r0:r0 + o.shape[0]].copy_(o, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            events.append(event)
            r0 += o.shape[0]
        return host, events

    def _trim(self, p_lens: List[int]) -> Callable[[np.ndarray], List[np.ndarray]]:
        return lambda out: [out[i, :p * self.upp] for i, p in enumerate(p_lens)]

    # -- fused (f0 on the device) ---------------------------------------------

    def _dispatch_fused_batch(self, audio_segs: List[np.ndarray], sid: int,
                              index_vectors, index_rate, protect, generator,
                              pitch_shift, f0_autotune, f0_autotune_strength,
                              filter_radius, t_pad: Optional[int] = None
                              ) -> Tuple[torch.Tensor, List[int]]:
        """Pack segments into one [B, T_pad] batch and enqueue the fused
        conversion (no wait). Returns the device result (with sharding, the
        replicas' results) and the p_lens."""
        if self._rmvpe is None:
            raise RuntimeError("attach an RMVPE predictor with set_rmvpe first")
        if self._replicas:
            t_pad = self._bucket_len(max(len(s) for s in audio_segs))
            return self._sharded(len(audio_segs), generator, lambda rep, rows, draws:
                                 rep._dispatch_fused_batch(
                                     [audio_segs[i] for i in rows], sid,
                                     rep._replica_index(index_vectors), index_rate,
                                     protect, draws, pitch_shift, f0_autotune,
                                     f0_autotune_strength, filter_radius, t_pad))
        with span("rvc.upload"):
            audio_in, p_lens, _, _ = self._rows(audio_segs, t_pad=t_pad)
            audio = self._upload(self._quantize_in(audio_in))
            p_len = torch.tensor(p_lens, device=self.device)
            sids = torch.full((len(audio_segs),), int(sid), device=self.device)
        with span("rvc.dispatch"):
            out = self._convert_fused(
                audio, p_len, sids, index_vectors, float(index_rate), float(protect),
                float(pitch_shift), float(f0_autotune_strength),
                generator if generator is not None else self._generator(0),
                use_autotune=bool(f0_autotune), filter_radius=int(filter_radius),
                f0_frames=audio_in.shape[1] // WINDOW + 1)
        return out, p_lens

    def voice_conversion_fused(
        self, audio_seg: np.ndarray, sid: int, index_vectors,
        index_rate: float, protect: float, generator=None,
        pitch_shift: float = 0, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, filter_radius: int = 3,
    ) -> np.ndarray:
        """f0 (RMVPE) + quantize + convert for one segment."""
        return self.voice_conversion_fused_many(
            [audio_seg], sid, index_vectors, index_rate, protect, generator,
            pitch_shift, f0_autotune, f0_autotune_strength, filter_radius)[0]

    def voice_conversion_fused_many(
        self, audio_segs: List[np.ndarray], sid: int, index_vectors,
        index_rate: float, protect: float, generator=None,
        pitch_shift: float = 0, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, filter_radius: int = 3,
    ) -> List[np.ndarray]:
        """Convert B whole segments as the rows of one fused batch (one
        upload, one compute, one download); padding to the common bucket is
        the only waste."""
        out, p_lens = self._dispatch_fused_batch(
            audio_segs, sid, self._index_on_device(index_vectors), index_rate,
            protect, generator, pitch_shift, f0_autotune, f0_autotune_strength,
            filter_radius)
        return self._trim(p_lens)(self._to_host(out))

    def voice_conversion_fused_stream(
        self, audio_segs: List[np.ndarray], sid: int, index_vectors,
        index_rate: float, protect: float, seed: int = 0,
        pitch_shift: float = 0, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, filter_radius: int = 3,
        depth: int = 2, prep=None, generators=None,
    ) -> List[np.ndarray]:
        """Serve a stream of requests with dispatch-ahead (``_stream``).
        Request i uses ``generators[i]``, by default a generator seeded with
        ``seed + i``; ``prep`` is applied to each raw segment inside the
        dispatch loop."""
        index_vectors = self._index_on_device(index_vectors)

        def dispatched():
            for i, seg in enumerate(audio_segs):
                if prep is not None:
                    seg = prep(seg)
                gen = (generators[i] if generators is not None
                       else self._generator(seed + i))
                out, p_lens = self._dispatch_fused_batch(
                    [seg], sid, index_vectors, index_rate, protect, gen,
                    pitch_shift, f0_autotune, f0_autotune_strength, filter_radius)
                yield out, (lambda o, p=p_lens: self._trim(p)(o)[0])

        return self._stream(dispatched(), depth)

    def voice_conversion_fused_batch_stream(
        self, audio_segs: List[np.ndarray], sid: int, index_vectors,
        index_rate: float, protect: float, seed: int = 0,
        pitch_shift: float = 0, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, filter_radius: int = 3,
        batch: int = 4, depth: int = 2, prep=None,
    ) -> List[np.ndarray]:
        """Group files into batches of ``batch`` rows, run each group as one
        fused batch, and keep groups in flight as ``_stream`` does. Group g
        uses a generator seeded with ``seed + g``; a partial last group is
        padded to ``batch`` rows with copies of its first row, sliced away
        on return."""
        index_vectors = self._index_on_device(index_vectors)
        groups = [audio_segs[i:i + batch] for i in range(0, len(audio_segs), batch)]

        def dispatched():
            for g, group in enumerate(groups):
                if prep is not None:
                    group = [prep(s) for s in group]
                b_real = len(group)
                group = group + [group[0]] * (batch - b_real)
                out, p_lens = self._dispatch_fused_batch(
                    group, sid, index_vectors, index_rate, protect,
                    self._generator(seed + g), pitch_shift, f0_autotune,
                    f0_autotune_strength, filter_radius)
                yield out, (lambda o, p=p_lens[:b_real]: self._trim(p)(o))

        return [o for outs in self._stream(dispatched(), depth) for o in outs]

    # -- windowed (f0 on the host side) ---------------------------------------

    def get_f0(
        self, audio_pad: np.ndarray, p_len: int, pitch_shift: float,
        f0_method: str = "rmvpe", predictors: Optional[Dict[str, Any]] = None,
        f0_autotune: bool = False, f0_autotune_strength: float = 1.0,
        inp_f0: Optional[np.ndarray] = None, filter_radius: float = 3,
        hop_length: int = 160,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """f0 of the whole padded input (the median of the methods of a
        hybrid), median filter (odd radius >= 3), autotune, shift, the
        external f0 splice at the pad offset, and the 255-bin quantization:
        (coarse int32 [p_len], f0 float32 [p_len]).

        ``predictors`` maps a method to an audio -> f0 callable; without an
        ``rmvpe`` entry the attached RMVPE predictor serves, and ``yin``
        needs none (it runs on the pipeline's device). fcpe gets ``p_len``
        and ``filter_radius`` (a fractional radius is its confidence
        threshold); crepe gets ``hop_length``, and its contour is
        interpolated back to the 10 ms grid when that is not 160."""
        check_f0_method(f0_method)
        predictors = dict(predictors or {})
        if "rmvpe" not in predictors and self._rmvpe is not None:
            predictors["rmvpe"] = self._rmvpe.infer_from_audio
        stack = []
        for m in parse_f0_methods(f0_method):
            if m == "yin" and m not in predictors:
                from ..predictors.dsp_f0 import yin_f0_np

                f0 = yin_f0_np(audio_pad, device=self.device)
            elif m not in predictors:
                raise ValueError(f"f0 method {m!r} unavailable (no predictor loaded)")
            elif m == "fcpe":
                f0 = np.asarray(predictors[m](audio_pad, p_len=p_len,
                                              filter_radius=filter_radius))
            elif m.startswith("crepe"):
                f0 = np.asarray(predictors[m](audio_pad, hop_length=int(hop_length)))
                if int(hop_length) != WINDOW:
                    f0 = interp_f0_to_grid(f0, p_len)
            else:
                f0 = np.asarray(predictors[m](audio_pad))
            stack.append(f0[:p_len] if len(f0) >= p_len
                         else np.pad(f0, (0, p_len - len(f0))))
        f0 = stack[0] if len(stack) == 1 else np.nanmedian(np.stack(stack), axis=0)

        radius = int(filter_radius) if filter_radius is not None else 0
        if radius >= 3:
            f0 = sps.medfilt(f0, radius if radius % 2 == 1 else radius + 1)
        if f0_autotune:
            f0 = autotune_f0(f0, f0_autotune_strength)
        f0 = f0 * (2.0 ** (pitch_shift / 12.0))

        if inp_f0 is not None:
            # rows [time_sec, f0_hz] at 10 ms, spliced over the pad offset
            tf0 = SAMPLE_RATE // WINDOW
            delta_t = int(np.round((inp_f0[:, 0].max() - inp_f0[:, 0].min()) * tf0 + 1))
            replace = np.interp(np.arange(delta_t), inp_f0[:, 0] * 100, inp_f0[:, 1])
            off = self.cfg.x_pad * tf0
            n = min(len(replace), len(f0) - off)
            f0[off:off + n] = replace[:n]
        return coarse_f0(f0), f0.astype(np.float32)

    def _dispatch_core(self, segments, pitches, pitchfs, sids, index_vectors,
                       index_rate, protect, generator, t_pad: Optional[int] = None):
        """Pack segments (and their pitch, or None for a model without
        pitch) into rows and enqueue ``_convert_core`` (float32 audio
        upload, no wait). Returns the device result (with sharding, the
        replicas' results) and the p_lens."""
        if self._replicas:
            t_pad = self._bucket_len(max(len(s) for s in segments))
            return self._sharded(len(segments), generator, lambda rep, rows, draws:
                                 rep._dispatch_core(
                                     [segments[i] for i in rows],
                                     [pitches[i] for i in rows],
                                     [pitchfs[i] for i in rows],
                                     [sids[i] for i in rows],
                                     rep._replica_index(index_vectors), index_rate,
                                     protect, draws, t_pad))
        with span("rvc.upload"):
            audio_in, p_lens, pit, pif = self._rows(segments, pitches, pitchfs, t_pad)
            if pit is not None:
                pit, pif = self._upload(pit), self._upload(pif)
            audio = self._upload(audio_in)
            p_len = torch.tensor(p_lens, device=self.device)
            sid = torch.tensor(list(sids), device=self.device)
        with span("rvc.dispatch"):
            out = self._convert_core(
                audio, pit, pif, p_len, sid, index_vectors, float(index_rate),
                float(protect), generator if generator is not None else self._generator(0))
        return out, p_lens

    def voice_conversion(
        self, audio_seg: np.ndarray, pitch: Optional[np.ndarray],
        pitchf: Optional[np.ndarray], sid: int, index_vectors,
        index_rate: float, protect: float, generator=None,
    ) -> np.ndarray:
        """Convert one 16 kHz segment with its pitch (None without pitch
        guidance) -> tgt_sr audio."""
        return self.convert_segments_batch(
            [audio_seg], [pitch], [pitchf], [sid], index_vectors, index_rate,
            protect, generator)[0]

    def convert_segments_batch(
        self, segments: List[np.ndarray], pitches: List[Optional[np.ndarray]],
        pitchfs: List[Optional[np.ndarray]], sids: List[int], index_vectors,
        index_rate: float, protect: float, generator=None,
    ) -> List[np.ndarray]:
        """Convert several 16 kHz segments as the rows of one device batch:
        all pad to a common bucket, each row's true length masks through the
        model."""
        out, p_lens = self._dispatch_core(
            segments, pitches, pitchfs, sids, self._index_on_device(index_vectors),
            index_rate, protect, generator)
        return self._trim(p_lens)(self._to_host(out))

    def voice_conversion_stream(
        self, segments: List[np.ndarray], pitches: List[Optional[np.ndarray]],
        pitchfs: List[Optional[np.ndarray]], sid: int, index_vectors,
        index_rate: float, protect: float, generators=None, depth: int = 2,
    ) -> List[np.ndarray]:
        """The windows of a long input with dispatch-ahead (``_stream``);
        each output equals ``voice_conversion`` of its window with the same
        generator (``generators[i]``, by default one seeded with 0)."""
        index_vectors = self._index_on_device(index_vectors)

        def dispatched():
            for i, (seg, pitch, pitchf) in enumerate(zip(segments, pitches, pitchfs)):
                gen = generators[i] if generators is not None else None
                out, p_lens = self._dispatch_core(
                    [seg], [pitch], [pitchf], [sid], index_vectors, index_rate,
                    protect, gen)
                yield out, (lambda o, p=p_lens: self._trim(p)(o)[0])

        return self._stream(dispatched(), depth)

    # -- host entry points ----------------------------------------------------

    def _finish(self, audio_opt: np.ndarray, source: np.ndarray,
                volume_envelope: float) -> np.ndarray:
        """RMS envelope toward the (high-passed) source, peak at 0.99."""
        if volume_envelope != 1.0:
            audio_opt = change_rms(source, SAMPLE_RATE, audio_opt, self.tgt_sr,
                                   volume_envelope)
        peak = np.abs(audio_opt).max() / 0.99 if audio_opt.size else 0.0
        if peak > 1.0:
            audio_opt = audio_opt / peak
        return audio_opt.astype(np.float32)

    def _attach_rmvpe(self, predictors) -> None:
        """Attach the RMVPE behind ``predictors["rmvpe"]`` (a bound
        ``infer_from_audio``) when none is attached."""
        fn = (predictors or {}).get("rmvpe")
        if self._rmvpe is None and hasattr(fn, "__self__"):
            self.set_rmvpe(fn.__self__)

    def pipeline(
        self, audio: np.ndarray, sid: int = 0, pitch_shift: float = 0,
        f0_method: str = "rmvpe", index_vectors=None, index_rate: float = 0.0,
        pitch_guidance: bool = True, volume_envelope: float = 1.0,
        protect: float = 0.5, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, inp_f0: Optional[np.ndarray] = None,
        predictors: Optional[Dict[str, Any]] = None, generator=None,
        filter_radius: float = 3, hop_length: int = 160,
    ) -> np.ndarray:
        """Full conversion of a 16 kHz waveform -> tgt_sr waveform. An input
        up to ``t_max`` with RMVPE pitch and no external f0 takes the fused
        path; the rest (and every other f0 method) take the windowed
        path. One request of the recorder (``utils/profiling.py``); the
        windowed path counts its ``windows``."""
        if pitch_guidance:
            check_f0_method(f0_method)
        with profiling.request(audio.shape[0]) as req:
            with span("rvc.prep"):
                index_arr = (self._index_on_device(index_vectors)
                             if index_vectors is not None and index_rate > 0 else None)
                audio = self._highpass(audio)
                with span("rvc.cut_points"):
                    opt_ts = self._find_cut_points(audio)
                audio_pad = np.pad(audio, (self.t_pad, self.t_pad), mode="reflect")
            p_len = audio_pad.shape[0] // WINDOW

            fused = (pitch_guidance and not opt_ts and inp_f0 is None
                     and f0_method == "rmvpe")
            if fused:
                self._attach_rmvpe(predictors)
            if fused and self._rmvpe is not None:
                req.bucket = self._bucket_len(audio_pad.shape[0])
                seg_out = self.voice_conversion_fused(
                    audio_pad, sid, index_arr, index_rate, protect, generator,
                    pitch_shift=pitch_shift, f0_autotune=f0_autotune,
                    f0_autotune_strength=f0_autotune_strength,
                    filter_radius=int(filter_radius or 0))
                with span("rvc.finish"):
                    return self._finish(seg_out[self.t_pad_tgt:-self.t_pad_tgt], audio,
                                        volume_envelope)

            pitch = pitchf = None
            if pitch_guidance:
                with span("rvc.host_f0"):
                    pitch, pitchf = self.get_f0(
                        audio_pad, p_len, pitch_shift, f0_method, predictors,
                        f0_autotune, f0_autotune_strength, inp_f0, filter_radius,
                        hop_length)
            # the windows and their slices of the global pitch
            segments, seg_pitches, seg_pitchfs = [], [], []
            s, t = 0, None
            for t_raw in opt_ts:
                t = t_raw // WINDOW * WINDOW
                segments.append(audio_pad[s:t + self.t_pad2 + WINDOW])
                pslice = slice(s // WINDOW, (t + self.t_pad2) // WINDOW)
                seg_pitches.append(pitch[pslice] if pitch is not None else None)
                seg_pitchfs.append(pitchf[pslice] if pitchf is not None else None)
                s = t
            tail = slice(t // WINDOW, None) if t is not None else slice(None)
            segments.append(audio_pad[t:] if t is not None else audio_pad)
            seg_pitches.append(pitch[tail] if pitch is not None else None)
            seg_pitchfs.append(pitchf[tail] if pitchf is not None else None)
            profiling.count("windows", len(segments))

            req.bucket = max(self._bucket_len(len(seg)) for seg in segments)
            gen = generator if generator is not None else self._generator(0)
            seg_outs = self.voice_conversion_stream(
                segments, seg_pitches, seg_pitchfs, sid, index_arr, index_rate,
                protect, [gen] * len(segments))
            with span("rvc.finish"):
                audio_opt = np.concatenate(
                    [o[self.t_pad_tgt:-self.t_pad_tgt] for o in seg_outs])
                return self._finish(audio_opt, audio, volume_envelope)

    def pipeline_many(
        self, audios: List[np.ndarray], sid: int = 0, pitch_shift: float = 0,
        f0_method: str = "rmvpe", index_vectors=None, index_rate: float = 0.0,
        pitch_guidance: bool = True, volume_envelope: float = 1.0,
        protect: float = 0.5, f0_autotune: bool = False,
        f0_autotune_strength: float = 1.0, inp_f0: Optional[np.ndarray] = None,
        predictors: Optional[Dict[str, Any]] = None, generator=None,
        filter_radius: float = 3, hop_length: int = 160,
    ) -> List[np.ndarray]:
        """Convert independent clips, sample-identical to ``[self.pipeline(a,
        ...) for a in audios]``; when every clip takes the fused path they
        ride ``voice_conversion_fused_stream`` (the host high-passes and
        pads clip i+1 while the device converts clip i)."""
        kwargs = dict(
            sid=sid, pitch_shift=pitch_shift, f0_method=f0_method,
            index_vectors=index_vectors, index_rate=index_rate,
            pitch_guidance=pitch_guidance, volume_envelope=volume_envelope,
            protect=protect, f0_autotune=f0_autotune,
            f0_autotune_strength=f0_autotune_strength, inp_f0=inp_f0,
            predictors=predictors, generator=generator,
            filter_radius=filter_radius, hop_length=hop_length)
        fast = (pitch_guidance and inp_f0 is None and f0_method == "rmvpe"
                and all(a.shape[0] <= self.t_max for a in audios))
        if fast:
            self._attach_rmvpe(predictors)
        if not (fast and self._rmvpe is not None):
            return [self.pipeline(a, **kwargs) for a in audios]

        hp: List[np.ndarray] = []  # prep runs in dispatch order
        reqs: List[profiling.Request] = []  # a request a clip, from its prep on

        def prep(seg):
            req = profiling.request(seg.shape[0]).start()
            reqs.append(req)
            with span("rvc.prep"):
                h = self._highpass(seg)
                hp.append(h)
                padded = np.pad(h, (self.t_pad, self.t_pad), mode="reflect")
            req.bucket = self._bucket_len(padded.shape[0])
            return padded

        # serial pipeline() calls each start a generator seeded with 0, or
        # draw from the caller's one generator in turn: the stream does both
        gens = ([generator] * len(audios) if generator is not None
                else [self._generator(0) for _ in audios])
        try:
            raw = self.voice_conversion_fused_stream(
                audios, sid, index_vectors if index_rate > 0 else None, index_rate,
                protect, pitch_shift=pitch_shift, f0_autotune=f0_autotune,
                f0_autotune_strength=f0_autotune_strength,
                filter_radius=int(filter_radius or 0), prep=prep, generators=gens)
            outs = []
            for o, h, req in zip(raw, hp, reqs):
                with span("rvc.finish", req):
                    outs.append(self._finish(o[self.t_pad_tgt:-self.t_pad_tgt], h,
                                             volume_envelope))
                req.end()
            return outs
        finally:
            for req in reqs:    # those a failure left open
                req.end(failed=True)
