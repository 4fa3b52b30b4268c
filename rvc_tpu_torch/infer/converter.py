"""VoiceConverter: the user-facing conversion orchestrator (port of
``rvc_tpu/infer/converter.py``).

Loads a voice model (the reference ``.pth`` or the JAX package's ``.npz``),
its content embedder and the RMVPE predictor onto one device (the card
unless ``device="cpu"``), keeps the retrieval index resident there, and
converts one file (``convert_audio``) or a folder (``convert_audio_batch``:
short files packed as the rows of device batches, long ones through the
windowed path). Formant shifting runs on the 16 kHz input, the spectral
gate (``clean_audio``) and the post-FX chain on the output, all three on
the converter's device (``infer/formant.py``, ``infer/postprocess.py``):
the audio crosses to the device once and back once for each. Output is
WAV, then FLAC through the repo's codec or MP3 / OGG / M4A through
``ffmpeg`` when it is on ``PATH`` (``_export``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .. import convert
from ..device import resolve_device
from ..embedders.hubert import HubertConfig, load_embedder_by_name
from ..ops.retrieval import FeatureIndex
from ..predictors.f0_extractor import (DEFAULT_CKPTS, build_predictors,
                                       check_f0_method, parse_f0_methods)
from ..utils.audio_io import load_audio, read_audio, save_audio
from ..utils.checkpoints import build_synthesizer, load_checkpoint, load_rvc_pth
from ..utils.split_audio import merge_audio, process_audio
from .formant import formant_shift
from .pipeline import Pipeline, PipelineConfig
from .postprocess import apply_post_process, spectral_gate

AUDIO_EXTS = (".wav", ".mp3", ".flac", ".ogg", ".m4a")


class VoiceConverter:
    PREDICTOR_CKPTS = dict(DEFAULT_CKPTS)

    def __init__(self, precision: str = "bf16",
                 device: Union[str, torch.device] = "cuda"):
        """precision: "bf16" (the serving default) or "fp32"."""
        self.precision = precision
        self.device = resolve_device(device)
        self.pipeline: Optional[Pipeline] = None
        self.loaded_model: Optional[str] = None
        self.last_embedder = None
        self.embedder = None
        self.tgt_sr: Optional[int] = None
        self.use_f0 = True
        self._predictors: Dict[str, Any] = {}
        self._index_cache: Dict[str, torch.Tensor] = {}

    def get_predictors(self, f0_method: str) -> Dict[str, Any]:
        """The (cached) f0 predictors a method needs, from the staged
        checkpoints under models/predictors/ (random weights otherwise);
        ``yin`` needs none."""
        check_f0_method(f0_method)
        missing = [m for m in dict.fromkeys(parse_f0_methods(f0_method))
                   if m not in self._predictors and m != "yin"]
        if missing:
            self._predictors.update(build_predictors(
                missing, rmvpe_ckpt=self.PREDICTOR_CKPTS.get("rmvpe"),
                fcpe_ckpt=self.PREDICTOR_CKPTS.get("fcpe"),
                crepe_ckpt=self.PREDICTOR_CKPTS.get("crepe"), device=self.device))
        return self._predictors

    # -- model management ----------------------------------------------------

    def load_embedder_model(self, embedder_model: str = "contentvec",
                            embedder_model_custom: Optional[str] = None,
                            final_proj_dim: Optional[int] = None) -> None:
        # key by the custom path only when it resolves, so that a missing
        # file does not pin the fallback once the user creates it
        custom_ok = bool(embedder_model_custom
                         and os.path.exists(embedder_model_custom))
        key = ((embedder_model_custom if custom_ok else embedder_model),
               final_proj_dim)
        if key == self.last_embedder and self.embedder is not None:
            return
        self.embedder = load_embedder_by_name(
            embedder_model, embedder_model_custom,
            cfg=HubertConfig(final_proj_dim=final_proj_dim), device=self.device)
        self.last_embedder = key

    def get_vc(self, model_path: str, embedder_model: str = "contentvec",
               embedder_model_custom: Optional[str] = None) -> None:
        emb_key = embedder_model_custom or embedder_model
        if (self.loaded_model == model_path and self.pipeline is not None
                and self.last_embedder is not None
                and self.last_embedder[0] == emb_key):
            return
        if model_path.endswith(".pth"):
            sd, meta = load_rvc_pth(model_path)
        else:
            tree, meta = load_checkpoint(model_path)
            tree = tree.get("model", tree)
            sd = convert.synthesizer_state_dict(tree)
            meta = {**meta, "speakers_id": int(sd["emb_g.weight"].shape[0])}
        model, cfg, self.use_f0 = build_synthesizer(sd, meta, device=self.device)
        self.tgt_sr = cfg.data.sample_rate
        # v1 models take 256-wide features: HuBERT's final_proj
        feat_dim = cfg.model.text_enc_hidden_dim
        self.load_embedder_model(embedder_model, embedder_model_custom,
                                 final_proj_dim=feat_dim if feat_dim != 768 else None)
        self.pipeline = Pipeline(
            self.tgt_sr, model, self.embedder, PipelineConfig.from_device(self.device),
            upsample_factor=cfg.upsample_factor, precision=self.precision,
            device=self.device)
        self.loaded_model = model_path

    @staticmethod
    def resolve_index_path(index_path: str) -> str:
        """Accept a model's log directory as well as an index file: the one
        *index* file inside, or '' when there is none."""
        if not index_path or not os.path.isdir(index_path):
            return index_path
        hits = sorted(f for f in os.listdir(index_path)
                      if "index" in f.lower() and not f.startswith(".")
                      and os.path.isfile(os.path.join(index_path, f)))
        return os.path.join(index_path, hits[0]) if hits else ""

    def _load_index(self, index_path: str) -> torch.Tensor:
        """Load the retrieval index once and keep it on the device."""
        cached = self._index_cache.get(index_path)
        if cached is None:
            cached = FeatureIndex.load(index_path, device=self.device).vectors
            self._index_cache = {index_path: cached}
        return cached

    def _index(self, index_path: str, index_rate: float):
        index_path = self.resolve_index_path(index_path)
        if index_path and os.path.exists(index_path) and index_rate > 0:
            return self._load_index(index_path)
        return None

    # -- conversion ----------------------------------------------------------

    def convert_audio(
        self, audio_input_path: str, audio_output_path: str, model_path: str,
        index_path: str = "", pitch: int = 0, f0_method: str = "rmvpe",
        filter_radius: float = 3, hop_length: int = 160,
        index_rate: float = 0.0, volume_envelope: float = 1.0,
        protect: float = 0.5, split_audio: bool = False,
        f0_autotune: bool = False, f0_autotune_strength: float = 1.0,
        clean_audio: bool = False, clean_strength: float = 0.7,
        export_format: str = "WAV", f0_file: Optional[str] = None,
        sid: int = 0, embedder_model: str = "contentvec",
        embedder_model_custom: Optional[str] = None,
        formant_shifting: bool = False, formant_qfrency: float = 1.0,
        formant_timbre: float = 1.0, post_process: bool = False, **post_fx,
    ) -> str:
        """Convert one file, write it as WAV at the model's rate and export
        it to ``export_format``; returns the written file. ``hop_length``
        only concerns the crepe methods; ``post_fx`` holds the post-FX
        chain's flags and knobs (``reverb=True``, ``reverb_room_size=...``)."""
        start = time.time()
        # decode the input first: a bad file fails before the model loads
        audio16 = load_audio(audio_input_path, 16000)
        if audio16.size == 0:
            raise ValueError(f"empty audio file: {audio_input_path}")
        self.get_vc(model_path, embedder_model, embedder_model_custom)

        peak = np.abs(audio16).max() / 0.95
        if peak > 1.0:
            audio16 = audio16 / peak
        if formant_shifting:
            audio16 = self._formant(audio16, formant_qfrency, formant_timbre)
        inp_f0 = None
        if f0_file and os.path.exists(f0_file):
            with open(f0_file) as f:
                rows = [ln.split(",") for ln in f.read().strip().split("\n")]
            inp_f0 = np.asarray([[float(v) for v in r] for r in rows], np.float32)

        kwargs: Dict[str, Any] = dict(
            sid=sid, pitch_shift=pitch, f0_method=f0_method,
            index_vectors=self._index(index_path, index_rate),
            index_rate=index_rate, pitch_guidance=self.use_f0,
            volume_envelope=volume_envelope, protect=protect,
            f0_autotune=f0_autotune, f0_autotune_strength=f0_autotune_strength,
            inp_f0=inp_f0,
            predictors=self.get_predictors(f0_method) if self.use_f0 else None,
            filter_radius=filter_radius, hop_length=int(hop_length))
        if split_audio:
            segments, intervals = process_audio(audio16, 16000)
            converted = self.pipeline.pipeline_many(segments, **kwargs)
            audio_out = merge_audio(segments, converted, intervals, 16000, self.tgt_sr)
        else:
            audio_out = self.pipeline.pipeline(audio16, **kwargs)

        audio_out = self._output_effects(audio_out, clean_audio, clean_strength,
                                         post_process, post_fx)
        save_audio(audio_output_path, audio_out, self.tgt_sr)
        out_path = self._export(audio_output_path, export_format)
        print(f"converted {audio_input_path} in {time.time() - start:.2f}s -> {out_path}")
        return out_path

    def convert_audio_batch(self, audio_input_paths: str, audio_output_path: str,
                            batch_pack: bool = True, device_batch: int = 8,
                            **kwargs) -> None:
        """Convert every audio file of a folder into ``<name>_output.wav``
        (files already converted are skipped). Short files are packed, up to
        ``device_batch`` at a time, as the rows of one
        ``convert_segments_batch``; files longer than ``t_max`` once padded
        take ``convert_audio``'s windowed path. ``split_audio`` and
        ``f0_file`` convert every file through ``convert_audio``. With
        several cards and a converter on ``"cuda"`` (no index), each batch's
        rows are split over every card (``Pipeline.enable_batch_sharding``),
        ``device_batch`` at least the card count."""
        files = [os.path.join(audio_input_paths, f)
                 for f in sorted(os.listdir(audio_input_paths))
                 if f.lower().endswith(AUDIO_EXTS)]
        os.makedirs(audio_output_path, exist_ok=True)

        def out_path(f):
            base = os.path.splitext(os.path.basename(f))[0]
            return os.path.join(audio_output_path, f"{base}_output.wav")

        todo = [f for f in files if not os.path.exists(out_path(f))]
        serial_only = bool(kwargs.get("split_audio")) or bool(kwargs.get("f0_file"))
        if not batch_pack or serial_only:
            for f in todo:
                self.convert_audio(f, out_path(f), **kwargs)
            return

        self.get_vc(kwargs["model_path"], kwargs.get("embedder_model", "contentvec"),
                    kwargs.get("embedder_model_custom"))
        pipe = self.pipeline
        short, long_files = [], []
        for f in todo:
            try:
                audio = load_audio(f, 16000)
                if audio.size == 0:
                    raise ValueError("empty audio file")
            except (ValueError, OSError) as e:
                print(f"skipping {f}: {e}")  # one bad file does not stop the rest
                continue
            peak = np.abs(audio).max() / 0.95
            if peak > 1.0:
                audio = audio / peak
            if kwargs.get("formant_shifting"):
                audio = self._formant(audio, kwargs.get("formant_qfrency", 1.0),
                                      kwargs.get("formant_timbre", 1.0))
            fits = len(audio) + 2 * pipe.t_pad <= pipe.t_max
            (short if fits else long_files).append((f, audio))

        # several cards and no card asked for: each device batch's rows split
        # over all of them, and at least one row a card
        if self.device.index is None:
            if not pipe._replicas:
                pipe.enable_batch_sharding()
            device_batch = max(device_batch, len(pipe._replicas or ()))
        index_rate = kwargs.get("index_rate", 0.0)
        index_vectors = self._index(kwargs.get("index_path", ""), index_rate)
        f0_method = kwargs.get("f0_method", "rmvpe")
        sid = kwargs.get("sid", 0)
        volume_envelope = kwargs.get("volume_envelope", 1.0)
        generator = pipe._generator(0)
        for i in range(0, len(short), device_batch):
            group = short[i:i + device_batch]
            segs, pitches, pitchfs, sources = [], [], [], []
            for f, audio in group:
                audio_hp = pipe._highpass(audio)
                audio_pad = np.pad(audio_hp, (pipe.t_pad, pipe.t_pad), mode="reflect")
                pc = pf = None
                if self.use_f0:
                    pc, pf = pipe.get_f0(
                        audio_pad, audio_pad.shape[0] // 160, kwargs.get("pitch", 0),
                        f0_method, self.get_predictors(f0_method),
                        f0_autotune=bool(kwargs.get("f0_autotune", False)),
                        f0_autotune_strength=kwargs.get("f0_autotune_strength", 1.0),
                        filter_radius=kwargs.get("filter_radius", 3),
                        hop_length=int(kwargs.get("hop_length", 160)))
                segs.append(audio_pad)
                pitches.append(pc)
                pitchfs.append(pf)
                sources.append(audio_hp)  # change_rms follows the high-passed input
            outs = pipe.convert_segments_batch(
                segs, pitches, pitchfs, [sid] * len(segs), index_vectors,
                index_rate, kwargs.get("protect", 0.5), generator)
            for (f, _), source, seg_out in zip(group, sources, outs):
                trimmed = pipe._finish(seg_out[pipe.t_pad_tgt:-pipe.t_pad_tgt],
                                       source, volume_envelope)
                trimmed = self._output_effects(
                    trimmed, kwargs.get("clean_audio", False),
                    kwargs.get("clean_strength", 0.7),
                    kwargs.get("post_process", False), kwargs)
                save_audio(out_path(f), trimmed, self.tgt_sr)
                final = self._export(out_path(f), kwargs.get("export_format", "WAV"))
                print(f"batch-converted {f} -> {final}")

        for f, _ in long_files:
            self.convert_audio(f, out_path(f), **kwargs)

    def _formant(self, audio16: np.ndarray, quefrency: float,
                 timbre: float) -> np.ndarray:
        """The 16 kHz input's formants shifted on the device."""
        x = torch.from_numpy(np.ascontiguousarray(audio16, np.float32)).to(self.device)
        return formant_shift(x, 16000, quefrency, timbre).cpu().numpy()

    def _output_effects(self, audio: np.ndarray, clean_audio: bool,
                        clean_strength: float, post_process: bool,
                        post_fx: Dict[str, Any]) -> np.ndarray:
        """The spectral gate, then the post-FX chain, on the device: the
        output goes there once and comes back once."""
        if not (clean_audio or post_process):
            return audio
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        if clean_audio:
            x = spectral_gate(x, self.tgt_sr, clean_strength)
        if post_process:
            x = apply_post_process(x, self.tgt_sr, **post_fx)
        return x.cpu().numpy()

    @staticmethod
    def _export(path: str, export_format: str) -> str:
        """The written WAV in ``export_format``: FLAC through the repo's
        codec (``native/flac_codec.cpp``); the other formats through
        ``ffmpeg`` when it is on ``PATH``, else the WAV stays."""
        fmt = export_format.upper()
        if fmt == "WAV":
            return path
        if fmt == "FLAC":
            from ..utils.native import flac_write

            out = os.path.splitext(path)[0] + ".flac"
            data, sr = read_audio(path)
            if flac_write(out, data, sr):
                return out
        if shutil.which("ffmpeg") is None:
            print(f"ffmpeg unavailable; keeping WAV for requested {export_format}")
            return path
        out = os.path.splitext(path)[0] + "." + export_format.lower()
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", path, out],
                       check=True)
        return out
