"""Feature extraction: f0 contours, content embeddings, the filelist (port
of ``rvc_tpu/train/extract.py``).

Over ``sliced_audios_16k/``: each file's f0 goes to ``f0_voiced/<name>.wav.npy``
(float64 Hz) and, quantized to 256 mel bins, to ``f0/<name>.wav.npy``; its
HuBERT last hidden state to ``extracted/<name>.npy``, NaN-guarded. Then
``config.json`` (the JAX package's text) and ``filelist.txt`` with
``include_mutes`` silent rows per speaker, synthesized from a zero waveform.

On the device: RMVPE runs ``batch_size`` files per call; fcpe, crepe and
yin run file by file; the embedder runs ``batch_size`` files per call.
Files are grouped and padded exactly as the JAX package groups and pads
them (names sorted, decoded in chunks of 8 x batch_size, each slice of
batch_size padded with zeros to a whole second): the embedder's first conv
layer normalizes over time, so the padding is part of what it sees.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..utils.audio_io import load_audio

SR16K = 16000
HOP = 160
F0_BIN = 256
F0_MIN, F0_MAX = 50.0, 1100.0


def coarse_f0_train(f0: np.ndarray) -> np.ndarray:
    """256-bin mel-scale quantization of training f0 (the inference path
    quantizes to 255 bins)."""
    mel_min = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
    mel_max = 1127.0 * np.log(1.0 + F0_MAX / 700.0)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    quant = (f0_mel - mel_min) * (F0_BIN - 2) / (mel_max - mel_min) + 1
    return np.rint(np.clip(quant, 1, F0_BIN - 1)).astype(np.int64)


def _bucket(n: int, step: int = SR16K) -> int:
    return max(step, ((n + step - 1) // step) * step)


class FeatureExtractor:
    """f0 and embeddings of 16 kHz waveforms, batched on ``device``."""

    def __init__(self, f0_method: str = "rmvpe", rmvpe_ckpt: Optional[str] = None,
                 embedder_ckpt: Optional[str] = None, batch_size: int = 8,
                 embedder_model: str = "contentvec", hop_length: int = HOP,
                 device: Union[str, torch.device] = "cuda"):
        from ..embedders.hubert import load_embedder, resolve_embedder_path
        from ..predictors.f0_extractor import DEFAULT_CKPTS, build_predictors

        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.f0_method = f0_method
        self.hop_length = int(hop_length)
        self._rmvpe = None
        self._predict_f0 = None
        if f0_method == "rmvpe":
            from ..predictors.rmvpe import RMVPE

            rmvpe_ckpt = rmvpe_ckpt or DEFAULT_CKPTS["rmvpe"]
            if os.path.exists(rmvpe_ckpt):
                self._rmvpe = RMVPE.from_torch_checkpoint(rmvpe_ckpt, self.device)
            else:
                print(f"WARNING: no RMVPE checkpoint found (expected {rmvpe_ckpt}); "
                      "using RANDOM weights - extracted f0 will be garbage. "
                      "Pass --rmvpe_ckpt.")
                self._rmvpe = RMVPE(device=self.device)
        elif f0_method in ("fcpe", "crepe", "crepe-tiny"):
            self._predict_f0 = build_predictors((f0_method,), device=self.device)[f0_method]
        elif f0_method not in ("yin", "pm"):
            raise ValueError(f"unsupported f0 method {f0_method!r}")
        if embedder_ckpt is None:
            embedder_ckpt = resolve_embedder_path(embedder_model)
            if embedder_ckpt is None:
                print(f"embedder {embedder_model!r} checkpoint not found under "
                      "models/embedders/; using random-initialized weights")
        self.embedder = load_embedder(embedder_ckpt, device=self.device)

    def compute_f0(self, audio: np.ndarray) -> np.ndarray:
        return self.compute_f0_batch([audio])[0]

    def compute_f0_batch(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """f0 of each waveform on the 10 ms grid (len // 160 + 1 frames),
        float64."""
        if self._rmvpe is not None:
            outs: List[np.ndarray] = []
            for i in range(0, len(wavs), self.batch_size):
                outs.extend(self._rmvpe.infer_batch(wavs[i:i + self.batch_size]))
        elif self._predict_f0 is not None:
            if self.f0_method.startswith("crepe") and self.hop_length != HOP:
                # crepe at the asked hop, interpolated back to the 10 ms grid
                from ..predictors.f0_extractor import interp_f0_to_grid

                outs = [interp_f0_to_grid(np.asarray(self._predict_f0(
                    w, hop_length=self.hop_length)), len(w) // HOP + 1)
                    for w in wavs]
            else:
                outs = [np.asarray(self._predict_f0(w)) for w in wavs]
        else:
            from ..predictors.dsp_f0 import yin_f0_np

            outs = [yin_f0_np(w, device=self.device) for w in wavs]
        result = []
        for w, f0 in zip(wavs, outs):
            n_frames = len(w) // HOP + 1
            if len(f0) < n_frames:
                f0 = np.pad(f0, (0, n_frames - len(f0)))
            result.append(f0[:n_frames].astype(np.float64))
        return result

    def compute_embeddings_batch(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """``batch_size`` waveforms at a time, zero-padded to a common whole
        second, through the embedder; each file's (len - 400) // 320 + 1
        frames, float32, NaN-guarded."""
        out: List[np.ndarray] = []
        for i in range(0, len(wavs), self.batch_size):
            chunk = wavs[i:i + self.batch_size]
            batch = np.zeros((len(chunk), _bucket(max(len(w) for w in chunk))),
                             np.float32)
            for j, w in enumerate(chunk):
                batch[j, :len(w)] = w
            feats = self.embedder(torch.from_numpy(batch).to(self.device))
            feats = feats.float().cpu().numpy()
            for j, w in enumerate(chunk):
                e = feats[j, :max(1, (len(w) - 400) // 320 + 1)]
                if not np.isfinite(e).all():
                    e = np.nan_to_num(e)
                out.append(e.astype(np.float32))
        return out


def run_extraction(
    exp_dir: str,
    f0_method: str = "rmvpe",
    rmvpe_ckpt: Optional[str] = None,
    embedder_ckpt: Optional[str] = None,
    include_mutes: int = 2,
    sample_rate: int = 48000,
    batch_size: int = 8,
    embedder_model: str = "contentvec",
    hop_length: int = HOP,
    cpu_cores: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> None:
    """Extract f0 and embeddings of every file of ``sliced_audios_16k/``,
    then write ``config.json`` and ``filelist.txt``. Files stream in
    chunks of 8 x ``batch_size`` (host memory stays bounded);
    ``cpu_cores`` > 1 decodes a chunk's files in that many threads."""
    wav16_dir = os.path.join(exp_dir, "sliced_audios_16k")
    f0_dir = os.path.join(exp_dir, "f0")
    f0v_dir = os.path.join(exp_dir, "f0_voiced")
    emb_dir = os.path.join(exp_dir, "extracted")
    for d in (f0_dir, f0v_dir, emb_dir):
        os.makedirs(d, exist_ok=True)

    names = sorted(fn[:-4] for fn in os.listdir(wav16_dir) if fn.endswith(".wav"))
    fx = FeatureExtractor(f0_method, rmvpe_ckpt, embedder_ckpt, batch_size,
                          embedder_model=embedder_model, hop_length=hop_length,
                          device=device)
    chunk_files = max(1, batch_size) * 8
    pool = ThreadPoolExecutor(cpu_cores) if cpu_cores and cpu_cores > 1 else None
    try:
        for c0 in range(0, len(names), chunk_files):
            chunk = names[c0:c0 + chunk_files]
            paths = [os.path.join(wav16_dir, f"{n}.wav") for n in chunk]
            if pool is not None:
                wavs = list(pool.map(lambda p: load_audio(p, SR16K), paths))
            else:
                wavs = [load_audio(p, SR16K) for p in paths]
            for n, f0 in zip(chunk, fx.compute_f0_batch(wavs)):
                np.save(os.path.join(f0v_dir, f"{n}.wav.npy"), f0, allow_pickle=False)
                np.save(os.path.join(f0_dir, f"{n}.wav.npy"), coarse_f0_train(f0),
                        allow_pickle=False)
            for n, emb in zip(chunk, fx.compute_embeddings_batch(wavs)):
                np.save(os.path.join(emb_dir, f"{n}.npy"), emb, allow_pickle=False)
    finally:
        if pool is not None:
            pool.shutdown()

    generate_config(exp_dir, sample_rate)
    generate_filelist(exp_dir, include_mutes=include_mutes, extractor=fx)


def generate_config(exp_dir: str, sample_rate: int) -> None:
    """Write the experiment's ``config.json`` unless it exists."""
    from ..configs import get_config

    path = os.path.join(exp_dir, "config.json")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(get_config(sample_rate).to_json())


def _make_mute_rows(exp_dir: str, extractor: FeatureExtractor) -> Dict[str, str]:
    """Write the silent filler example (3 s of zeros at the dataset's rate,
    read from ``config.json``, with its f0 and embeddings)."""
    from ..utils.audio_io import write_wav

    mute_dir = os.path.join(exp_dir, "mute")
    for sub in ("sliced_audios", "f0", "f0_voiced", "extracted"):
        os.makedirs(os.path.join(mute_dir, sub), exist_ok=True)
    dur = 3.0
    wav16 = np.zeros(int(SR16K * dur), np.float32)
    wav_path = os.path.join(mute_dir, "sliced_audios", "mute.wav")
    with open(os.path.join(exp_dir, "config.json")) as f:
        sr = json.load(f)["data"]["sample_rate"]
    write_wav(wav_path, np.zeros(int(sr * dur), np.float32), sr, subtype="FLOAT")

    f0 = np.zeros(len(wav16) // HOP + 1, np.float64)
    f0_path = os.path.join(mute_dir, "f0_voiced", "mute.wav.npy")
    f0c_path = os.path.join(mute_dir, "f0", "mute.wav.npy")
    np.save(f0_path, f0, allow_pickle=False)
    np.save(f0c_path, coarse_f0_train(f0), allow_pickle=False)

    emb_path = os.path.join(mute_dir, "extracted", "mute.npy")
    np.save(emb_path, extractor.compute_embeddings_batch([wav16])[0],
            allow_pickle=False)
    return {"wav": wav_path, "feats": emb_path, "f0c": f0c_path, "f0f": f0_path}


def generate_filelist(exp_dir: str, include_mutes: int = 2,
                      extractor: Optional[FeatureExtractor] = None) -> str:
    """Write ``wav|feats|f0c|f0f|sid`` rows for the names present in all
    four artifact directories, plus ``include_mutes`` silent rows per
    speaker, shuffled with ``default_rng(1234)``; record the speaker count
    in ``model_info.json``."""
    gt_dir = os.path.join(exp_dir, "sliced_audios")
    emb_dir = os.path.join(exp_dir, "extracted")
    f0_dir = os.path.join(exp_dir, "f0")
    f0v_dir = os.path.join(exp_dir, "f0_voiced")

    def stems(d, strip):
        return {f[:-len(strip)] for f in os.listdir(d) if f.endswith(strip)}

    names = (stems(gt_dir, ".wav") & stems(emb_dir, ".npy")
             & stems(f0_dir, ".wav.npy") & stems(f0v_dir, ".wav.npy"))
    rows, sids = [], []
    for n in sorted(names):
        sid = n.split("_")[0]
        if sid not in sids:
            sids.append(sid)
        rows.append(
            f"{os.path.join(gt_dir, n)}.wav|{os.path.join(emb_dir, n)}.npy|"
            f"{os.path.join(f0_dir, n)}.wav.npy|{os.path.join(f0v_dir, n)}.wav.npy|{sid}")

    if include_mutes > 0 and extractor is not None and sids:
        mute = _make_mute_rows(exp_dir, extractor)
        for sid in sids * include_mutes:
            rows.append(f"{mute['wav']}|{mute['feats']}|{mute['f0c']}|{mute['f0f']}|{sid}")

    info_path = os.path.join(exp_dir, "model_info.json")
    info = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
    info["speakers_id"] = len(sids)
    with open(info_path, "w") as f:
        json.dump(info, f, indent=4)

    np.random.default_rng(1234).shuffle(rows)
    out = os.path.join(exp_dir, "filelist.txt")
    with open(out, "w") as f:
        f.write("\n".join(rows) + "\n")
    return out
