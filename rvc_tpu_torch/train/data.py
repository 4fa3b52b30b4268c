"""Training data (port of ``rvc_tpu/train/data.py``): the filelist
dataset and length-bucketed batches, in numpy, as the JAX package makes
them, so one seed gives both packages the same batches.

  - rows ``wav|feats.npy|f0coarse.npy|f0float.npy|sid``; HuBERT features
    repeated x2 to the f0 frame rate and capped at 900 frames; the linear
    spectrogram cached beside the wav (``.spec.npy``); every stream cut to
    a common frame count (reference data_utils.py:10-165);
  - zero-padded batches sorted by descending length (data_utils.py:168-243);
  - length buckets with an epoch-seeded shuffle, padded to a whole number
    of batches (data_utils.py:246-379).

A batch is padded to its bucket's upper boundary, as in the JAX package
(there for one compiled shape per bucket; here it keeps the kernels'
shapes to a handful). ``DeviceDataCache`` keeps the padded dataset on the
card (``--cache_data_in_gpu``); with several ranks each keeps it on its
own card, since a rank's share of the examples changes with every epoch's
shuffle.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BOUNDARIES = (50, 100, 200, 300, 400, 500, 600, 700, 800, 900)
MAX_FRAMES = 900  # reference cap, data_utils.py:102


def _hann(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)).astype(np.float32)


def spectrogram_np(
    wav: np.ndarray, n_fft: int, hop: int, win: int
) -> np.ndarray:
    """Host-side linear magnitude spectrogram, numerically matching
    ops.stft.spectrogram (reflect pad (n_fft-hop)/2, periodic hann,
    non-centered, sqrt(re^2+im^2+1e-6)). wav: [T] -> [frames, bins]."""
    pad = (n_fft - hop) // 2
    y = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    window = _hann(win)
    if win < n_fft:  # center-pad the window like ops.stft.stft_magnitude
        lpad = (n_fft - win) // 2
        window = np.pad(window, (lpad, n_fft - win - lpad))
    frames = y[idx] * window
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return np.sqrt(spec.real**2 + spec.imag**2 + 1e-6).astype(np.float32)


@dataclass
class FileListRow:
    wav_path: str
    feats_path: str
    f0_coarse_path: str
    f0_float_path: str
    sid: int


def parse_filelist(path: str) -> List[FileListRow]:
    """Parse `wav|feats|f0|f0nsf|sid` rows (preparing_files.py:47)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("|")
            if len(parts) != 5:
                raise ValueError(f"malformed filelist row: {line!r}")
            try:
                sid = int(parts[4])
            except ValueError:
                sid = 0  # reference tolerates bad sids (data_utils.py:47-54)
            rows.append(FileListRow(parts[0], parts[1], parts[2], parts[3], sid))
    return rows


class VCDataset:
    """Loads one example: (phone, pitch, pitchf, spec, wave, sid)."""

    def __init__(
        self,
        rows: Sequence[FileListRow],
        sample_rate: int,
        n_fft: int,
        hop_length: int,
        win_length: int,
        cache_spec: bool = True,
    ):
        self.rows = list(rows)
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.cache_spec = cache_spec
        # Cheap frame count from the WAV header alone (the reference guesses
        # filesize // (3 * hop) assuming 16-bit PCM, data_utils.py:39 — that
        # overestimates float32 wavs, our preprocess output, by 2x and would
        # pad half of every bucket). Header block_align makes it exact for
        # any sample format; sample decode stays lazy.
        from ..utils.audio_io import wav_frames

        self.lengths = []
        for r in self.rows:
            n = wav_frames(r.wav_path) if os.path.exists(r.wav_path) else None
            if n is None and os.path.exists(r.wav_path):
                n = os.path.getsize(r.wav_path) // 2  # 16-bit fallback guess
            self.lengths.append(max(1, (n or 1) // hop_length))

    def __len__(self) -> int:
        return len(self.rows)

    def _load_wav(self, path: str) -> np.ndarray:
        from ..utils.audio_io import read_wav, to_mono

        wav, sr = read_wav(path)
        wav = to_mono(wav)
        if sr != self.sample_rate:
            raise ValueError(f"{path}: {sr} != dataset rate {self.sample_rate}")
        return wav

    def _spec(self, wav_path: str, wav: np.ndarray) -> np.ndarray:
        cache = wav_path.replace(".wav", ".spec.npy")
        if self.cache_spec and os.path.exists(cache):
            try:
                return np.load(cache)
            except Exception:
                pass
        spec = spectrogram_np(wav, self.n_fft, self.hop_length, self.win_length)
        if self.cache_spec:
            try:
                np.save(cache, spec)
            except OSError:
                pass
        return spec

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        row = self.rows[i]
        phone = np.load(row.feats_path)            # [T50, 768] at 50 Hz
        phone = np.repeat(phone, 2, axis=0)        # -> 100 Hz frame rate
        pitch = np.load(row.f0_coarse_path)
        pitchf = np.load(row.f0_float_path)
        n = min(phone.shape[0], MAX_FRAMES, len(pitch), len(pitchf))
        phone, pitch, pitchf = phone[:n], pitch[:n], pitchf[:n]

        wav = self._load_wav(row.wav_path)
        spec = self._spec(row.wav_path, wav)

        n = min(n, spec.shape[0])
        spec = spec[:n]
        phone, pitch, pitchf = phone[:n], pitch[:n], pitchf[:n]
        wav = wav[: n * self.hop_length]
        return {
            "phone": phone.astype(np.float32),
            "pitch": pitch.astype(np.int32),
            "pitchf": pitchf.astype(np.float32),
            "spec": spec.astype(np.float32),
            "wave": wav.astype(np.float32),
            "sid": np.int32(row.sid),
            "length": np.int32(n),
        }


def pad_batch(
    examples: Sequence[Dict[str, np.ndarray]],
    target_frames: int,
    hop_length: int,
) -> Dict[str, np.ndarray]:
    """Zero-pad a list of examples to one static [B, target_frames, ...]
    batch (collate parity, data_utils.py:168-243, but padded to the bucket
    boundary for shape stability). Sorted by descending length like the
    reference collate."""
    examples = sorted(examples, key=lambda e: -int(e["length"]))
    b = len(examples)
    feat_dim = examples[0]["phone"].shape[1]
    spec_dim = examples[0]["spec"].shape[1]
    tw = target_frames * hop_length

    phone = np.zeros((b, target_frames, feat_dim), np.float32)
    pitch = np.zeros((b, target_frames), np.int32)
    pitchf = np.zeros((b, target_frames), np.float32)
    spec = np.zeros((b, target_frames, spec_dim), np.float32)
    wave = np.zeros((b, tw, 1), np.float32)
    sid = np.zeros((b,), np.int32)
    lengths = np.zeros((b,), np.int32)

    for i, e in enumerate(examples):
        n = min(int(e["length"]), target_frames)
        phone[i, :n] = e["phone"][:n]
        pitch[i, :n] = e["pitch"][:n]
        pitchf[i, :n] = e["pitchf"][:n]
        spec[i, :n] = e["spec"][:n]
        w = e["wave"][: n * hop_length]
        wave[i, : len(w), 0] = w
        sid[i] = e["sid"]
        lengths[i] = n

    return {
        "phone": phone,
        "phone_lengths": lengths,
        "pitch": pitch,
        "pitchf": pitchf,
        "spec": spec,
        "spec_lengths": lengths,
        "wave": wave,
        "wave_lengths": lengths * hop_length,
        "sid": sid,
    }


class BucketBatcher:
    """Length-bucketed batch iterator with static shapes per bucket.

    Mirrors DistributedBucketSampler semantics (epoch-seeded shuffle,
    buckets padded to a multiple of the global batch by repeating indices,
    the shards interleaved) but emits host batches padded to the bucket
    boundary. Shard ``shard_index`` of ``num_shards`` takes ``batch_size``
    rows a step; the shards' rows of a step together are the one-shard
    batcher's step at ``batch_size * num_shards`` rows, in the same bucket.
    """

    def __init__(
        self,
        dataset: VCDataset,
        batch_size: int,
        boundaries: Sequence[int] = DEFAULT_BOUNDARIES,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.shard_index = shard_index
        self.num_shards = num_shards

        self.buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(dataset.lengths):
            for bi in range(len(self.boundaries) - 1):
                if self.boundaries[bi] < length <= self.boundaries[bi + 1]:
                    self.buckets[bi].append(i)
                    break
            else:
                if length > self.boundaries[-1]:
                    self.buckets[-1].append(i)  # cap bucket (frames clamp to 900)
                # length <= boundaries[0]: drop, like the reference sampler's
                # _bisect returning -1 (data_utils.py:355-363) — near-empty
                # zero-padded rows must not reach the discriminator as "real".
        self.bucket_frames = self.boundaries[1:]
        n_dropped = len(dataset.lengths) - sum(len(b) for b in self.buckets)
        if n_dropped and not any(self.buckets):
            # every clip is sub-boundary (toy/smoke datasets): keep them in
            # bucket 0 rather than yielding an empty epoch
            for i in range(len(dataset.lengths)):
                self.buckets[0].append(i)
            n_dropped = 0
        if n_dropped:
            print(f"BucketBatcher: dropped {n_dropped} clip(s) shorter than "
                  f"{self.boundaries[0]} frames")

    def steps_per_epoch(self) -> int:
        gbs = self.batch_size * self.num_shards
        return sum(-(-len(bucket) // gbs) for bucket in self.buckets)

    def epoch_batches(self, epoch: int) -> Iterator[Tuple[int, List[int]]]:
        """Yield (bucket_frames, example_indices) for this shard."""
        rng = np.random.default_rng(epoch)
        plans = []
        bs, gbs = self.batch_size, self.batch_size * self.num_shards
        for frames, bucket in zip(self.bucket_frames, self.buckets):
            if not bucket:
                continue
            ids = list(bucket)
            rng.shuffle(ids)
            rem = (-len(ids)) % gbs
            ids = ids + ids * (rem // len(ids)) + ids[: rem % len(ids)]
            ids = ids[self.shard_index::self.num_shards]
            for j in range(len(ids) // bs):
                plans.append((frames, ids[j * bs : (j + 1) * bs]))
        rng.shuffle(plans)
        return iter(plans)

    def __call__(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for frames, idxs in self.epoch_batches(epoch):
            frames = min(frames, MAX_FRAMES)
            yield pad_batch(
                [self.dataset[i] for i in idxs], frames, self.dataset.hop_length
            )


class DeviceDataCache:
    """Device-resident padded dataset (the reference's
    ``--cache_data_in_gpu``): every non-empty bucket's examples are padded
    to the bucket boundary and stacked into device tensors once; a step's
    batch is a gather on the device, so steady-state training moves no
    batch bytes from the host. For datasets that fit beside the model
    (``estimate_bytes`` first)."""

    def __init__(self, dataset: VCDataset, batcher: "BucketBatcher", device):
        import torch

        self.hop_length = dataset.hop_length
        self.device = torch.device(device)
        self.buckets: Dict[int, Dict[str, Any]] = {}
        self.pos: Dict[int, int] = {}  # dataset idx -> row within its bucket
        for frames, bucket in zip(batcher.bucket_frames, batcher.buckets):
            if not bucket:
                continue
            frames = min(frames, MAX_FRAMES)
            rows = [dataset[i] for i in bucket]
            stacked = pad_batch(rows, frames, dataset.hop_length)
            # pad_batch sorts rows by length, descending: map each dataset
            # index to its stacked row through the same order
            order = sorted(range(len(rows)),
                           key=lambda j: -int(rows[j]["length"]))
            for row_pos, j in enumerate(order):
                self.pos[bucket[j]] = row_pos
            self.buckets[frames] = {k: torch.from_numpy(v).to(self.device)
                                    for k, v in stacked.items()}

    @staticmethod
    def estimate_bytes(dataset: VCDataset, batcher: "BucketBatcher",
                       feat_dim: int = 768, spec_dim: int = 1025) -> int:
        total = 0
        for frames, bucket in zip(batcher.bucket_frames, batcher.buckets):
            frames = min(frames, MAX_FRAMES)
            per = frames * (feat_dim * 4 + 4 + 4 + spec_dim * 4
                            + dataset.hop_length * 4) + 12
            total += per * len(bucket)
        return total

    def batch(self, frames: int, ids: Sequence[int]) -> Dict[str, Any]:
        """One batch as gathers on the device, rows in length-descending
        order as ``pad_batch`` gives them."""
        import torch

        frames = min(frames, MAX_FRAMES)
        arrs = self.buckets[frames]
        take = torch.tensor(sorted(self.pos[i] for i in ids), device=self.device)
        return {k: v.index_select(0, take) for k, v in arrs.items()}


def train_val_split(
    rows: Sequence[FileListRow], val_fraction: float = 0.1, seed: int = 1234
) -> Tuple[List[FileListRow], List[FileListRow]]:
    """Seeded 90/10 split (reference train.py:532-538)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(rows))
    n_val = max(1, int(len(rows) * val_fraction)) if len(rows) > 1 else 0
    val = [rows[i] for i in idx[:n_val]]
    train = [rows[i] for i in idx[n_val:]]
    return train, val
