"""The trainer (port of ``rvc_tpu/train/trainer.py``): the epoch loop,
validation, checkpoints and resume, the deployable export.

As the JAX trainer (reference rvc/train/train.py:302-1600): a seeded 90/10
split, bucket-sampled epochs, warmup and exponential learning-rate decay,
50-step metric windows, validation on every save epoch (mel L1, mrSTFT,
SI-SDR, and PESQ through the ITU wheel where installed, else the numpy
estimate ``pesq_est``), G/D checkpoints with resume, the deployable
weights file and the reference-sample render.

One process drives one card. Checkpoints are ``.pth`` files in the
reference's layouts: ``G_<e>.pth`` / ``D_<e>.pth`` (full, with the port's
optimizer state) and ``<name>_<e>e.pth`` (deployable); resume also reads
the JAX package's ``.npz``. Metrics go to ``metrics.jsonl`` (and TensorBoard
where installed) and stay on the device between log points.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import queue
import re
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.discriminators import MultiPeriodDiscriminator
from ..models.synthesizer import Synthesizer
from ..ops.stft import mel_spectrogram
from . import losses as L
from .data import BucketBatcher, DeviceDataCache, VCDataset, parse_filelist, train_val_split
from .optimizers import module_optimizer
from .schedules import make_epoch_lr_schedule
from .step import TrainStep

# a stop asked for from another thread (signal handlers install on the main
# thread only): fit() checkpoints and returns at the next epoch boundary
_STOP_EVENT = threading.Event()
CACHE_LIMIT_BYTES = 6 << 30  # the device-resident dataset's budget
LOG_EVERY = 50


def request_stop() -> None:
    """Ask a running ``Trainer.fit`` to checkpoint and return at the next
    epoch boundary. fit() never clears the flag: a launcher that reuses the
    process calls ``reset_stop()`` before it starts the next run."""
    _STOP_EVENT.set()


def reset_stop() -> None:
    _STOP_EVENT.clear()


class MetricsLogger:
    """JSONL lines and, where tensorboard is installed, its scalars."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir, flush_secs=86400)
        except ImportError:
            pass

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": step, **{f"{prefix}{k}": float(v) for k, v in scalars.items()}}
        self._file.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def flush(self) -> None:
        self._file.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()


@dataclasses.dataclass
class TrainerArgs:
    exp_dir: str
    total_epochs: int = 200
    save_every_epoch: int = 10
    save_only_latest: bool = False
    pretrain_g: str = ""
    pretrain_d: str = ""
    discriminators: str = "mpd"
    use_orbax: bool = False
    cache_data: bool = False  # device-resident dataset (ref cache_data_in_gpu)
    batch_size: Optional[int] = None
    optimizer: Optional[str] = None
    warmup_epochs: Optional[int] = None
    # per-network learning rates (reference --custom_lr_g/_d); None = the
    # config's shared learning_rate
    lr_g: Optional[float] = None
    lr_d: Optional[float] = None
    save_every_weights: bool = True
    device_indices: Optional[Tuple[int, ...]] = None
    seed: int = 1234
    device: str = "cuda"


def _latest_checkpoint(exp_dir: str, prefix: str) -> Optional[str]:
    """The newest ``<prefix>_<n>.pth`` (or the JAX package's ``.npz``) by
    epoch number; the ``.pth`` of an epoch that has both."""
    best, best_key = None, None
    for path in glob.glob(os.path.join(exp_dir, f"{prefix}_*")):
        m = re.search(rf"{prefix}_(\d+)\.(pth|npz)$", path)
        if m:
            key = (int(m.group(1)), m.group(2) == "pth")
            if best_key is None or key > best_key:
                best, best_key = path, key
    return best


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initial weights, drawn on the host (so a seed gives the same
    weights on the card and on the CPU) in the JAX package's scheme: conv
    and dense kernels lecun-normal (std 1/sqrt(fan_in)), the HiFi-GAN
    ResBlocks' convs normal(0, 0.01), the flow's output convs zero (the flow
    starts as the identity), biases zero, layer norms one, embeddings and
    relative position embeddings normal, each weight-norm gain the norm of
    its direction."""
    from ..models.commons import Conv1d, ConvTranspose1d, ResBlock
    from ..models.discriminators import NormConv2d
    from ..models.flows import ResidualCouplingLayer

    small = {id(m) for blk in module.modules() if isinstance(blk, ResBlock)
             for m in blk.modules()}
    zero = {id(layer.post) for layer in module.modules()
            if isinstance(layer, ResidualCouplingLayer)}

    def normal(p, std):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    with torch.no_grad():
        for mod in module.modules():
            params = dict(mod.named_parameters(recurse=False))
            if not params:
                continue
            w = params.get("weight_v", params.get("weight"))
            if isinstance(mod, (Conv1d, NormConv2d)):
                fan_in = w[0].numel()
                if id(mod) in zero:
                    w.zero_()
                else:
                    normal(w, 0.01 if id(mod) in small else fan_in ** -0.5)
            elif isinstance(mod, ConvTranspose1d):
                normal(w, (w.shape[1] * w.shape[2]) ** -0.5)
            elif isinstance(mod, nn.Linear):
                normal(w, w.shape[1] ** -0.5)
            elif isinstance(mod, nn.Embedding):
                normal(w, 1.0)
            for name, p in params.items():
                if name in ("bias", "beta"):
                    p.zero_()
                elif name == "gamma":
                    p.fill_(1.0)
                elif name.startswith("emb_rel_"):
                    normal(p, p.shape[-1] ** -0.5)
            if "weight_g" in params:
                v = params["weight_v"]
                params["weight_g"].copy_(torch.sqrt(torch.sum(
                    v * v, dim=tuple(range(1, v.ndim)), keepdim=True) + 1e-12))


def _load_state(path: str, kind: str) -> Dict[str, torch.Tensor]:
    """A G or D parameter file -> the port's state_dict: the JAX package's
    ``.npz`` (through ``convert``), or a reference / port ``.pth``
    (``"model"`` or ``"weight"``, either weight-norm spelling)."""
    from .. import convert
    from ..utils.checkpoints import load_checkpoint, normalize_weight_norm_keys

    if path.endswith(".npz"):
        tree, _ = load_checkpoint(path)
        tree = tree.get("model", tree)
        return (convert.synthesizer_state_dict(tree, posterior=True) if kind == "G"
                else convert.mpd_state_dict(tree))
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = cpt.get("model", cpt.get("weight", cpt)) if isinstance(cpt, dict) else cpt
    return {k: v.float() for k, v in normalize_weight_norm_keys(sd).items()
            if torch.is_tensor(v)}


def _fits(module: nn.Module, sd: Dict[str, torch.Tensor]) -> bool:
    ref = module.state_dict()
    return ref.keys() == sd.keys() and all(
        tuple(ref[k].shape) == tuple(v.shape) for k, v in sd.items())


class Trainer:
    def __init__(self, cfg, args: TrainerArgs):
        if args.discriminators.replace(" ", "") != "mpd":
            raise NotImplementedError(
                f"--discriminators {args.discriminators!r}: the port trains with "
                "the multi-period discriminator only; the discriminator zoo "
                "waits for ROADMAP A.11")
        if args.use_orbax:
            raise NotImplementedError(
                "--use_orbax: orbax checkpoints are the JAX package's; the "
                "port writes .pth checkpoints and will not have orbax")
        if args.device_indices is not None and len(args.device_indices) > 1:
            raise NotImplementedError(
                f"--gpu {args.device_indices}: training on several cards waits "
                "for ROADMAP A.13")
        if cfg.model.vocoder != "HiFi-GAN":
            raise NotImplementedError(
                f"the {cfg.model.vocoder!r} vocoder is not ported yet (ROADMAP A.9)")
        train_over = {}
        if args.batch_size:
            train_over["batch_size"] = args.batch_size
        if args.optimizer:
            train_over["optimizer"] = args.optimizer
        if args.warmup_epochs is not None:
            train_over["warmup_epochs"] = args.warmup_epochs
        if train_over:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_over))
        self.cfg, self.args = cfg, args
        device = args.device
        if args.device_indices:
            device = f"{device}:{args.device_indices[0]}"
        self.device = resolve_device(device)

        rows = parse_filelist(os.path.join(args.exp_dir, "filelist.txt"))
        train_rows, val_rows = train_val_split(rows, 0.1, seed=args.seed)
        d = cfg.data
        self.train_ds = VCDataset(train_rows, d.sample_rate, d.filter_length,
                                  d.hop_length, d.win_length)
        self.val_ds = (VCDataset(val_rows, d.sample_rate, d.filter_length,
                                 d.hop_length, d.win_length) if val_rows else None)
        self.batcher = BucketBatcher(self.train_ds, cfg.train.batch_size)
        self.steps_per_epoch = max(1, self.batcher.steps_per_epoch())

        self.model_g = Synthesizer.from_config(cfg, device=self.device, train=True)
        self.model_d = MultiPeriodDiscriminator(
            use_spectral_norm=cfg.model.use_spectral_norm).to(self.device)
        spe, t = self.steps_per_epoch, cfg.train
        self.sched_g = make_epoch_lr_schedule(args.lr_g or t.learning_rate, spe,
                                              t.warmup_epochs, t.lr_decay)
        self.sched_d = self.sched_g if args.lr_d is None else make_epoch_lr_schedule(
            args.lr_d, spe, t.warmup_epochs, t.lr_decay)
        self.logger = MetricsLogger(args.exp_dir)
        self.step_fn: Optional[TrainStep] = None
        self.start_epoch = 1

        self._device_cache = None
        if args.cache_data:
            est = DeviceDataCache.estimate_bytes(self.train_ds, self.batcher,
                                                 spec_dim=d.spec_channels)
            if est > CACHE_LIMIT_BYTES:
                print(f"cache_data: dataset ~{est / 1e9:.1f} GB exceeds the "
                      f"{CACHE_LIMIT_BYTES / 1e9:.0f} GB cache budget; streaming "
                      "batches instead")
            else:
                print(f"cache_data: uploading ~{est / 1e9:.2f} GB of padded "
                      "examples to the device (one-time)")
                self._device_cache = DeviceDataCache(self.train_ds, self.batcher,
                                                     self.device)

    # -- state ---------------------------------------------------------------

    @property
    def step(self) -> int:
        return self.step_fn.step if self.step_fn is not None else 0

    def _build_step(self) -> None:
        """Optimizers over the current weights (ranger21's slow weights
        start from them) and the step."""
        name = self.cfg.train.optimizer
        self.step_fn = TrainStep(
            self.cfg, self.model_g, self.model_d,
            module_optimizer(name, self.model_g, self.sched_g),
            module_optimizer(name, self.model_d, self.sched_d),
            self.steps_per_epoch, lr_schedule=self.sched_g)

    def init_state(self) -> None:
        """Weights from ``--seed``, then a resume from the newest G_/D_
        checkpoint in the experiment directory, or the pretrained files."""
        gen = torch.Generator().manual_seed(self.args.seed)
        init_parameters(self.model_g, gen)
        init_parameters(self.model_d, gen)
        g_path = _latest_checkpoint(self.args.exp_dir, "G")
        d_path = _latest_checkpoint(self.args.exp_dir, "D")
        if g_path and d_path:
            self._resume(g_path, d_path)
        else:
            self._load_pretrained()
            self._build_step()

    def _resume(self, g_path: str, d_path: str) -> None:
        self.model_g.load_state_dict(_load_state(g_path, "G"), strict=True)
        self.model_d.load_state_dict(_load_state(d_path, "D"), strict=True)
        self._build_step()
        epoch = int(re.search(r"_(\d+)\.\w+$", g_path).group(1))
        if g_path.endswith(".pth"):
            cpt_g = torch.load(g_path, map_location="cpu", weights_only=True)
            cpt_d = torch.load(d_path, map_location="cpu", weights_only=True)
            epoch = int(cpt_g.get("iteration", epoch))
            s = self.step_fn
            try:
                if cpt_g.get("optimizer") and cpt_d.get("optimizer"):
                    s.opt_g.load_state_dict(cpt_g["optimizer"])
                    s.opt_d.load_state_dict(cpt_d["optimizer"])
                if s.balancer is not None and "balancer" in cpt_g:
                    for k, v in cpt_g["balancer"].items():
                        s.balancer[k].data.copy_(v)
                    s.opt_b.load_state_dict(cpt_g["balancer_opt"])
            except (KeyError, ValueError) as e:
                print(f"optimizer state restore failed ({e}); fresh optimizer")
        self.step_fn.step = epoch * self.steps_per_epoch
        self.start_epoch = epoch + 1
        print(f"resumed from epoch {epoch}")

    def _load_pretrained(self) -> None:
        for path, kind, model in ((self.args.pretrain_g, "G", self.model_g),
                                  (self.args.pretrain_d, "D", self.model_d)):
            if not path or path == "None" or not os.path.exists(path):
                continue
            sd = _load_state(path, kind)
            if not _fits(model, sd):
                print(f"pretrained {kind} at {path} does not match the configured "
                      "architecture; skipping it")
                continue
            model.load_state_dict(sd, strict=True)
            print(f"loaded pretrained {kind} from {path}")

    def save(self, epoch: int) -> None:
        from ..utils.checkpoints import export_full_pth, export_rvc_pth

        suffix = 2333333 if self.args.save_only_latest else epoch
        s, lr = self.step_fn, self.cfg.train.learning_rate
        extra = {}
        if s.balancer is not None:
            extra = {"balancer": {k: v.detach().cpu() for k, v in s.balancer.items()},
                     "balancer_opt": s.opt_b.state_dict()}
        export_full_pth(self.model_g, os.path.join(self.args.exp_dir, f"G_{suffix}.pth"),
                        epoch, lr, s.opt_g.state_dict(), **extra)
        export_full_pth(self.model_d, os.path.join(self.args.exp_dir, f"D_{suffix}.pth"),
                        epoch, lr, s.opt_d.state_dict())
        name = os.path.basename(os.path.normpath(self.args.exp_dir))
        if self.args.save_every_weights or epoch >= self.args.total_epochs:
            export_rvc_pth(self.model_g, os.path.join(self.args.exp_dir,
                                                      f"{name}_{epoch}e.pth"),
                           self.cfg, epoch=epoch, step=self.step, name=name)

    # -- loops ---------------------------------------------------------------

    def _prefetch(self, iterator, depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches assembled (and pinned, for the card) on a background
        thread while the device runs the previous step."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        failure: list = []
        pin = self.device.type == "cuda"

        def worker():
            try:
                for item in iterator:
                    batch = {k: torch.from_numpy(v) for k, v in item.items()}
                    q.put({k: v.pin_memory() if pin else v for k, v in batch.items()})
            except BaseException as e:  # handed to the consumer
                failure.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield {k: v.to(self.device, non_blocking=True) for k, v in item.items()}

    def train_epoch(self, epoch: int, generator: torch.Generator) -> Dict[str, float]:
        """One epoch of steps; the metrics are summed on the device and read
        back at the 50-step log points and at the end."""
        t0 = time.time()
        if self._device_cache is not None:
            batches = (self._device_cache.batch(frames, ids)
                       for frames, ids in self.batcher.epoch_batches(epoch))
        else:
            batches = self._prefetch(self.batcher(epoch=epoch))
        sums, last, prev_sums, prev_n, n = None, None, {}, 0, 0
        for batch in batches:
            metrics = self.step_fn(batch, generator)
            n += 1
            last = metrics
            sums = dict(metrics) if sums is None else {k: sums[k] + v
                                                       for k, v in metrics.items()}
            if self.step % LOG_EVERY == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host_sums = {k: float(v) for k, v in sums.items()}
                w = max(n - prev_n, 1)
                for k, v in host_sums.items():
                    host[f"avg50/{k}"] = (v - prev_sums.get(k, 0.0)) / w
                prev_sums, prev_n = host_sums, n
                self.logger.log(self.step, host, prefix="train/")
        out = {k: float(v) for k, v in (last or {}).items()}
        avg = {f"avg/{k}": float(v) / max(n, 1) for k, v in (sums or {}).items()}
        avg["epoch_seconds"] = time.time() - t0
        avg["steps_per_sec"] = n / max(avg["epoch_seconds"], 1e-9)
        self.logger.log(self.step, avg, prefix="epoch/")
        return {**out, **avg}

    def _infer(self, phone, pitch, pitchf, n: int, sid: int, generator) -> np.ndarray:
        """``Synthesizer.infer`` on one example padded to a 100-frame
        bucket; the audio of its n frames."""
        dev = self.device
        n_pad = -(-n // 100) * 100

        def padded(a, dtype):
            out = np.zeros((1, n_pad) + a.shape[1:], dtype)
            out[0, :n] = a[:n]
            return torch.from_numpy(out).to(dev)

        audio, _ = self.model_g.infer(
            padded(phone, np.float32), torch.tensor([n], device=dev),
            padded(pitch, np.int64), padded(pitchf, np.float32),
            torch.tensor([sid], device=dev), generator=generator)
        return audio[0, :n * self.cfg.data.hop_length, 0].float().cpu().numpy()

    def validate(self, generator: Optional[torch.Generator] = None,
                 max_items: Optional[int] = None) -> Dict[str, float]:
        """Hold-out metrics through ``Synthesizer.infer`` on the device (the
        reference's validation loop): mel L1, mrSTFT, SI-SDR, and PESQ-WB
        (``pesq`` from the ITU wheel where installed, else ``pesq_est`` from
        the numpy estimator)."""
        from ..utils.audio_io import resample

        if self.val_ds is None or len(self.val_ds) == 0:
            return {}
        d, dev = self.cfg.data, self.device
        mel_l1s, mrstfts, sisdrs, pesqs, pesq_itu = [], [], [], [], False
        for i in range(min(len(self.val_ds), max_items or len(self.val_ds))):
            ex = self.val_ds[i]
            n = int(ex["length"])
            if n < 16:
                continue
            y_hat = self._infer(ex["phone"], ex["pitch"], ex["pitchf"], n,
                                int(ex["sid"]), generator)
            y_ref = ex["wave"][:len(y_hat)]
            y_hat = y_hat[:len(y_ref)]
            if len(y_ref) < d.hop_length * 4:
                continue
            ref_t = torch.from_numpy(y_ref[None]).to(dev)
            hat_t = torch.from_numpy(np.ascontiguousarray(y_hat[None])).to(dev)
            mels = [mel_spectrogram(w, d.filter_length, d.n_mel_channels, d.sample_rate,
                                    d.hop_length, d.win_length, d.mel_fmin, d.mel_fmax)
                    for w in (ref_t, hat_t)]
            mel_l1s.append(float(torch.mean(torch.abs(mels[0] - mels[1]))))
            mrstfts.append(float(L.multi_resolution_stft_loss(ref_t, hat_t)))
            sisdrs.append(float(L.si_sdr(hat_t, ref_t)))
            ref16 = resample(y_ref, d.sample_rate, 16000)
            hat16 = resample(y_hat, d.sample_rate, 16000)
            try:
                from pesq import pesq as pesq_fn  # the ITU C wheel, where installed

                pesqs.append(float(pesq_fn(16000, ref16, hat16, "wb")))
                pesq_itu = True
            except ImportError:
                from ..utils.pesq_np import pesq_wb

                pesqs.append(pesq_wb(ref16, hat16))
        out = {}
        if mel_l1s:
            out["validation/loss/mel_l1"] = float(np.mean(mel_l1s))
            out["validation/loss/mrstft"] = float(np.mean(mrstfts))
            out["validation/score/si_sdr"] = float(np.mean(sisdrs))
        if pesqs:
            out[f"validation/score/{'pesq' if pesq_itu else 'pesq_est'}"] = float(
                np.mean(pesqs))
        if out:
            self.logger.log(self.step, out)
        return out

    def render_reference(self, epoch: int,
                         generator: Optional[torch.Generator] = None) -> Optional[str]:
        """Render logs/reference/{ref_feats,ref_f0c,ref_f0f}.npy through
        ``infer`` into ``reference_e<epoch>.wav`` (and its mel image);
        skipped, with a printed line, where those files are absent."""
        from ..utils.audio_io import write_wav

        ref_dir = os.path.join("logs", "reference")
        paths = [os.path.join(ref_dir, n) for n in
                 ("ref_feats.npy", "ref_f0c.npy", "ref_f0f.npy")]
        if not all(os.path.exists(p) for p in paths):
            print(f"reference render skipped: no {ref_dir}/ref_*.npy")
            return None
        feats, f0c, f0f = (np.load(p) for p in paths)
        phone = np.repeat(feats, 2, axis=0)
        n = min(len(phone), len(f0c), len(f0f))
        wav = self._infer(phone, f0c, f0f, n, 0, generator)
        out = os.path.join(self.args.exp_dir, f"reference_e{epoch}.wav")
        write_wav(out, wav, self.cfg.data.sample_rate)
        self._spectrogram_image(wav, epoch)
        return out

    def _spectrogram_image(self, wav: np.ndarray, epoch: int) -> None:
        """The reference render's mel spectrogram as a PNG (and a
        TensorBoard image); skipped, with a printed line, without
        matplotlib."""
        try:
            import matplotlib
        except ImportError:
            print("spectrogram image skipped: matplotlib is not installed")
            return
        from ..ops.mel import mel_filterbank
        from .data import spectrogram_np

        d = self.cfg.data
        spec = spectrogram_np(wav, d.filter_length, d.hop_length, d.win_length)
        fb = mel_filterbank(d.sample_rate, d.filter_length, d.n_mel_channels,
                            d.mel_fmin, d.mel_fmax or d.sample_rate / 2)
        mel_db = np.log(np.maximum(spec @ fb.T, 1e-5)).T
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 3))
        im = ax.imshow(mel_db, aspect="auto", origin="lower", interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_title(f"reference mel (epoch {epoch})")
        fig.tight_layout()
        fig.savefig(os.path.join(self.args.exp_dir, f"reference_e{epoch}.png"), dpi=100)
        if self.logger._tb is not None:
            fig.canvas.draw()
            img = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            self.logger._tb.add_image("reference/mel", img, epoch, dataformats="HWC")
        plt.close(fig)

    def _write_heartbeat(self, epoch: int) -> None:
        """epoch, step, time and pid in heartbeat.json, for a supervisor
        that watches for stalls."""
        hb = {"epoch": epoch, "step": self.step, "time": time.time(),
              "pid": os.getpid()}
        try:
            with open(os.path.join(self.args.exp_dir, "heartbeat.json"), "w") as f:
                json.dump(hb, f)
        except OSError as e:
            print(f"heartbeat not written ({e})")

    def fit(self) -> None:
        """Train from ``start_epoch`` to ``total_epochs``; validate, render
        and save on every save epoch and the last. SIGTERM / SIGINT (or
        ``request_stop``) end the epoch and save where it stopped."""
        if self.step_fn is None:
            self.init_state()
        interrupted = {"flag": False}

        def handler(signum, frame):
            interrupted["flag"] = True
            print(f"signal {signum}: finishing the epoch, then checkpointing")

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread
        gen = torch.Generator().manual_seed(self.args.seed)
        try:
            for epoch in range(self.start_epoch, self.args.total_epochs + 1):
                if interrupted["flag"] or _STOP_EVENT.is_set():
                    self.save(epoch - 1)
                    print(f"emergency checkpoint at epoch {epoch - 1}; exiting")
                    break
                stats = self.train_epoch(epoch, gen)
                print(f"epoch {epoch}/{self.args.total_epochs} "
                      f"| {stats.get('epoch_seconds', 0):.1f}s "
                      f"| g={stats.get('avg/loss_gen_all', float('nan')):.3f} "
                      f"| d={stats.get('avg/loss_disc', float('nan')):.3f}", flush=True)
                self._write_heartbeat(epoch)
                if (epoch % self.args.save_every_epoch == 0
                        or epoch == self.args.total_epochs):
                    vgen = torch.Generator(self.device).manual_seed(
                        self.args.seed + epoch)
                    self.validate(vgen)
                    self.render_reference(epoch, vgen)
                    self.save(epoch)
                    self.logger.flush()
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
