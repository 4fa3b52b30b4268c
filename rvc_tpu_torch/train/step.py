"""One GAN optimizer update (port of ``rvc_tpu/train/step.py``).

As the JAX step does it (reference rvc/train/train.py:1014-1200):

  1. the generator runs once, under autograd (``torch.utils.checkpoint``
     recomputes it in the backward with ``use_checkpointing``);
  2. the discriminator updates, once or twice, on the detached output;
  3. the generator's losses are taken through the UPDATED discriminator:
     mel (multi-scale or single-scale), feature matching, KL and the
     adversarial term, optionally through the uncertainty balancer (frozen
     for its first epochs, with its own Adam on the generator's schedule);
  4. the generator and the balancer step.

The bf16 policy is the JAX package's: parameters are stored in float32 and
cast to bf16 at the forward boundary (``torch.func.functional_call`` on the
cast tensors, so the gradients come back to the float32 parameters), the
discriminator's inputs are cast too, and losses and optimizer math stay in
float32. The random latent slice starts, the posterior and sine noise and
the WGAN-GP interpolation weights come from the host ``torch.Generator``
the caller passes (the slice starts and the weights may be given
explicitly); the model's noise is drawn on the device from a seed it gives.

Under ``parallel.launch`` each rank holds an equal share of the global
batch's rows. It computes its share of every loss, so that the shares add
up to the global batch's value: a mean over rows is divided by the world
size, and the KL's denominator is the mask's sum over every rank. The
gradients of D, then of G and the balancer, are summed over the ranks
before the norms, the clipping and the optimizers see them, and the
metrics are summed the same way. The random draws are made for the global
batch (``models.commons.RowDraws``) and each rank keeps its rows. So the
ranks step as one process steps on the ranks' rows concatenated in rank
order, and their parameters stay equal, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models.commons import RowDraws, rand_slice_starts, slice_segments
from ..ops.stft import mel_spectrogram, spec_to_mel
from ..parallel.mesh import all_reduce_sum, rank, world_size
from . import losses as L
from .optimizers import Optimizer

# the reference balancer's initial log-sigmas: the uncertainty weights start
# at the fixed weights (adv 1, mel 45, fm 2, kl 1)
BALANCER_INIT = {"adv": -0.3466, "mel": -2.2499, "fm": -0.6931, "kl": -0.3466}


def balancer_total(balancer: Dict[str, torch.Tensor],
                   terms: Dict[str, torch.Tensor], frozen: bool,
                   share: float = 1.0) -> torch.Tensor:
    """Uncertainty-weighted total: per term loss / (2 exp(s)^2) + s, the
    log-sigmas s held at their start while ``frozen``; a rank's losses are
    its shares and ``share`` weights its s."""
    total = 0.0
    for name, loss in terms.items():
        s = (torch.full_like(balancer[name], BALANCER_INIT[name]) if frozen
             else balancer[name])
        total = total + loss / (2.0 * torch.exp(s) ** 2) + s * share
    return total


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def _grads(loss, params: List[torch.Tensor]) -> List[torch.Tensor]:
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(got, params)]


# the decoders' per-stage parts: a name's index after the part is the
# stage (HiFi-GAN's resblocks count num_kernels chains a stage)
_STAGE_PARTS = ("resblocks", "mrfs", "upsample_conv_blocks")


def grad_group(name: str, num_kernels: int) -> List[str]:
    """The gradient-norm groups of a generator parameter: its top-level
    module (the JAX step's ``gsub_g`` keys: ``enc_p``, ``enc_q``, ``flow``,
    ``emb_g``, ``dec``), and for the decoder also its part under the
    reference's names: ``dec.<part>`` (``dec.ups``, ``dec.upsamples``,
    ``dec.noise_convs``, ``dec.downsample_blocks``, ``dec.m_source``, ...)
    or, for the stage tails, ``dec.<part>.stage<i>`` (``dec.resblocks``,
    MRF HiFi-GAN's ``dec.mrfs``, RefineGAN's ``dec.upsample_conv_blocks``)."""
    parts = name.split(".")
    groups = [parts[0]]
    if parts[0] == "dec":
        if parts[1] in _STAGE_PARTS:
            stage = int(parts[2]) // (num_kernels if parts[1] == "resblocks" else 1)
            groups.append(f"dec.{parts[1]}.stage{stage}")
        else:
            groups.append(f"dec.{parts[1]}")
    return groups


class TrainStep:
    """``step(batch, generator, ...)`` runs one update of ``model_g`` and
    ``model_d`` in place and returns its metrics as 0-d float32 tensors on
    the device (none is read back to the host).

    batch: phone [B, T, 768] f32, phone_lengths [B], pitch [B, T] int,
    pitchf [B, T] f32, spec [B, T, spec_channels] f32, spec_lengths [B],
    wave [B, T * hop, 1] f32, sid [B], all on the models' device."""

    def __init__(self, cfg, model_g: nn.Module, model_d: nn.Module,
                 opt_g: Optimizer, opt_d: Optimizer, steps_per_epoch: int = 1,
                 balancer_freeze_epochs: int = 3,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 debug_grads: bool = False):
        self.cfg, self.model_g, self.model_d = cfg, model_g, model_d
        self.opt_g, self.opt_d = opt_g, opt_d
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.balancer_freeze_epochs = balancer_freeze_epochs
        self.debug_grads = debug_grads
        self.step = 0
        self.rank, self.world = rank(), world_size()
        t = cfg.train
        self.seg_frames = t.segment_size // cfg.data.hop_length
        self.dtype = torch.bfloat16 if t.bf16_run else torch.float32
        self.d_updates = 2 if t.double_d_update else 1
        self.balancer = self.opt_b = None
        if t.use_balancer:
            dev = next(model_g.parameters()).device
            self.balancer = {k: torch.tensor(v, device=dev, requires_grad=True)
                             for k, v in BALANCER_INIT.items()}
            self.opt_b = Optimizer("adamw", list(self.balancer.values()),
                                   lr_schedule or t.learning_rate)
        self.g_names = [n for n, _ in model_g.named_parameters()]
        self.g_params = [p for _, p in model_g.named_parameters()]
        self.d_names = [n for n, _ in model_d.named_parameters()]
        self.d_params = [p for _, p in model_d.named_parameters()]
        # called with "g_forward", "d_update", "g_update" as each part
        # starts, and "end": a timer's hook (CUDA events), None to skip
        self.mark: Optional[Callable[[str], None]] = None

    def _mark(self, name: str) -> None:
        if self.mark is not None:
            self.mark(name)

    def _cast(self, module: nn.Module, grad: bool) -> Dict[str, torch.Tensor]:
        params = dict(module.named_parameters())
        if not grad:
            params = {k: v.detach() for k, v in params.items()}
        return {k: v.to(self.dtype) for k, v in params.items()}

    def d_apply(self, y: torch.Tensor, y_hat: torch.Tensor, grad_params: bool = True):
        """The discriminator on (real, fake) [B, T, 1] under the precision
        policy; ``grad_params`` False keeps its parameters out of the graph."""
        return functional_call(self.model_d, self._cast(self.model_d, grad_params),
                               (y.to(self.dtype), y_hat.to(self.dtype)))

    def _draws(self, generator, rows: int):
        """``generator`` as a source of this rank's rows of the global
        batch's draws (the generator itself on one rank)."""
        if self.world == 1:
            return generator
        return RowDraws(generator, range(self.rank * rows, (self.rank + 1) * rows),
                        rows * self.world)

    def g_forward(self, batch, ids_slice: torch.Tensor, seed: int):
        """The generator's training forward under the precision policy:
        (y_hat, z, z_p, m_p, logs_p, m_q, logs_q, y_mask), float32."""
        dev = batch["phone"].device

        def fwd(phone, spec):
            gen = self._draws(torch.Generator(dev).manual_seed(seed),
                              phone.shape[0])
            out = functional_call(
                self.model_g, self._cast(self.model_g, True),
                (phone, batch["phone_lengths"], batch["pitch"], batch["pitchf"],
                 spec, batch["spec_lengths"], batch["sid"]),
                {"ids_slice": ids_slice, "generator": gen})
            y_hat, _, _, y_mask, vae = out
            return tuple(t.float() for t in (y_hat, *vae, y_mask))

        args = (batch["phone"].to(self.dtype), batch["spec"].to(self.dtype))
        if self.cfg.train.use_checkpointing:
            return checkpoint(fwd, *args, use_reentrant=False)
        return fwd(*args)

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 ids_slice: Optional[torch.Tensor] = None,
                 gp_alphas: Optional[Sequence[torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """One update. ``ids_slice`` [B] and ``gp_alphas`` (one [B, 1, 1] per
        discriminator update) are drawn from ``generator`` when None."""
        t, d = self.cfg.train, self.cfg.data
        spec_lengths = batch["spec_lengths"]
        draws = self._draws(generator, spec_lengths.shape[0])
        share = 1.0 / self.world
        if ids_slice is None:
            ids_slice = rand_slice_starts(spec_lengths, self.seg_frames, draws)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator).item())

        self._mark("g_forward")
        outputs = self.g_forward(batch, ids_slice, seed)
        y_hat = outputs[0]
        wave = slice_segments(batch["wave"], ids_slice * d.hop_length, t.segment_size)

        self._mark("d_update")
        y_hat_sg = y_hat.detach()
        for i in range(self.d_updates):
            y_d_r, y_d_g, _, _ = self.d_apply(wave, y_hat_sg)
            if t.use_wgan:
                alpha = None if gp_alphas is None else gp_alphas[i]
                gp = L.gradient_penalty(self.d_apply, wave, y_hat_sg, alpha,
                                        draws, share=share)
                loss_disc = (L.wgan_discriminator_loss(y_d_r, y_d_g) + gp) * share
            else:
                loss_disc = L.discriminator_loss(y_d_r, y_d_g) * share
            grads_d = all_reduce_sum(_grads(loss_disc, self.d_params))
            grad_norm_d = global_norm(grads_d)
            self.opt_d.step(grads_d)

        self._mark("g_update")
        frozen = self.step // self.steps_per_epoch < self.balancer_freeze_epochs
        total, aux = self._g_losses(outputs, wave, batch, ids_slice, frozen, share)
        extra = list(self.balancer.values()) if self.balancer is not None else []
        grads = all_reduce_sum(_grads(total, self.g_params + extra))
        grads_g = grads[:len(self.g_params)]
        grad_norm_g = global_norm(grads_g)
        self.opt_g.step(grads_g)
        if self.balancer is not None:
            self.opt_b.step(grads[len(self.g_params):])
        self.step += 1
        self._mark("end")

        # the losses are this rank's shares: their sums are the global values
        shares = {"loss_disc": loss_disc.detach(), **aux}
        shares = dict(zip(shares, all_reduce_sum(list(shares.values()))))
        std_mel_l1 = shares.pop("std_mel_l1")
        metrics = {"loss_disc": shares.pop("loss_disc"), "grad_norm_d": grad_norm_d,
                   "grad_norm_g": grad_norm_g, **shares,
                   "mel_similarity_pct": torch.clamp(100.0 - std_mel_l1 * 100.0,
                                                     0.0, 100.0)}
        if self.debug_grads:
            metrics.update(self._group_norms("gsub_g", grads_g, self.g_names))
            metrics.update(self._group_norms("gsub_d", grads_d, self.d_names))
        return metrics

    def _g_losses(self, outputs, wave, batch, ids_slice, frozen: bool, share: float):
        t, d = self.cfg.train, self.cfg.data
        y_hat, z, z_p, m_p, logs_p, m_q, logs_q, y_mask = outputs
        _, y_d_g, fmap_r, fmap_g = self.d_apply(wave, y_hat, grad_params=False)
        # the standard mels: the single-scale loss, and the mel similarity
        # metric in both modes
        y_hat_mel = mel_spectrogram(y_hat[..., 0], d.filter_length, d.n_mel_channels,
                                    d.sample_rate, d.hop_length, d.win_length,
                                    d.mel_fmin, d.mel_fmax)
        mel = spec_to_mel(batch["spec"].float(), d.filter_length, d.n_mel_channels,
                          d.sample_rate, d.mel_fmin, d.mel_fmax)
        y_mel = slice_segments(mel, ids_slice, self.seg_frames)
        std_mel_l1 = L.mel_l1_loss(y_mel, y_hat_mel) * share
        if t.use_multiscale_mel:
            raw_mel = L.multiscale_mel_loss(wave[..., 0], y_hat[..., 0],
                                            d.sample_rate) * share
            loss_mel = raw_mel if t.use_balancer else raw_mel * t.c_mel / 3.0
        else:
            raw_mel = std_mel_l1
            loss_mel = raw_mel if t.use_balancer else raw_mel * t.c_mel
        raw_fm = L.feature_loss(fmap_r, fmap_g) * share
        loss_fm = raw_fm if t.use_balancer else raw_fm * t.c_fm
        mask_sum = all_reduce_sum([torch.sum(y_mask)])[0]
        raw_kl = L.kl_loss(z_p, logs_q, m_p, logs_p, y_mask, mask_sum)
        loss_kl = raw_kl if t.use_balancer else raw_kl * t.c_kl
        loss_gen = (L.wgan_generator_loss(y_d_g) if t.use_wgan
                    else L.generator_loss(y_d_g)) * share
        if t.use_balancer:
            total = balancer_total(self.balancer, {"adv": loss_gen, "mel": loss_mel,
                                                   "fm": loss_fm, "kl": loss_kl},
                                   frozen, share)
        else:
            total = loss_gen + loss_fm + loss_mel + loss_kl
        aux = {"loss_gen": loss_gen, "loss_fm": loss_fm, "loss_mel": loss_mel,
               "loss_kl": loss_kl, "loss_gen_all": total, "std_mel_l1": std_mel_l1}
        return total, {k: v.detach() for k, v in aux.items()}

    def _group_norms(self, prefix: str, grads, names) -> Dict[str, torch.Tensor]:
        groups: Dict[str, List[torch.Tensor]] = {}
        if prefix == "gsub_d":
            keys = [[self.model_d.group_of(n)] for n in names]
        else:
            nk = getattr(getattr(self.model_g, "dec", None), "num_kernels", 1)
            keys = [grad_group(n, nk) for n in names]
        for g, ks in zip(grads, keys):
            for k in ks:
                groups.setdefault(k, []).append(g)
        return {f"{prefix}/{k}": global_norm(v) for k, v in groups.items()}

