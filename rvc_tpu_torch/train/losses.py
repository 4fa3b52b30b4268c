"""GAN training losses (port of ``rvc_tpu/train/losses.py``).

LSGAN and WGAN discriminator and generator losses, feature matching, KL,
the WGAN-GP penalty, the multi-scale mel loss and the validation metrics
(mel L1, multi-resolution STFT, SI-SDR, mel similarity). Every loss is
computed in float32, whatever the dtype of its inputs, as the reference
computes its losses outside the autocast region. Tensors follow the JAX
package's layouts ([B, T, C] latents, [B, T] waves).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..models.commons import draw
from ..ops.stft import mel_basis, multiscale_mel_window, stft_magnitude

Fmaps = List[List[torch.Tensor]]


def discriminator_loss(real_outputs: Sequence[torch.Tensor],
                       fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN discriminator loss summed over sub-discriminators."""
    loss = 0.0
    for dr, dg in zip(real_outputs, fake_outputs):
        loss = loss + torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
    return loss


def generator_loss(fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN generator loss."""
    loss = 0.0
    for dg in fake_outputs:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss


def wgan_discriminator_loss(real_outputs: Sequence[torch.Tensor],
                            fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """WGAN critic loss."""
    return sum(torch.mean(dg.float()) - torch.mean(dr.float())
               for dg, dr in zip(fake_outputs, real_outputs))


def wgan_generator_loss(fake_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(-torch.mean(dg.float()) for dg in fake_outputs)


def feature_loss(fmap_r: Fmaps, fmap_g: Fmaps) -> torch.Tensor:
    """L1 feature matching over every layer of every sub-discriminator (the
    x2 weight is the caller's)."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss


def feature_loss_masked(fmap_r: Fmaps, fmap_g: Fmaps,
                        silence_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Silence-aware feature matching (reference losses.py:17-47): each
    layer's L1 averaged per sample, the layers averaged, then weighted by a
    [B] voiced mask and normalized by its sum (the plain mean without
    one)."""
    per_layer = []
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            diff = torch.abs(rl.float() - gl.float())
            per_layer.append(diff.reshape(diff.shape[0], -1).mean(dim=1))
    total = torch.stack(per_layer).mean(dim=0)                      # [B]
    if silence_mask is not None:
        mask = silence_mask.float()
        return (total * mask).sum() / (mask.sum() + 1e-6)
    return total.mean()


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
            logs_p: torch.Tensor, z_mask: torch.Tensor,
            mask_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL between the posterior sample and the prior; [B, T, C] tensors and
    z_mask [B, T, 1], counted once per frame in the denominator.
    ``mask_sum`` replaces that denominator (a rank passes the sum of the
    masks over every rank, so that the ranks' values add up to the global
    batch's)."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p.float() - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if mask_sum is None
                                     else mask_sum)


def gradient_penalty(disc_apply: Callable, real: torch.Tensor,
                     fake: torch.Tensor, alpha: Optional[torch.Tensor] = None,
                     generator=None, share: float = 1.0) -> torch.Tensor:
    """WGAN-GP unit-gradient penalty on interpolates of real and fake
    [B, T, 1]. ``alpha`` [B, 1, 1] are the interpolation weights, drawn
    uniform from ``generator`` when None. ``disc_apply(real, fake)`` runs
    one doubled batch, so an even batch sends half the interpolates down
    each branch, as the JAX function does. The penalty stays in the graph
    (its gradient reaches D's parameters). ``share`` is this batch's share
    of the global batch's rows: the mean critic is weighted by it, so that
    each row's gradient is the one the global batch's mean gives it."""
    if alpha is None:  # drawn on the generator's device (the host's by default)
        alpha = draw("rand", (real.shape[0], 1, 1), generator,
                     generator.device if generator else None)
    alpha = alpha.to(real.device, real.dtype)
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    b = interp.shape[0]
    if b % 2 == 0:
        outs_r, outs_g, _, _ = disc_apply(interp[: b // 2], interp[b // 2:])
        per = [torch.cat([r.reshape(r.shape[0], -1).float().mean(dim=1),
                          g.reshape(g.shape[0], -1).float().mean(dim=1)])
               for r, g in zip(outs_r, outs_g)]
    else:
        outs, _, _, _ = disc_apply(interp, interp)
        per = [o.reshape(o.shape[0], -1).float().mean(dim=1) for o in outs]
    critic = torch.stack(per).mean() * share
    (grads,) = torch.autograd.grad(critic, interp, create_graph=True)
    grads = grads.reshape(grads.shape[0], -1).float()
    norm = torch.sqrt(torch.sum(grads ** 2, dim=1) + 1e-12)
    return torch.mean((norm - 1.0) ** 2)


MULTISCALE_N_MELS = (5, 10, 20, 40, 80, 160, 320, 480)


def _log10_mel(wav: torch.Tensor, sample_rate: int, n_mels: int, window: int,
               hop: int) -> torch.Tensor:
    mag = stft_magnitude(wav, window, hop, window, center=True)
    mel = mag @ mel_basis(sample_rate, window, n_mels, 0.0, None, wav.device)
    return torch.log10(torch.clamp(mel, min=1e-5))


def multiscale_mel_loss(real: torch.Tensor, fake: torch.Tensor, sample_rate: int,
                        n_mels: Sequence[int] = MULTISCALE_N_MELS) -> torch.Tensor:
    """Sum over 8 resolutions of the L1 distance of log10 mels; real and
    fake [B, T], hop sr / 100."""
    real, fake = real.float(), fake.float()
    hop = sample_rate // 100
    loss = 0.0
    for m in n_mels:
        window = multiscale_mel_window(m, sample_rate)
        loss = loss + torch.mean(torch.abs(
            _log10_mel(real, sample_rate, m, window, hop)
            - _log10_mel(fake, sample_rate, m, window, hop)))
    return loss


def mel_l1_loss(mel_real: torch.Tensor, mel_fake: torch.Tensor) -> torch.Tensor:
    """L1 on precomputed log mels (the single-scale path)."""
    return torch.mean(torch.abs(mel_real.float() - mel_fake.float()))


def multi_resolution_stft_loss(real: torch.Tensor, fake: torch.Tensor,
                               fft_sizes: Sequence[int] = (1024, 2048, 512),
                               hop_sizes: Sequence[int] = (120, 240, 50),
                               win_lengths: Sequence[int] = (600, 1200, 240)
                               ) -> torch.Tensor:
    """Spectral convergence + log-magnitude L1, averaged over resolutions
    (the validation metric)."""
    real, fake = real.float(), fake.float()
    total = 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        mr = stft_magnitude(real, n_fft, hop, win, center=True)
        mf = stft_magnitude(fake, n_fft, hop, win, center=True)
        sc = torch.linalg.norm(mr - mf) / (torch.linalg.norm(mr) + 1e-8)
        mag = torch.mean(torch.abs(torch.log(mr + 1e-7) - torch.log(mf + 1e-7)))
        total = total + sc + mag
    return total / len(fft_sizes)


def si_sdr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR in dB, batch-meaned."""
    est, ref = est.float(), ref.float()
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    proj = (torch.sum(est * ref, dim=-1, keepdim=True) + eps) * ref / (
        torch.sum(ref ** 2, dim=-1, keepdim=True) + eps)
    noise = est - proj
    ratio = (torch.sum(proj ** 2, dim=-1) + eps) / (torch.sum(noise ** 2, dim=-1) + eps)
    return torch.mean(10.0 * torch.log10(ratio))


def mel_similarity_percent(mel_real: torch.Tensor,
                           mel_fake: torch.Tensor) -> torch.Tensor:
    """Mel-spectrogram similarity %, 100 - L1 * 100 clamped to [0, 100]."""
    t = min(mel_real.shape[1], mel_fake.shape[1])
    diff = torch.abs(mel_real[:, :t] - mel_fake[:, :t]).mean()
    return torch.clamp(100.0 - diff * 100.0, 0.0, 100.0)
