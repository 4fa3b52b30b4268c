"""Hyperparameter presets for the three supported sample rates.

A copy of ``rvc_tpu/configs/config.py``'s data, model and training sections
(the port imports nothing of the JAX package): frozen dataclasses, one
preset per sample rate, field overrides through ``get_config``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

SAMPLE_RATES = (32000, 40000, 48000)


@dataclass(frozen=True)
class DataConfig:
    sample_rate: int = 48000
    filter_length: int = 2048
    hop_length: int = 480
    win_length: int = 2048
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    max_wav_value: float = 32768.0

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    text_enc_hidden_dim: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.0
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (12, 10, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (24, 20, 4, 4)
    gin_channels: int = 256
    spk_embed_dim: int = 109
    use_spectral_norm: bool = False
    vocoder: str = "HiFi-GAN"
    use_f0: bool = True


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    bf16_run: bool = True
    lr_decay: float = 0.999875
    segment_size: int = 17280          # samples of raw audio per training slice
    c_mel: float = 45.0
    c_kl: float = 1.0
    c_fm: float = 2.0
    batch_size: int = 8
    optimizer: str = "adamw"           # "adamw" | "radam" | "ranger21"
    double_d_update: bool = False
    use_multiscale_mel: bool = True
    use_wgan: bool = False
    use_balancer: bool = False
    warmup_epochs: int = 0
    use_checkpointing: bool = False    # recompute the generator forward (memory)


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def sample_rate(self) -> int:
        return self.data.sample_rate

    @property
    def upsample_factor(self) -> int:
        out = 1
        for r in self.model.upsample_rates:
            out *= r
        return out


_PRESETS = {
    32000: ExperimentConfig(
        data=DataConfig(sample_rate=32000, filter_length=1024, hop_length=320,
                        win_length=1024, n_mel_channels=80),
        model=ModelConfig(upsample_rates=(10, 8, 2, 2),
                          upsample_kernel_sizes=(20, 16, 4, 4)),
    ),
    40000: ExperimentConfig(
        data=DataConfig(sample_rate=40000, filter_length=2048, hop_length=400,
                        win_length=2048, n_mel_channels=125),
        model=ModelConfig(upsample_rates=(10, 10, 2, 2),
                          upsample_kernel_sizes=(16, 16, 4, 4)),
    ),
    48000: ExperimentConfig(
        data=DataConfig(sample_rate=48000, filter_length=2048, hop_length=480,
                        win_length=2048, n_mel_channels=128),
        model=ModelConfig(upsample_rates=(12, 10, 2, 2),
                          upsample_kernel_sizes=(24, 20, 4, 4)),
    ),
}


def get_config(sample_rate: int, vocoder: str = "HiFi-GAN",
               use_f0: bool = True, **overrides) -> ExperimentConfig:
    """Return the preset for a sample rate with optional field overrides."""
    if sample_rate not in _PRESETS:
        raise ValueError(
            f"unsupported sample_rate {sample_rate}; expected one of "
            f"{SAMPLE_RATES}")
    cfg = _PRESETS[sample_rate]
    model = dataclasses.replace(cfg.model, vocoder=vocoder, use_f0=use_f0)
    cfg = dataclasses.replace(cfg, model=model)
    for section_name in ("data", "model", "train"):
        section = getattr(cfg, section_name)
        keys = {f.name for f in dataclasses.fields(section)}
        upd = {k: v for k, v in overrides.items() if k in keys}
        if upd:
            cfg = dataclasses.replace(
                cfg, **{section_name: dataclasses.replace(section, **upd)})
    return cfg
