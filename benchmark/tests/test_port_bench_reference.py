"""The plain reference against the port at tiny widths on the CPU, both in
float32 on the same seeded weights: the synthesizer (NSF HiFi-GAN and
RefineGAN, noise drawn alike from one generator state), HuBERT, and
RMVPE's mel, salience and decode."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import hubert as ref_hubert
from benchmark.reference import rmvpe as ref_rmvpe
from benchmark.reference import synth as ref_synth
from benchmark.traffic import voice


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("vocoder,sr", [("HiFi-GAN", 48000), ("RefineGAN", 32000)])
def test_synthesizer(vocoder, sr):
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    cfg = get_config(sr, vocoder=vocoder, inter_channels=16, hidden_channels=16,
                     filter_channels=32, n_layers=2, upsample_initial_channel=64,
                     spk_embed_dim=4, gin_channels=8, text_enc_hidden_dim=32)
    model = Synthesizer.from_config(cfg, device="cpu")
    sd = weights.seeded_state(weights.float_shapes(model), 7, "synth", "cpu",
                              cfg.model.upsample_rates)
    model.load_state_dict(sd)
    arch = {**dataclasses.asdict(cfg.model), "n_flows": 4, "flow_wn_layers": 3}
    g = torch.Generator().manual_seed(1)
    t = 40
    phone = torch.randn(1, t, 32, generator=g)
    pitch = torch.randint(1, 255, (1, t), generator=g)
    pitchf = torch.rand(1, t, generator=g) * 200 + 100
    pitchf[:, :8] = 0
    lengths, sid = torch.tensor([t - 3]), torch.tensor([1])
    with torch.no_grad():
        got = model.infer(phone, lengths, pitch, pitchf, sid,
                          generator=torch.Generator().manual_seed(3))[0][..., 0]
    want = ref_synth.infer(sd, phone, lengths, pitch, pitchf, sid,
                           torch.Generator().manual_seed(3), arch, sr)
    assert got.shape == want.shape
    assert rel(got, want) < 1e-5


def test_hubert():
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig

    arch = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)
    model = Hubert.build(HubertConfig(**arch), device="cpu")
    sd = weights.seeded_state(weights.float_shapes(model), 2, "hubert", "cpu")
    model.load_state_dict(sd)
    audio = torch.from_numpy(voice(16000, np.random.default_rng(0),
                                   weights.CALIBRATION_SIGNAL))[None]
    full = dataclasses.asdict(HubertConfig(**arch))
    assert rel(model(audio), ref_hubert.features(sd, audio, full)) < 1e-5


def test_rmvpe_salience_and_decode():
    from rvc_tpu_torch.predictors.rmvpe import E2EModel, decode_salience, rmvpe_mel

    arch = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4, gru_hidden=16)
    model = E2EModel(**arch).eval()
    sd = weights.seeded_state(weights.float_shapes(model), 3, "rmvpe", "cpu")
    audio = torch.from_numpy(voice(32000, np.random.default_rng(1),
                                   weights.CALIBRATION_SIGNAL))[None]
    ref_rmvpe.calibrate(sd, audio, arch)
    model.load_state_dict(sd)
    mel = rmvpe_mel(audio)[:, :192]
    assert rel(mel, ref_rmvpe.log_mel(audio)[:, :192]) < 1e-6
    got = model(mel)
    want = ref_rmvpe.salience(sd, mel, arch)
    assert rel(got, want) < 1e-5
    f0 = decode_salience(got[0])
    assert rel(f0, ref_rmvpe.decode(got[0])) < 1e-6
    # calibrated batch norms keep the DeepUnet's output at unit scale
    assert 0.3 < float(ref_rmvpe.unet(sd, mel[:, None], arch).std()) < 10
