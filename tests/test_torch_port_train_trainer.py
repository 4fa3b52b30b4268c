"""The port's trainer on the CPU: a tiny ``Trainer.fit`` for 2 epochs, then a
resume to epoch 3, on a dataset written from numpy seed 0 in the layout
the JAX package's ``train/data.py`` reads.

Its files are held to the JAX package's: the deployable ``<name>_<e>e.pth``
loads in the port's ``VoiceConverter`` and in JAX's ``load_rvc_pth`` with
the trained weights in fp16; ``G_<e>.pth`` and ``D_<e>.pth`` carry the keys,
shapes and values that JAX's ``export_rvc_g_pth`` and ``export_rvc_d_pth``
write for the same parameters (exactly: both store the float32 tensors).
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

HOP = 64


def tiny_cfg():
    from rvc_tpu_torch.configs import get_config

    cfg = get_config(48000)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, filter_length=256, hop_length=HOP,
                                 win_length=256),
        model=dataclasses.replace(
            cfg.model, inter_channels=8, hidden_channels=8, filter_channels=16,
            n_heads=2, n_layers=1, upsample_initial_channel=16, gin_channels=8,
            spk_embed_dim=4, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),), upsample_rates=(8, 8),
            upsample_kernel_sizes=(16, 16)),
        train=dataclasses.replace(cfg.train, segment_size=HOP * 40, batch_size=2))


def write_dataset(root, n=8, seed=0, sr=48000):
    """Clips of 60-120 frames: float WAV, [T50, 768] features, coarse f0 in
    1..255 and f0 in Hz, one filelist row each."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        frames = int(rng.integers(60, 120))
        tt = np.arange(frames * HOP) / sr
        wav = (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.02 * rng.normal(size=tt.size))
        path = os.path.join(root, f"{i}.wav")
        write_wav(path, wav.astype(np.float32), sr, "FLOAT")
        arrays = {"feats": rng.normal(size=(frames // 2 + 1, 768)).astype(np.float32),
                  "f0c": rng.integers(1, 256, size=frames).astype(np.int64),
                  "f0": (150 + 50 * rng.random(frames)).astype(np.float32)}
        for name, a in arrays.items():
            np.save(os.path.join(root, f"{i}.{name}.npy"), a)
        rows.append("|".join([path] + [os.path.join(root, f"{i}.{nm}.npy")
                                       for nm in arrays] + ["0"]))
    with open(os.path.join(root, "filelist.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def small_mpd(use_spectral_norm=False):
    """The scale discriminator and the period-2 one: the full MPD's D_<e>.pth
    with its optimizer state is 0.9 GB a save."""
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    return MultiPeriodDiscriminator(periods=(2,), use_spectral_norm=use_spectral_norm)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs from scratch, then the same experiment resumed to three."""
    from rvc_tpu_torch.train import trainer as trainer_mod
    from rvc_tpu_torch.train.trainer import Trainer, TrainerArgs

    exp = str(tmp_path_factory.mktemp("exp") / "tiny")
    os.makedirs(exp)
    write_dataset(exp)
    cfg = tiny_cfg()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_mod, "MultiPeriodDiscriminator", small_mpd)
        first = Trainer(cfg, TrainerArgs(exp_dir=exp, total_epochs=2, save_every_epoch=1,
                                         device="cpu", seed=3))
        first.fit()
        saved = {k: v.clone() for k, v in first.model_g.state_dict().items()}
        second = Trainer(cfg, TrainerArgs(exp_dir=exp, total_epochs=3, save_every_epoch=1,
                                          device="cpu", seed=3))
        second.init_state()
        resumed = {"start_epoch": second.start_epoch, "step": second.step,
                   "g": {k: v.clone() for k, v in second.model_g.state_dict().items()},
                   "mu": [t.clone() for t in second.step_fn.opt_g.mu]}
        second.fit()
    return exp, cfg, first, second, saved, resumed


def test_fit_writes_checkpoints_and_metrics(trained):
    exp, _, first, second, _, _ = trained
    names = set(os.listdir(exp))
    for e in (1, 2, 3):
        assert {f"G_{e}.pth", f"D_{e}.pth", f"tiny_{e}e.pth"} <= names
    assert second.step == 3 * first.steps_per_epoch
    recs = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    epochs = [r for r in recs if "epoch/avg/loss_gen_all" in r]
    assert len(epochs) == 3
    for r in epochs:
        assert all(np.isfinite(v) for v in r.values())
    val = [r for r in recs if "validation/loss/mel_l1" in r]
    assert len(val) == 3
    for key in ("validation/loss/mrstft", "validation/score/si_sdr",
                "validation/score/pesq_est"):
        assert all(np.isfinite(r[key]) for r in val), key
    hb = json.load(open(os.path.join(exp, "heartbeat.json")))
    assert (hb["epoch"], hb["step"]) == (3, second.step)


def test_resume_restores_what_was_saved(trained):
    """The resumed run starts at epoch 3, at step 2 x steps per epoch, with
    the saved parameters and optimizer moments."""
    _, _, first, _, saved, resumed = trained
    assert resumed["start_epoch"] == 3
    assert resumed["step"] == 2 * first.steps_per_epoch
    for k, v in saved.items():
        torch.testing.assert_close(resumed["g"][k], v, rtol=0, atol=0)
    for a, b in zip(first.step_fn.opt_g.mu, resumed["mu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_deployable_pth_loads_in_both_packages(trained, tmp_path, monkeypatch):
    """``tiny_3e.pth`` rebuilds the trained model in the port's
    VoiceConverter and in JAX's load_rvc_pth. (Its 64-sample hop makes no
    48 kHz conversion: ``chip_smoke.py`` converts 10 s with a full-width
    model trained on the card.)"""
    from rvc_tpu.utils.checkpoints import load_rvc_pth as jax_load
    from rvc_tpu_torch import convert
    from rvc_tpu_torch.infer.converter import VoiceConverter

    exp, _, _, second, _, _ = trained
    path = os.path.join(exp, "tiny_3e.pth")
    want = {k: v.half().float() for k, v in second.model_g.state_dict().items()
            if not k.startswith("enc_q.")}
    monkeypatch.chdir(tmp_path)  # no staged embedder or RMVPE: seeded random ones
    vc = VoiceConverter(precision="fp32", device="cpu")
    vc.get_vc(path)
    got = vc.pipeline.synthesizer.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    n = 50  # the rebuilt model decodes: finite audio of n frames
    audio, _ = vc.pipeline.synthesizer.infer(
        torch.randn(1, n, 768), torch.tensor([n]), torch.full((1, n), 100),
        torch.full((1, n), 200.0), torch.tensor([0]))
    assert audio.shape == (1, n * HOP, 1) and bool(torch.isfinite(audio).all())

    params, meta = jax_load(path)
    assert meta["sr"] == 48000 and meta["f0"] == 1
    back = convert.synthesizer_state_dict(jax.tree.map(np.asarray, params))
    for k, v in want.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_full_checkpoints_match_the_jax_exporters(trained, tmp_path):
    from rvc_tpu.utils.checkpoints import convert_torch_mpd, convert_torch_synthesizer
    from rvc_tpu.utils.export_torch import export_rvc_d_pth, export_rvc_g_pth

    exp, cfg, _, second, _, _ = trained
    mine_g = torch.load(os.path.join(exp, "G_3.pth"), weights_only=True)
    mine_d = torch.load(os.path.join(exp, "D_3.pth"), weights_only=True)
    sd_g = {k: v.numpy() for k, v in mine_g["model"].items()}
    sd_d = {k: v.numpy() for k, v in mine_d["model"].items()}
    params_g = convert_torch_synthesizer(sd_g, n_ups=2, num_kernels=1)
    params_d = convert_torch_mpd(sd_d, periods=(2,))
    export_rvc_g_pth(params_g, str(tmp_path / "G.pth"), epoch=3,
                     learning_rate=cfg.train.learning_rate)
    export_rvc_d_pth(params_d, str(tmp_path / "D.pth"), epoch=3, periods=(2,),
                     learning_rate=cfg.train.learning_rate)
    for mine, ref_path in ((mine_g, "G.pth"), (mine_d, "D.pth")):
        ref = torch.load(str(tmp_path / ref_path), weights_only=True)
        assert set(ref) <= set(mine)
        assert (mine["iteration"], mine["learning_rate"]) == (
            ref["iteration"], ref["learning_rate"])
        assert mine["model"].keys() == ref["model"].keys()
        for k, v in ref["model"].items():
            assert mine["model"][k].shape == v.shape, k
            torch.testing.assert_close(mine["model"][k], v.float(), rtol=0, atol=0)
    assert mine_g["optimizer"]["name"] == "adamw"
    assert mine_g["optimizer"]["count"] == second.step


def test_train_cli_runs_from_the_experiment_directory(tmp_path, monkeypatch):
    """``cli.main(["train", ...])`` on the CPU, run from the directory
    holding logs/m/filelist.txt, with the tiny configuration in place of the
    48 kHz preset: one epoch writes the experiment's files."""
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.train import trainer as trainer_mod

    exp = tmp_path / "logs" / "m"
    exp.mkdir(parents=True)
    write_dataset(str(exp), n=4, seed=1)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "MultiPeriodDiscriminator", small_mpd)
    monkeypatch.setattr(cli, "train_config", lambda args: dataclasses.replace(
        tiny_cfg(), train=dataclasses.replace(tiny_cfg().train,
                                              use_multiscale_mel=False)))
    assert cli.main(["train", "--model_name", "m", "--sample_rate", "48000",
                     "--total_epoch", "1", "--save_every_epoch", "1",
                     "--pretrained", "False", "--device", "cpu"]) == 0
    assert {"G_1.pth", "D_1.pth", "m_1e.pth"} <= set(os.listdir(exp))
