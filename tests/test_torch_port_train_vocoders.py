"""Training with the MRF HiFi-GAN and RefineGAN decoders and the
discriminator zoo, on the CPU.

- One float32 step of a tiny model with the RefineGAN decoder and the MRD
  against the JAX package's ``make_train_step`` from the same weights,
  batch and slice starts (``zero_noise``; the JAX step is compiled once in
  a module-scoped fixture): losses within 1e-3 relative.
- The ``train`` CLI with ``--vocoder "MRF HiFi-GAN"`` and ``--vocoder
  RefineGAN``, each with a combination of zoo discriminators, at a tiny
  configuration (``get_config`` patched to the widths of
  ``test_torch_port_train_step``): one epoch, a resume to two, and the
  exported deployable ``.pth`` rebuilt by ``build_synthesizer``.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_train_step import LR, jax_ids_slice, make_batch, make_cfg
from test_torch_port_train_trainer import write_dataset
from test_torch_port_vocoders import _random_params

LOSSES = ("loss_disc", "loss_gen", "loss_fm", "loss_mel", "loss_kl", "loss_gen_all",
          "mel_similarity_pct")


def _jax_models(cfg):
    from rvc_tpu.models.custom_discriminators import build_discriminator
    from rvc_tpu.models.synthesizer import Synthesizer

    model_g = dataclasses.replace(Synthesizer.from_config(cfg), posterior_layers=2,
                                  flow_layers=1, zero_noise=True)
    return model_g, build_discriminator(["mrd"], cfg.data.sample_rate)


@pytest.fixture(scope="module")
def jax_refinegan_step():
    """One compiled JAX step: (metrics, G params, D params, slice starts)."""
    from rvc_tpu.configs import get_config
    from rvc_tpu.train.optimizers import make_optimizer
    from rvc_tpu.train.step import TrainState, make_train_step

    cfg = make_cfg(get_config, bf16_run=False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             vocoder="RefineGAN"))
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model_g, model_d = _jax_models(cfg)
    # kernels at std 1/sqrt(fan in): RefineGAN's 512-channel input convs
    # carry no weight norm, and at std 0.1 each stage would amplify sixfold
    # into tanh's saturation, where float32 noise decides the output
    pg = _random_params(jax.eval_shape(
        model_g.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jb["phone"], jb["phone_lengths"], jb["pitch"], jb["pitchf"], jb["spec"],
        jb["spec_lengths"], jb["sid"])["params"], 1)
    w = jb["wave"][:, :cfg.train.segment_size]
    pd = _random_params(jax.eval_shape(model_d.init, jax.random.PRNGKey(2), w, w)["params"], 2)
    tx_g, tx_d = make_optimizer("adamw", LR), make_optimizer("adamw", LR)
    state = TrainState(step=jnp.zeros([], jnp.int32), params_g=pg, params_d=pd,
                       balancer=None, opt_g=tx_g.init(pg), opt_d=tx_d.init(pd))
    step = jax.jit(make_train_step(cfg, model_g, model_d, tx_g, tx_d, 10))
    rng = jax.random.PRNGKey(7)
    _, metrics = step(state, jb, rng)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return ({k: float(v) for k, v in metrics.items()}, to_np(pg), to_np(pd),
            jax_ids_slice(rng, batch))


def test_refinegan_step_with_mrd_matches_jax(jax_refinegan_step):
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.custom_discriminators import build_discriminator
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.train.optimizers import module_optimizer
    from rvc_tpu_torch.train.step import TrainStep

    metrics, pg, pd, ids = jax_refinegan_step
    cfg = make_cfg(get_config, bf16_run=False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             vocoder="RefineGAN"))
    g = Synthesizer.from_config(cfg, device="cpu", train=True, posterior_layers=2,
                                flow_layers=1, zero_noise=True)
    convert.load_into(g, convert.synthesizer_state_dict(pg, posterior=True))
    d = build_discriminator(["mrd"], 48000)
    convert.load_into(d, convert.discriminator_state_dict(pd))
    step = TrainStep(cfg, g, d, module_optimizer("adamw", g, LR),
                     module_optimizer("adamw", d, LR), 10, debug_grads=True)
    got = step({k: torch.from_numpy(v.copy()) for k, v in make_batch().items()},
               ids_slice=torch.from_numpy(ids))
    for k in LOSSES:
        assert abs(float(got[k]) - metrics[k]) <= 1e-3 * max(abs(metrics[k]), 1e-3), (
            k, metrics[k], float(got[k]))
    # every decoder part and every sub-discriminator has a gradient
    groups = {k: float(v) for k, v in got.items() if k.startswith("gsub_")}
    for name in ("dec.pre_conv", "dec.mel_conv", "dec.cond", "dec.m_source",
                 "dec.downsample_blocks", "dec.upsample_conv_blocks.stage0",
                 "dec.upsample_conv_blocks.stage1", "dec.conv_post"):
        assert 0 < groups[f"gsub_g/{name}"] < float("inf"), name
    for name in ("disc_r1024", "disc_r2048", "disc_r512"):
        assert 0 < groups[f"gsub_d/{name}"] < float("inf"), name


def _tiny_get_config(real):
    """``get_config`` at the tiny widths and hop of
    ``test_torch_port_train_step`` (two x8 upsamples), batch 2."""
    def get_config(sample_rate, vocoder="HiFi-GAN", use_f0=True, **over):
        cfg = make_cfg(lambda sr: real(sr, vocoder=vocoder, use_f0=use_f0))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **over))
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=2))
    return get_config


@pytest.mark.parametrize("vocoder,discriminators", [
    ("MRF HiFi-GAN", "mrd,msstft"), ("RefineGAN", "mrd,mssbcqt")])
def test_train_cli_with_vocoder_and_zoo(tmp_path, monkeypatch, vocoder, discriminators):
    """One epoch, a resume to two, the losses finite, and the deployable
    file rebuilt as the vocoder by ``build_synthesizer``."""
    import rvc_tpu_torch.configs as configs
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.models.custom_discriminators import CombinedDiscriminator
    from rvc_tpu_torch.train.trainer import Trainer
    from rvc_tpu_torch.utils.checkpoints import build_synthesizer, load_rvc_pth

    monkeypatch.setattr(configs, "get_config", _tiny_get_config(configs.get_config))
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "logs" / "v"
    os.makedirs(exp)
    write_dataset(str(exp), n=6)
    built = []
    init = Trainer.init_state

    def record(trainer):
        built.append(trainer)
        init(trainer)

    monkeypatch.setattr(Trainer, "init_state", record)
    argv = ["train", "--model_name", "v", "--sample_rate", "48000", "--vocoder", vocoder,
            "--discriminators", discriminators, "--pretrained", "False",
            "--save_every_epoch", "1", "--device", "cpu", "--index_algorithm", "Auto"]
    assert cli.main(argv + ["--total_epoch", "1"]) == 0
    assert cli.main(argv + ["--total_epoch", "2"]) == 0
    first, second = built
    assert isinstance(first.model_d, CombinedDiscriminator)
    assert second.start_epoch == 2 and second.step == 2 * second.steps_per_epoch
    recs = [json.loads(line) for line in open(exp / "metrics.jsonl")]
    epochs = [r for r in recs if "epoch/avg/loss_gen_all" in r]
    assert len(epochs) == 2 and all(np.isfinite(v) for r in epochs for v in r.values())
    model, cfg, use_f0 = build_synthesizer(*load_rvc_pth(str(exp / "v_2e.pth")),
                                           device="cpu")
    assert use_f0 and cfg.model.vocoder == vocoder
    assert type(model.dec) is type(second.model_g.dec)
    want = {k: v.half().float() for k, v in second.model_g.state_dict().items()
            if not k.startswith("enc_q.")}
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
