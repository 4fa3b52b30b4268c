"""The port's training step against the JAX package's ``make_train_step``
on the CPU, on a tiny 48 kHz model (the widths of
``tests/test_train_step_options.py``; segment 2304 samples so the
multi-scale mel loss has room for its 4096-sample window).

Both take one step from the same weights (flax weights from a numpy seed,
carried across by ``convert``), the same batch and the same latent slice
starts (drawn as the JAX step draws them, given to the port explicitly),
with ``zero_noise``. The JAX step is compiled once per dtype, in a
module-scoped fixture; the step's options are held to the JAX loss
functions run eagerly on the port's own tensors.

Tolerances, float32: losses and gradient norms to 1e-4 relative; updated
parameters to 1e-6 absolute in all but 5e-4 of the elements, and to 2 lr
in those (a first Adam step moves each by lr * g / (|g| + eps): where the
true gradient vanishes, as for the attention key bias, which the softmax
ignores, rounding noise decides the sign).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert

B, T, HOP, SEG = 2, 40, 64, 36
LR = 1e-4
TINY_MODEL = dict(inter_channels=8, hidden_channels=8, filter_channels=16,
                  n_heads=2, n_layers=1, upsample_initial_channel=16,
                  gin_channels=8, spk_embed_dim=4, resblock_kernel_sizes=(3,),
                  resblock_dilation_sizes=((1, 3),), upsample_rates=(8, 8),
                  upsample_kernel_sizes=(16, 16))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for the module's tests: the suite runs several
    workers on the machine's cores, and more threads a worker only contend
    (the training files take about a third of the time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_cfg(get_config, **train):
    cfg = get_config(48000)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, filter_length=256, hop_length=HOP,
                                 win_length=256),
        model=dataclasses.replace(cfg.model, **TINY_MODEL),
        train=dataclasses.replace(cfg.train, segment_size=SEG * HOP, **train))


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(T * HOP) / 48000
    wave = 0.3 * np.sin(2 * np.pi * 220 * tt)[None, :, None] + 0.05 * rng.normal(
        size=(B, T * HOP, 1))
    return {"phone": rng.normal(size=(B, T, 768)).astype(np.float32),
            "phone_lengths": np.array([T, T - 2], np.int32),
            "pitch": rng.integers(1, 255, size=(B, T)).astype(np.int32),
            "pitchf": (150 + 100 * rng.random((B, T))).astype(np.float32),
            "spec": np.abs(rng.normal(size=(B, T, 129))).astype(np.float32),
            "spec_lengths": np.array([T, T - 2], np.int32),
            "wave": wave.astype(np.float32),
            "sid": np.array([0, 3], np.int32)}


def random_params(init_fn, *args, seed=0, scale=0.1):
    """Seeded normal weights of the shapes ``init_fn`` creates, weight-norm
    gains near 1."""
    shapes = jax.eval_shape(init_fn, *args)
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = [((1.0 + 0.1 * rng.normal(size=s.shape)) if "'g'" in jax.tree_util.keystr(p[-1:])
               else scale * rng.normal(size=s.shape)).astype(np.float32) for p, s in flat]
    return jax.tree_util.tree_unflatten(tree, leaves)


def jax_models(cfg):
    from rvc_tpu.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu.models.synthesizer import Synthesizer

    model_g = dataclasses.replace(Synthesizer.from_config(cfg), posterior_layers=2,
                                  flow_layers=1, zero_noise=True)
    return model_g, MultiPeriodDiscriminator(periods=(2,))


def jax_params(cfg, batch):
    model_g, model_d = jax_models(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pg = random_params(model_g.init, {"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)},
                       jb["phone"], jb["phone_lengths"], jb["pitch"], jb["pitchf"],
                       jb["spec"], jb["spec_lengths"], jb["sid"], seed=1)["params"]
    w = jb["wave"][:, :cfg.train.segment_size]
    pd = random_params(model_d.init, jax.random.PRNGKey(2), w, w, seed=2)["params"]
    return pg, pd


def jax_ids_slice(rng, batch):
    """The slice starts JAX's step draws from its rng."""
    rng_slice, _, _ = jax.random.split(rng, 3)
    u = jax.random.uniform(rng_slice, (B,))
    ids_max = np.maximum(batch["spec_lengths"] - SEG + 1, 1).astype(np.float32)
    return np.asarray((u * ids_max).astype(jnp.int32))


def run_jax_step(bf16: bool):
    """One compiled JAX step: (metrics, updated G and D as port
    state_dicts, the slice starts it drew)."""
    from rvc_tpu.configs import get_config
    from rvc_tpu.train.optimizers import make_optimizer
    from rvc_tpu.train.step import TrainState, make_train_step

    cfg = make_cfg(get_config, bf16_run=bf16)
    batch = make_batch()
    pg, pd = jax_params(cfg, batch)
    model_g, model_d = jax_models(cfg)
    tx_g, tx_d = make_optimizer("adamw", LR), make_optimizer("adamw", LR)
    state = TrainState(step=jnp.zeros([], jnp.int32), params_g=pg, params_d=pd,
                       balancer=None, opt_g=tx_g.init(pg), opt_d=tx_d.init(pd))
    step = jax.jit(make_train_step(cfg, model_g, model_d, tx_g, tx_d, 10,
                                   debug_grads=True))
    rng = jax.random.PRNGKey(7)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return ({k: float(v) for k, v in metrics.items()},
            convert.synthesizer_state_dict(to_np(new.params_g), posterior=True),
            convert.mpd_state_dict(to_np(new.params_d)), jax_ids_slice(rng, batch))


def port_pair(cfg_over=None, bf16=False):
    """The port's models carrying the same seeded weights, and its step."""
    from rvc_tpu.configs import get_config as jax_get_config
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.train.optimizers import module_optimizer
    from rvc_tpu_torch.train.step import TrainStep

    over = dict(cfg_over or {}, bf16_run=bf16)
    batch = make_batch()
    pg, pd = jax_params(make_cfg(jax_get_config, **over), batch)
    cfg = make_cfg(get_config, **over)
    g = Synthesizer.from_config(cfg, device="cpu", train=True, posterior_layers=2,
                                flow_layers=1, zero_noise=True)
    convert.load_into(g, convert.synthesizer_state_dict(jax.tree.map(np.asarray, pg),
                                                        posterior=True))
    d = MultiPeriodDiscriminator(periods=(2,))
    convert.load_into(d, convert.mpd_state_dict(jax.tree.map(np.asarray, pd)))
    step = TrainStep(cfg, g, d, module_optimizer("adamw", g, LR),
                     module_optimizer("adamw", d, LR), 10, debug_grads=True)
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    return cfg, step, tb, batch, pd


def _close_params(ref_sd, module, frac=5e-4):
    got = module.state_dict()
    assert got.keys() == ref_sd.keys()
    bad = total = 0
    for k, ref in ref_sd.items():
        diff = (got[k].detach().float() - ref.float()).abs()
        assert float(diff.max()) <= 2 * LR + 1e-6, k
        bad += int((diff > 1e-6).sum())
        total += diff.numel()
    assert bad <= frac * total, (bad, total)


def _close_metrics(ref, got, rel):
    for k, v in ref.items():
        g = float(got[k])
        assert abs(g - v) <= rel * max(abs(v), 1e-3), (k, v, g)


@pytest.fixture(scope="module")
def fp32_step():
    return run_jax_step(bf16=False)


def test_fp32_step_matches_jax(fp32_step):
    """Losses, gradient norms (whole and per top-level module) and the
    updated G and D of one float32 step."""
    metrics, ref_g, ref_d, ids = fp32_step
    _, step, tb, _, _ = port_pair()
    got = step(tb, ids_slice=torch.from_numpy(ids))
    ref_keys = set(metrics)
    assert ref_keys <= set(got), ref_keys - set(got)
    _close_metrics(metrics, got, 1e-4)
    _close_params(ref_g, step.model_g)
    _close_params(ref_d, step.model_d)


def test_fp32_step_reaches_every_module(fp32_step):
    """Each top-level module of G, each decoder part and each
    sub-discriminator gets a finite, nonzero gradient."""
    _, step, tb, _, _ = port_pair()
    got = step(tb, ids_slice=torch.from_numpy(fp32_step[3]))
    groups = {k: float(v) for k, v in got.items() if k.startswith("gsub_")}
    for name in ("enc_p", "enc_q", "flow", "emb_g", "dec", "dec.conv_pre", "dec.ups",
                 "dec.noise_convs", "dec.resblocks.stage0", "dec.resblocks.stage1",
                 "dec.conv_post", "dec.m_source"):
        assert 0 < groups[f"gsub_g/{name}"] < float("inf"), name
    for name in ("disc_s", "disc_p2"):
        assert 0 < groups[f"gsub_d/{name}"] < float("inf"), name


# -- the step's options, held to the JAX loss functions run eagerly ------------

def _jax_g_losses(cfg, pd_new, outputs, wave, batch, ids, balancer=None, frozen=True):
    """The JAX step's generator losses (``g_loss_fn``) on the port's G
    outputs and its updated D, eagerly."""
    from rvc_tpu.models.commons import slice_segments
    from rvc_tpu.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu.ops.stft import mel_spectrogram, spec_to_mel
    from rvc_tpu.train import losses as JL
    from rvc_tpu.train.step import balancer_total

    t, d = cfg.train, cfg.data
    y_hat, z, z_p, m_p, logs_p, m_q, logs_q, y_mask = [jnp.asarray(o) for o in outputs]
    wave = jnp.asarray(wave)
    _, y_d_g, fmap_r, fmap_g = MultiPeriodDiscriminator(periods=(2,)).apply(
        {"params": pd_new}, wave, y_hat)
    y_hat_mel = mel_spectrogram(y_hat[..., 0], d.filter_length, d.n_mel_channels,
                                d.sample_rate, d.hop_length, d.win_length)
    mel = spec_to_mel(jnp.asarray(batch["spec"]), d.filter_length, d.n_mel_channels,
                      d.sample_rate)
    std = JL.mel_l1_loss(slice_segments(mel, jnp.asarray(ids), SEG), y_hat_mel)
    if t.use_multiscale_mel:
        raw_mel = JL.multiscale_mel_loss(wave[..., 0], y_hat[..., 0], d.sample_rate)
        loss_mel = raw_mel if t.use_balancer else raw_mel * t.c_mel / 3.0
    else:
        loss_mel = std if t.use_balancer else std * t.c_mel
    scale = (lambda x, c: x) if t.use_balancer else (lambda x, c: x * c)
    out = {"loss_mel": loss_mel,
           "loss_fm": scale(JL.feature_loss(fmap_r, fmap_g), t.c_fm),
           "loss_kl": scale(JL.kl_loss(z_p, logs_q, m_p, logs_p, y_mask), t.c_kl),
           "loss_gen": (JL.wgan_generator_loss(y_d_g) if t.use_wgan
                        else JL.generator_loss(y_d_g))}
    if t.use_balancer:
        out["loss_gen_all"] = balancer_total(
            {k: jnp.asarray(v) for k, v in balancer.items()},
            {"adv": out["loss_gen"], "mel": out["loss_mel"], "fm": out["loss_fm"],
             "kl": out["loss_kl"]}, frozen)
    else:
        out["loss_gen_all"] = sum(out.values())
    out["mel_similarity_pct"] = jnp.clip(100.0 - std * 100.0, 0.0, 100.0)
    return {k: float(v) for k, v in out.items()}


OPTIONS = {
    "single_scale_mel": dict(use_multiscale_mel=False),
    "balancer": dict(use_balancer=True),
    "wgan_gp": dict(use_wgan=True),
    "double_d": dict(double_d_update=True),
    "checkpointing": dict(use_checkpointing=True),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_step_option_matches_jax_losses(option):
    """The port's step with one option: its generator losses equal the JAX
    step's loss functions on the same G outputs and the D the step left; its
    discriminator loss equals JAX's on the D it started from (WGAN-GP with
    the interpolation weights given to both); the balancer's log-sigmas stay
    at their start while frozen."""
    from rvc_tpu.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu.train import losses as JL
    from rvc_tpu.utils.checkpoints import convert_torch_mpd
    from rvc_tpu_torch.models.commons import slice_segments
    from rvc_tpu_torch.train.step import BALANCER_INIT

    cfg, step, tb, batch, pd0 = port_pair(OPTIONS[option])
    ids = torch.tensor([1, 3], dtype=torch.int32)
    # the interpolation weights JAX's gradient_penalty draws from these keys
    keys = [jax.random.PRNGKey(5), jax.random.PRNGKey(6)]
    alphas = [torch.from_numpy(np.array(jax.random.uniform(k, (B, 1, 1), jnp.float32)))
              for k in keys]
    with torch.no_grad():
        outputs = [o.numpy() for o in step.g_forward(tb, ids, seed=0)]
    wave = slice_segments(tb["wave"], ids * HOP, SEG * HOP).numpy()
    got = {k: float(v) for k, v in step(tb, ids_slice=ids, gp_alphas=alphas).items()}
    sd_d = {k: v.numpy() for k, v in step.model_d.state_dict().items()}
    pd_new = convert_torch_mpd(sd_d, periods=(2,))
    ref = _jax_g_losses(cfg, pd_new, outputs, wave, batch, ids.numpy(),
                        balancer=BALANCER_INIT, frozen=True)
    _close_metrics(ref, got, 1e-4)
    if cfg.train.double_d_update:
        assert step.opt_d.count == 2
    else:
        mpd = MultiPeriodDiscriminator(periods=(2,))
        apply = lambda p, r, f: mpd.apply({"params": p}, r, f)
        y, y_hat = jnp.asarray(wave), jnp.asarray(outputs[0])
        y_d_r, y_d_g, _, _ = apply(pd0, y, y_hat)
        if cfg.train.use_wgan:
            ref_disc = (JL.wgan_discriminator_loss(y_d_r, y_d_g)
                        + JL.gradient_penalty(keys[0], apply, pd0, y, y_hat))
        else:
            ref_disc = JL.discriminator_loss(y_d_r, y_d_g)
        ref_disc = float(ref_disc)
        assert abs(got["loss_disc"] - ref_disc) <= 1e-4 * max(abs(ref_disc), 1e-3)
    if cfg.train.use_balancer:
        for k, v in step.balancer.items():
            assert float(v) == pytest.approx(BALANCER_INIT[k], abs=1e-6)


def test_checkpointing_changes_no_number():
    """Recomputing the generator in the backward gives the same step."""
    ids = torch.tensor([2, 0], dtype=torch.int32)
    results = []
    for over in ({}, {"use_checkpointing": True}):
        _, step, tb, _, _ = port_pair(over)
        m = step(tb, ids_slice=ids)
        results.append(({k: float(v) for k, v in m.items()}, step.model_g.state_dict()))
    for k, v in results[0][0].items():
        assert results[1][0][k] == pytest.approx(v, rel=1e-5), k
    for k, v in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], v, rtol=0, atol=1e-7)


def test_balancer_trains_after_its_freeze():
    """Past the frozen epochs the balancer's log-sigmas get gradients and
    move, through their own Adam on the generator's schedule."""
    from rvc_tpu_torch.train.step import BALANCER_INIT

    _, step, tb, _, _ = port_pair({"use_balancer": True})
    step.step = 3 * step.steps_per_epoch
    step(tb, ids_slice=torch.tensor([0, 1], dtype=torch.int32))
    moved = [abs(float(v) - BALANCER_INIT[k]) for k, v in step.balancer.items()]
    assert all(0 < m <= 2 * LR for m in moved), moved
