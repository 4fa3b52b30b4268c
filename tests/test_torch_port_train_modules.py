"""The port's training modules against the JAX package's, on the CPU in
float32 (``jax_default_matmul_precision="highest"``).

Each test builds the JAX function's inputs (and flax weights) from a numpy
seed, carries the weights across with ``rvc_tpu_torch.convert`` and runs
both. Tolerances: model outputs and losses agree to 1e-4 of their largest
magnitude (the two frameworks sum in other orders); optimizer steps and
schedules to 1e-5 (1e-4 after thousands of epochs, where JAX's float32
power drifts); the kernels' gradients to 1e-5 (plain convolutions on
both sides).
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert

REL_TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))


def _random_params(init_fn, *args, seed=0, scale=0.1):
    """Seeded normal values of the shapes ``init_fn`` would create;
    weight-norm gains ``g`` near 1, so that signals keep their scale."""
    shapes = jax.eval_shape(init_fn, *args)
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = jax.tree_util.keystr(path[-1:])
        if "'g'" in name:
            leaves.append((1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32))
        else:
            leaves.append((scale * rng.normal(size=s.shape)).astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- spectrograms and mels ----------------------------------------------------

def test_spectrogram_and_mels_match_jax():
    from rvc_tpu.ops import stft as jstft
    from rvc_tpu_torch.ops import stft

    rng = np.random.default_rng(0)
    y = (0.3 * rng.normal(size=(2, 4800))).astype(np.float32)
    args = (2048, 480, 2048)
    assert _rel(jstft.spectrogram(jnp.asarray(y), *args),
                stft.spectrogram(_t(y), *args).numpy()) <= REL_TOL
    mel_args = (2048, 128, 48000, 480, 2048, 0.0, None)
    ref = jstft.mel_spectrogram(jnp.asarray(y), *mel_args)
    assert _rel(ref, stft.mel_spectrogram(_t(y), *mel_args).numpy()) <= REL_TOL
    spec = np.abs(rng.normal(size=(2, 10, 1025))).astype(np.float32)
    assert _rel(jstft.spec_to_mel(jnp.asarray(spec), 2048, 128, 48000),
                stft.spec_to_mel(_t(spec), 2048, 128, 48000).numpy()) <= REL_TOL
    ms = stft.MelSpec(48000, 2048, 480, 2048, 128)
    jms = jstft.MelSpec(48000, 2048, 480, 2048, 128)
    assert _rel(jms(jnp.asarray(y)), ms(_t(y)).numpy()) <= REL_TOL
    assert _rel(jms.linear(jnp.asarray(y)), ms.linear(_t(y)).numpy()) <= REL_TOL
    np.testing.assert_array_equal(np.asarray(jstft.frame_signal(jnp.asarray(y), 600, 120)),
                                  stft.frame_signal(_t(y), 600, 120).numpy())
    for m in (5, 10, 20, 40, 80, 160, 320, 480):
        for sr in (32000, 40000, 48000):
            assert stft.multiscale_mel_window(m, sr) == jstft.multiscale_mel_window(m, sr)


# -- models -------------------------------------------------------------------

TINY = dict(inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
            n_layers=2, kernel_size=3, resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(8, 4, 2),
            upsample_initial_channel=32, upsample_kernel_sizes=(16, 8, 4),
            spk_embed_dim=4, gin_channels=8, sr=32000)
SPEC, SEG, T = 33, 8, 30


@pytest.fixture(scope="module")
def synth_pair():
    """A tiny flax Synthesizer with seeded weights and the port's training
    Synthesizer carrying them (posterior encoder included)."""
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    fm = FlaxSynth(spec_channels=SPEC, segment_size=SEG, posterior_layers=3,
                   flow_layers=2, zero_noise=True, text_enc_hidden_dim=768, **TINY)
    rng = np.random.default_rng(0)
    params = _random_params(
        fm.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(rng.normal(size=(1, 12, 768)), jnp.float32),
        jnp.asarray([12], jnp.int32), jnp.full((1, 12), 100, jnp.int32),
        jnp.full((1, 12), 220.0, jnp.float32), jnp.zeros((1, 12, SPEC)),
        jnp.asarray([12], jnp.int32), jnp.zeros((1,), jnp.int32), seed=10)["params"]
    tm = Synthesizer(flow_layers=2, zero_noise=True, text_enc_hidden_dim=768,
                     posterior=True, spec_channels=SPEC, segment_size=SEG,
                     posterior_layers=3, **TINY)
    convert.load_into(tm, convert.synthesizer_state_dict(params, posterior=True))
    return fm, params, tm


def _train_inputs(seed=1, b=2):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, T - 7][:b], np.int32)
    return dict(
        phone=rng.normal(size=(b, T, 768)).astype(np.float32),
        phone_lengths=lengths,
        pitch=rng.integers(1, 255, size=(b, T)).astype(np.int32),
        pitchf=(100 + 200 * rng.random((b, T))).astype(np.float32),
        spec=np.abs(rng.normal(size=(b, T, SPEC))).astype(np.float32),
        spec_lengths=lengths,
        sid=np.array([1, 3][:b], np.int32),
        ids_slice=np.array([5, 13][:b], np.int32))


def test_posterior_encoder_and_flow_forward_match_flax(synth_pair):
    fm, params, tm = synth_pair
    x = _train_inputs()
    g_ref = fm.apply({"params": params}, jnp.asarray(x["sid"]),
                     method=lambda m, s: m.emb_g(s)[:, None, :])

    def enc_q(m, y, lengths, g):
        return m.enc_q(y, lengths, g=g)

    ref = fm.apply({"params": params}, jnp.asarray(x["spec"]),
                   jnp.asarray(x["spec_lengths"]), g_ref, method=enc_q)
    g = tm.emb_g(_t(x["sid"]).long())[:, :, None]
    out = tm.enc_q(_t(x["spec"]).transpose(1, 2), _t(x["spec_lengths"]), g=g)
    for r, o in zip(ref, out):  # z, m, logs, y_mask
        assert _rel(r, o.detach().transpose(1, 2).numpy()) <= REL_TOL

    def flow(m, z, mask, g):
        return m.flow(z, mask, g=g)

    z_ref = ref[0]
    zp_ref = fm.apply({"params": params}, z_ref, ref[3], g_ref, method=flow)
    zp = tm.flow(_t(z_ref).transpose(1, 2), _t(ref[3]).transpose(1, 2), g=g)
    assert _rel(zp_ref, zp.detach().transpose(1, 2).numpy()) <= REL_TOL
    # reverse undoes forward
    back = tm.flow.reverse(zp, _t(ref[3]).transpose(1, 2), g=g)
    assert _rel(np.asarray(z_ref), back.detach().transpose(1, 2).numpy()) <= 1e-5


def test_synthesizer_training_forward_matches_flax(synth_pair):
    fm, params, tm = synth_pair
    x = _train_inputs()
    names = ("phone", "phone_lengths", "pitch", "pitchf", "spec", "spec_lengths", "sid")
    ref = fm.apply({"params": params}, *[jnp.asarray(x[k]) for k in names],
                   ids_slice=jnp.asarray(x["ids_slice"]),
                   rngs={"noise": jax.random.PRNGKey(0)})
    targs = [_t(x[k]) for k in names]
    targs[2], targs[6] = targs[2].long(), targs[6].long()
    out = tm(*targs, ids_slice=_t(x["ids_slice"]))
    o, ids, x_mask, y_mask, vae = out
    assert o.shape == (2, SEG * 64, 1)
    np.testing.assert_array_equal(np.asarray(ref[1]), ids.numpy())
    for r, got in zip((ref[0], ref[2], ref[3], *ref[4]), (o, x_mask, y_mask, *vae)):
        assert _rel(r, got.detach().numpy()) <= REL_TOL
    # the gradient reaches every parameter of the model
    loss = o.square().mean() + sum(v.square().mean() for v in vae)
    loss.backward()
    dead = [n for n, p in tm.named_parameters() if p.grad is None]
    assert not dead, dead[:5]
    tm.zero_grad()


@pytest.fixture(scope="module")
def mpd_pair():
    from rvc_tpu.models.discriminators import MultiPeriodDiscriminator as FlaxMPD
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    fm = FlaxMPD(periods=(2, 3))
    y = jnp.zeros((1, 512, 1))
    params = _random_params(fm.init, jax.random.PRNGKey(0), y, y, seed=3)["params"]
    tm = MultiPeriodDiscriminator(periods=(2, 3))
    convert.load_into(tm, convert.mpd_state_dict(params))
    return fm, params, tm


def _waves(seed, b=2, t=517):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(b, t, 1))).astype(np.float32) for _ in range(2)]


def test_mpd_logits_and_feature_maps_match_flax(mpd_pair):
    fm, params, tm = mpd_pair
    y, y_hat = _waves(4)
    ref = fm.apply({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
    out = tm(_t(y), _t(y_hat))
    for side in (0, 1):  # logits, real then fake
        for r, o in zip(ref[side], out[side]):
            assert _rel(r, o.detach().numpy()) <= REL_TOL
    for side in (2, 3):  # feature maps: flax NTC / NHWC, the port NCT / NCHW
        for fr, fo in zip(ref[side], out[side]):
            for r, o in zip(fr, fo):
                perm = (0, 2, 1) if o.ndim == 3 else (0, 2, 3, 1)
                assert _rel(r, o.detach().permute(*perm).numpy()) <= REL_TOL


def test_spectral_norm_divides_by_the_largest_singular_value():
    """``spectral_normalize`` reaches sigma_1 where it is separated from
    sigma_2 (the JAX package draws its own start vector: the two packages
    agree to the power iteration's convergence, not bit for bit), and the
    spectral-norm MPD carries the JAX parameters."""
    from rvc_tpu.models.discriminators import MultiPeriodDiscriminator as FlaxMPD
    from rvc_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                     spectral_normalize)

    rng = np.random.default_rng(5)
    u, v = rng.normal(size=(16, 1)), rng.normal(size=(1, 45))
    w = (3.0 * u @ v / np.linalg.norm(u) / np.linalg.norm(v)
         + 0.05 * rng.normal(size=(16, 45))).astype(np.float32)
    wt = _t(w.reshape(16, 3, 15))
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    assert _rel(w.reshape(16, 3, 15) / sigma, spectral_normalize(wt).numpy()) <= 1e-4
    fm = FlaxMPD(periods=(2,), use_spectral_norm=True)
    y = jnp.zeros((1, 256, 1))
    params = _random_params(fm.init, jax.random.PRNGKey(0), y, y, seed=6)["params"]
    tm = MultiPeriodDiscriminator(periods=(2,), use_spectral_norm=True)
    convert.load_into(tm, convert.mpd_state_dict(params))
    out = tm(_t(np.asarray(y)), _t(np.asarray(y)))
    assert all(torch.isfinite(o).all() for o in out[0])


# -- losses -------------------------------------------------------------------

def test_losses_match_jax(mpd_pair):
    from rvc_tpu.train import losses as JL
    from rvc_tpu_torch.train import losses as L

    rng = np.random.default_rng(7)
    outs_r = [rng.normal(size=(2, 17)).astype(np.float32) for _ in range(3)]
    outs_g = [rng.normal(size=(2, 17)).astype(np.float32) for _ in range(3)]
    fm_r = [[rng.normal(size=(2, 5, 4)).astype(np.float32) for _ in range(2)]] * 2
    fm_g = [[rng.normal(size=(2, 5, 4)).astype(np.float32) for _ in range(2)]] * 2
    J = lambda xs: [jnp.asarray(a) for a in xs]
    P = lambda xs: [_t(a) for a in xs]
    pairs = [
        (JL.discriminator_loss(J(outs_r), J(outs_g)), L.discriminator_loss(P(outs_r), P(outs_g))),
        (JL.generator_loss(J(outs_g)), L.generator_loss(P(outs_g))),
        (JL.wgan_discriminator_loss(J(outs_r), J(outs_g)),
         L.wgan_discriminator_loss(P(outs_r), P(outs_g))),
        (JL.wgan_generator_loss(J(outs_g)), L.wgan_generator_loss(P(outs_g))),
        (JL.feature_loss([J(f) for f in fm_r], [J(f) for f in fm_g]),
         L.feature_loss([P(f) for f in fm_r], [P(f) for f in fm_g])),
    ]
    z = [rng.normal(size=(2, 9, 4)).astype(np.float32) for _ in range(4)]
    mask = (np.arange(9)[None, :, None] < np.array([9, 6])[:, None, None]).astype(np.float32)
    pairs.append((JL.kl_loss(*J(z), jnp.asarray(mask)), L.kl_loss(*P(z), _t(mask))))
    real, fake = (0.3 * rng.normal(size=(2, 4800))).astype(np.float32), \
        (0.3 * rng.normal(size=(2, 4800))).astype(np.float32)
    pairs += [
        (JL.multiscale_mel_loss(jnp.asarray(real), jnp.asarray(fake), 48000),
         L.multiscale_mel_loss(_t(real), _t(fake), 48000)),
        (JL.multi_resolution_stft_loss(jnp.asarray(real), jnp.asarray(fake)),
         L.multi_resolution_stft_loss(_t(real), _t(fake))),
        (JL.si_sdr(jnp.asarray(fake), jnp.asarray(real)), L.si_sdr(_t(fake), _t(real))),
    ]
    mels = [rng.normal(size=(2, 11, 8)).astype(np.float32) * 0.01 for _ in range(2)]
    pairs += [(JL.mel_l1_loss(*J(mels)), L.mel_l1_loss(*P(mels))),
              (JL.mel_similarity_percent(*J(mels)), L.mel_similarity_percent(*P(mels)))]
    for i, (ref, got) in enumerate(pairs):
        assert _rel(ref, got.detach().numpy()) <= REL_TOL, i


@pytest.mark.parametrize("b", [2, 3])
def test_gradient_penalty_matches_jax(mpd_pair, b):
    """The WGAN-GP with the interpolation weights JAX draws, given to the
    port explicitly; an even batch sends half the interpolates down each
    branch of the doubled batch, an odd one all of them twice."""
    from rvc_tpu.train import losses as JL
    from rvc_tpu_torch.train import losses as L

    fm, params, tm = mpd_pair
    y, y_hat = _waves(8, b=b, t=260)
    key = jax.random.PRNGKey(3)
    alpha = jax.random.uniform(key, (b, 1, 1), jnp.float32)

    def apply(p, r, f):
        return fm.apply({"params": p}, r, f)

    ref = jax.jit(lambda p, r, f: JL.gradient_penalty(key, apply, p, r, f))(
        params, jnp.asarray(y), jnp.asarray(y_hat))
    got = L.gradient_penalty(tm, _t(y), _t(y_hat), alpha=_t(np.asarray(alpha)))
    assert _rel(ref, got.detach().numpy()) <= REL_TOL
    got.backward()  # the penalty's gradient reaches D's weights
    for conv in tm.discriminators[1].convs:
        assert float(conv.weight_v.grad.abs().sum()) > 0
        assert bool(torch.isfinite(conv.weight_v.grad).all())
    tm.zero_grad()


# -- schedule and optimizers ---------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 3])
def test_epoch_lr_schedule_matches_jax(warmup):
    from rvc_tpu.train.schedules import make_epoch_lr_schedule as jsched
    from rvc_tpu_torch.train.schedules import make_epoch_lr_schedule

    ref, got = jsched(1e-4, 7, warmup), make_epoch_lr_schedule(1e-4, 7, warmup)
    # 1e-4: JAX raises gamma to the epoch in float32 (1e-4 off after 10k epochs)
    for step in list(range(0, 60)) + [700, 7000, 70000]:
        assert abs(float(ref(step)) - got(step)) <= 1e-4 * float(ref(step)), step


def _opt_tree(rng):
    """A tree with a conv, a 2D conv, a dense layer, a weight-norm gain and
    biases, in flax layout; the port's tensors and their layouts."""
    tree = {"conv": rng.normal(size=(5, 4, 6)), "conv2d": rng.normal(size=(3, 1, 4, 6)),
            "dense": rng.normal(size=(6, 3)), "g": rng.normal(size=(6,)),
            "bias": rng.normal(size=(3,))}
    tree = {k: (0.1 * v).astype(np.float32) for k, v in tree.items()}
    layouts = {"conv": (2, 1, 0), "conv2d": (2, 3, 1, 0), "dense": (1, 0),
               "g": "flat", "bias": (0,)}

    def to_torch(k, a):
        a = np.asarray(a)
        if layouts[k] == "flat":
            return _t(a.reshape(-1, 1, 1))
        inv = np.argsort(layouts[k])
        return _t(np.transpose(a, inv))

    def to_flax(k, t):
        a = t.detach().numpy()
        return a.reshape(-1) if layouts[k] == "flat" else np.transpose(a, layouts[k])

    return tree, layouts, to_torch, to_flax


@pytest.mark.parametrize("name", ["adamw", "radam", "ranger21"])
def test_optimizers_match_optax(name):
    """Six steps from the same gradients (lookahead syncs at the fifth);
    some gradients large enough that AGC clips them."""
    import optax

    from rvc_tpu.train.optimizers import make_optimizer as jmake
    from rvc_tpu_torch.train.optimizers import Optimizer

    rng = np.random.default_rng(11)
    tree, layouts, to_torch, to_flax = _opt_tree(rng)
    sched = lambda count: 1e-3 * 0.9 ** (count // 2)
    tx = jmake(name, sched)
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    state = tx.init(jparams)
    keys = sorted(tree)
    tparams = [to_torch(k, tree[k]).clone() for k in keys]
    opt = Optimizer(name, tparams, sched, [layouts[k] for k in keys])
    for step in range(6):
        grads = {k: (rng.normal(size=v.shape) * (0.5 if step % 2 else 1e-4)).astype(np.float32)
                 for k, v in tree.items()}
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step([to_torch(k, grads[k]) for k in keys])
        for k, p in zip(keys, tparams):
            np.testing.assert_allclose(to_flax(k, p), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{name} {k} step {step}")


def test_optimizer_state_round_trips():
    from rvc_tpu_torch.train.optimizers import Optimizer

    p = [torch.ones(3, 2), torch.zeros(4)]
    opt = Optimizer("ranger21", p, 1e-3, [(1, 0), (0,)])
    opt.step([torch.full((3, 2), 0.5), torch.ones(4)])
    p2 = [t.clone() for t in p]
    opt2 = Optimizer("ranger21", p2, 1e-3, [(1, 0), (0,)])
    opt2.load_state_dict(opt.state_dict())
    for o in (opt, opt2):
        o.step([torch.full((3, 2), -0.5), torch.ones(4)])
    for a, b in zip(p, p2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        Optimizer("adamw", p, 1e-3).load_state_dict(opt.state_dict())


# -- the kernels' gradients -----------------------------------------------------

def _chain_np(rng, c, k, dil):
    w = lambda: (rng.normal(size=(k, c, c)) * 0.1).astype(np.float32)
    b = lambda: (rng.normal(size=(c,)) * 0.05).astype(np.float32)
    return [w() for _ in dil], [b() for _ in dil], [w() for _ in dil], [b() for _ in dil]


def _torch_chain(ch):
    k1, b1, k2, b2 = ch
    conv = lambda ws: [_t(w.transpose(2, 1, 0)).requires_grad_() for w in ws]
    bias = lambda bs: [_t(b).requires_grad_() for b in bs]
    return conv(k1), bias(b1), conv(k2), bias(b2)


def _jax_layout_grad(g):
    return g.transpose(2, 1, 0) if g.ndim == 3 else g


def test_mrf_stage_and_resblock_chain_gradients_match_jax_grad():
    """K1's and K2's autograd Functions (on the CPU: plain forward, the
    plain-conv recompute backward) against ``jax.grad`` through the TPU
    kernels ``fused_mrf`` and ``fused_resblock`` in interpret mode, for x
    and every folded weight and bias."""
    from rvc_tpu.ops.resblock_pallas import fused_mrf, fused_resblock
    from rvc_tpu_torch.ops import resblock as rb

    rng = np.random.default_rng(1)
    t, c, ks, dil = 1024, 8, (3, 5), (1, 3)
    x = (rng.normal(size=(2, t, c)) * 0.3).astype(np.float32)
    cot = rng.normal(size=(2, t, c)).astype(np.float32)
    chains = [_chain_np(rng, c, k, dil) for k in ks]
    jchains = [[[jnp.asarray(a) for a in p] for p in ch] for ch in chains]

    def jloss_mrf(x, chs):
        return jnp.sum(fused_mrf(x, chs, ks, dil, tile=512, interpret=True) * cot)

    gx, gch = jax.grad(jloss_mrf, argnums=(0, 1))(jnp.asarray(x), jchains)
    xt = _t(x.transpose(0, 2, 1)).requires_grad_()
    tch = [_torch_chain(ch) for ch in chains]
    rb.reset_launches()
    out = rb.mrf_stage(xt, tch, ks, dil)
    assert out.grad_fn is not None
    (out * _t(cot.transpose(0, 2, 1))).sum().backward()
    assert rb.launches["mrf_stage"] == 0
    assert _rel(np.asarray(gx).transpose(0, 2, 1), xt.grad.numpy()) <= 1e-5
    for jch, pch in zip(gch, tch):
        for jpart, ppart in zip(jch, pch):
            for jg, p in zip(jpart, ppart):
                assert _rel(_jax_layout_grad(np.asarray(jg)), p.grad.numpy()) <= 1e-5

    def jloss_chain(x, k1, b1, k2, b2):
        return jnp.sum(fused_resblock(x, k1, b1, k2, b2, dil, tile=512,
                                      interpret=True) * cot)

    jg = jax.grad(jloss_chain, argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), *jchains[1])
    xt = _t(x.transpose(0, 2, 1)).requires_grad_()
    ch = _torch_chain(chains[1])
    (rb.resblock_chain(xt, *ch, dil) * _t(cot.transpose(0, 2, 1))).sum().backward()
    assert _rel(np.asarray(jg[0]).transpose(0, 2, 1), xt.grad.numpy()) <= 1e-5
    for jpart, ppart in zip(jg[1:], ch):
        for g, p in zip(jpart, ppart):
            assert _rel(_jax_layout_grad(np.asarray(g)), p.grad.numpy()) <= 1e-5


def test_kernel_functions_in_bf16_keep_the_recompute_in_bf16():
    """In bf16 the backward recomputes in bf16, as JAX's ``_direct_chain``
    on bf16 operands: gradients in bf16, within 1e-1 of the f32 gradient's
    largest magnitude (8-bit mantissas; a weight's gradient sums 600 bf16
    products)."""
    from rvc_tpu_torch.ops import resblock as rb

    rng = np.random.default_rng(2)
    c, t, ks, dil = 16, 600, (3, 7), (1, 3)
    x = _t((rng.normal(size=(1, c, t)) * 0.3).astype(np.float32))
    chains = [[[_t(w.transpose(2, 1, 0)) if w.ndim == 3 else _t(w) for w in part]
               for part in _chain_np(rng, c, k, dil)] for k in ks]
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.detach().to(dtype).requires_grad_()
        chd = [[[w.detach().to(dtype).requires_grad_() for w in part] for part in ch]
                for ch in chains]
        rb.mrf_stage(xd, chd, ks, dil).float().square().sum().backward()
        assert xd.grad.dtype == dtype and chd[0][0][0].grad.dtype == dtype
        grads[dtype] = (xd.grad.float(), chd[1][2][1].grad.float())
    for a, b in zip(grads[torch.float32], grads[torch.bfloat16]):
        assert _rel(a.numpy(), b.numpy()) <= 1e-1


def test_weight_cache_keeps_no_graph_alive():
    """The packed-weight cache keys on the folded weights but holds them
    detached: no autograd graph of an earlier step stays reachable."""
    import gc
    import weakref

    from rvc_tpu_torch.utils.weight_cache import WeightCache

    cache = WeightCache()
    v = torch.ones(4, 4, requires_grad=True)
    saved = torch.full((4, 4), 2.0)  # held by w's graph alone once dropped here
    w = v * saved
    ref = weakref.ref(saved)
    cache.get([w], "k", lambda: w.detach() + 1)
    assert all(not t.requires_grad and t.grad_fn is None for t in cache._entry[2])
    del w, saved
    gc.collect()
    assert ref() is None


# -- data and command line ------------------------------------------------------

def _write_dataset(root, n=14, seed=0, hop=480, sr=48000):
    from rvc_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        frames = int(rng.integers(30, 260))
        wav = (0.1 * rng.normal(size=frames * hop)).astype(np.float32)
        p = os.path.join(root, f"{i}.wav")
        write_wav(p, wav, sr, "FLOAT")
        for name, a in (("feats", rng.normal(size=(frames // 2 + 1, 768))),
                        ("f0c", rng.integers(1, 256, size=frames)),
                        ("f0", 100 + 100 * rng.random(frames))):
            np.save(os.path.join(root, f"{i}.{name}.npy"),
                    a.astype(np.float32 if name != "f0c" else np.int64))
        rows.append("|".join([p] + [os.path.join(root, f"{i}.{nm}.npy")
                                    for nm in ("feats", "f0c", "f0")] + [str(i % 2)]))
    with open(os.path.join(root, "filelist.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return os.path.join(root, "filelist.txt")


def test_bucket_batches_match_jax(tmp_path):
    from rvc_tpu.train import data as jdata
    from rvc_tpu_torch.train import data

    fl = _write_dataset(str(tmp_path))
    for mod_a, mod_b in ((jdata, data),):
        rows_a = mod_a.train_val_split(mod_a.parse_filelist(fl), 0.1, seed=3)
        rows_b = mod_b.train_val_split(mod_b.parse_filelist(fl), 0.1, seed=3)
        assert [r.wav_path for r in rows_a[0]] == [r.wav_path for r in rows_b[0]]
        ds_a = mod_a.VCDataset(rows_a[0], 48000, 2048, 480, 2048, cache_spec=False)
        ds_b = mod_b.VCDataset(rows_b[0], 48000, 2048, 480, 2048, cache_spec=False)
        assert ds_a.lengths == ds_b.lengths
        ba, bb = mod_a.BucketBatcher(ds_a, 3), mod_b.BucketBatcher(ds_b, 3)
        assert ba.steps_per_epoch() == bb.steps_per_epoch()
        for epoch in (1, 2):
            plans_a, plans_b = list(ba.epoch_batches(epoch)), list(bb.epoch_batches(epoch))
            assert plans_a == plans_b
            for xa, xb in zip(ba(epoch), bb(epoch)):
                assert xa.keys() == xb.keys()
                for k in xa:
                    np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)


def test_device_data_cache_gives_the_streamed_batches(tmp_path):
    from rvc_tpu_torch.train import data

    fl = _write_dataset(str(tmp_path), n=8, seed=4)
    ds = data.VCDataset(data.parse_filelist(fl), 48000, 2048, 480, 2048)
    batcher = data.BucketBatcher(ds, 2)
    cache = data.DeviceDataCache(ds, batcher, "cpu")
    for (frames, ids), streamed in zip(batcher.epoch_batches(1), batcher(1)):
        got = cache.batch(frames, ids)
        for k, v in streamed.items():
            np.testing.assert_array_equal(v, got[k].numpy(), err_msg=k)


TRAIN_ARGVS = [
    ["train", "--model_name", "m", "--sample_rate", "48000"],
    ["train", "--model_name", "v", "--sample_rate", "40000", "--total_epoch", "7",
     "--batch_size", "4", "--save_every_epoch", "2", "--optimizer", "Ranger21",
     "--use_warmup", "True", "--warmup_duration", "3", "--use_multiscale_mel_loss",
     "False", "--double_d_update", "1", "--use_balancer", "yes",
     "--use_wgan_gp_loss", "true", "--bf16_run", "False", "--use_checkpointing",
     "True", "--pretrained", "False", "--use_custom_lr", "True", "--custom_lr_g",
     "2e-4", "--custom_lr_d", "1e-4", "--gpu", "0", "--use_tf32", "True",
     "--cache_data_in_gpu", "True", "--save_only_latest", "True", "--cleanup", "True"],
]


@pytest.mark.parametrize("argv", TRAIN_ARGVS)
def test_train_flags_parse_as_in_the_jax_cli(argv):
    from rvc_tpu.cli import build_parser as jax_parser
    from rvc_tpu_torch.cli import build_parser

    ref = vars(jax_parser().parse_args(argv))
    got = vars(build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref


def test_train_config_and_trainer_args_follow_the_flags():
    from rvc_tpu_torch.cli import build_parser, train_config, trainer_args

    args = build_parser().parse_args(TRAIN_ARGVS[1])
    cfg, targs = train_config(args), trainer_args(args)
    t = cfg.train
    assert (t.batch_size, t.optimizer, t.use_multiscale_mel, t.double_d_update,
            t.use_balancer, t.use_wgan, t.bf16_run, t.use_checkpointing,
            t.warmup_epochs) == (4, "ranger21", False, True, True, True, False, True, 3)
    assert cfg.data.sample_rate == 40000
    assert targs.exp_dir == os.path.join("logs", "v")
    assert (targs.lr_g, targs.lr_d, targs.device_indices, targs.pretrain_g) == (
        2e-4, 1e-4, (0,), "")


@pytest.mark.parametrize("extra,item", [
    (["--discriminators", "mpd,mrd"], "A.11"), (["--use_orbax", "True"], "will not have orbax"),
    (["--gpu", "0-1"], "A.13"), (["--vocoder", "RefineGAN"], "A.9")])
def test_unported_train_options_raise(tmp_path, monkeypatch, extra, item):
    """Options the port does not serve raise ``NotImplementedError`` naming
    their ROADMAP item. The discriminator zoo (A.11) and the other vocoders
    (A.9), which raised so before they were ported, now build the trainer's
    models (its ``fit`` is stubbed: the filelist is empty). Several ``--gpu``
    indices (A.13, ported) ask the launcher for one rank each: with
    ``--device cpu``, two CPU ranks (the launcher is stubbed here, since a
    spawned rank would not see the stubbed ``fit``;
    ``test_torch_port_parallel.py`` runs the ranks)."""
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.parallel import mesh
    from rvc_tpu_torch.models.custom_discriminators import (
        CombinedDiscriminator, MultiResolutionDiscriminator)
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator
    from rvc_tpu_torch.models.generators.refinegan import RefineGANGenerator
    from rvc_tpu_torch.train.trainer import Trainer

    monkeypatch.chdir(tmp_path)
    os.makedirs(tmp_path / "logs" / "m")
    (tmp_path / "logs" / "m" / "filelist.txt").write_text("")
    argv = ["train", "--model_name", "m", "--sample_rate", "48000",
            "--device", "cpu", *extra]
    if item in ("A.11", "A.9"):
        built = []
        monkeypatch.setattr(Trainer, "fit", lambda self: built.append(self))
        assert cli.main(argv) == 0
        (trainer,) = built
        if item == "A.11":
            d = trainer.model_d
            assert isinstance(d, CombinedDiscriminator)
            assert [type(m) for m in d.discriminators] == [
                MultiPeriodDiscriminator, MultiResolutionDiscriminator]
        else:
            assert isinstance(trainer.model_g.dec, RefineGANGenerator)
        return
    if item == "A.13":
        calls = []
        monkeypatch.setattr(mesh, "launch", lambda fn, devices, backend=None, args=():
                            calls.append((fn, list(devices), args)) or 0)
        assert cli.main(argv) == 0
        ((fn, devices, (args,)),) = calls
        assert (fn, devices, args.gpu, args.device) == (
            cli._train_rank, ["cpu", "cpu"], "0-1", "cpu")
        return
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        cli.main(argv)


def test_trainer_refuses_a_missing_card(tmp_path):
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.train.trainer import Trainer, TrainerArgs

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "filelist.txt").write_text("")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config(48000), TrainerArgs(exp_dir=str(tmp_path)))


def test_pretrained_selector_and_cleanup(tmp_path, monkeypatch):
    from rvc_tpu.cli import cleanup_previous_run as jclean
    from rvc_tpu.cli import pretrained_selector as jsel
    from rvc_tpu_torch.cli import cleanup_previous_run, pretrained_selector

    monkeypatch.chdir(tmp_path)
    assert pretrained_selector("HiFi-GAN", 48000) == jsel("HiFi-GAN", 48000) == ("", "")
    base = tmp_path / "models" / "pretraineds" / "hifi-gan"
    base.mkdir(parents=True)
    for n in ("f0G48k.pth", "f0D48k.pth"):
        (base / n).write_bytes(b"")
    assert pretrained_selector("HiFi-GAN", 48000) == jsel("HiFi-GAN", 48000)
    for clean in (cleanup_previous_run, jclean):
        exp = tmp_path / "logs" / "m"
        exp.mkdir(parents=True, exist_ok=True)
        for n in ("G_1.pth", "D_1.pth", "metrics.jsonl", "filelist.txt", "a.wav"):
            (exp / n).write_text("x")
        assert clean(str(exp)) == 3
        assert sorted(os.listdir(exp)) == ["a.wav", "filelist.txt"]
