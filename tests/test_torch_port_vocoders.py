"""The port's MRF HiFi-GAN and RefineGAN decoders, the synthesizer with
every vocoder at every preset rate, and their model files, against the JAX
package on the CPU in float32 (``jax_default_matmul_precision="highest"``,
``zero_noise``).

Flax weights come from a numpy seed (kernels normal with std 1/sqrt(fan
in), weight-norm gains near 1, the rest normal(0, 0.1)) and cross through
``convert.synthesizer_state_dict``. Each JAX function is compiled once.
Tolerances: outputs to 1e-4 of their largest magnitude; gradients, held
to JAX run in float64, to 1e-4 in norm as one vector and each tensor to
1e-3 of its norm plus 1e-6 of the whole's (a leaky ReLU whose input rounds to the other side of 0
changes one element's gradient tenfold); the blocked phase as its test
states.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_train_step import two_threads  # noqa: F401

REL_TOL = 1e-4
VOCODERS = ("HiFi-GAN", "MRF HiFi-GAN", "RefineGAN")
RATES = (32000, 40000, 48000)
# narrow widths; each rate keeps its preset's upsample stack
TINY = dict(inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
            n_layers=2, kernel_size=3, resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)), upsample_initial_channel=32,
            spk_embed_dim=4, gin_channels=8)
FRAMES = 10


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "g":
            leaf = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "kernel":
            leaf = rng.normal(size=s.shape) / np.sqrt(max(np.prod(s.shape[:-1]), 1))
        elif name == "embedding":
            leaf = rng.normal(size=s.shape)
        else:
            leaf = 0.1 * rng.normal(size=s.shape)
        leaves.append(leaf.astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _preset(sr):
    from rvc_tpu_torch.configs import get_config

    m = get_config(sr).model
    return dict(upsample_rates=m.upsample_rates,
                upsample_kernel_sizes=m.upsample_kernel_sizes)


def _inputs(seed=0, b=2, t=FRAMES):
    rng = np.random.default_rng(seed)
    return dict(phone=rng.normal(size=(b, t, 768)).astype(np.float32),
                lengths=np.array([t, t - 3][:b], np.int32),
                pitch=rng.integers(1, 255, size=(b, t)).astype(np.int32),
                pitchf=(120 + 200 * rng.random((b, t))).astype(np.float32),
                sid=np.array([1, 3][:b], np.int32))


# -- the blocked phase ----------------------------------------------------------

def _phase_err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.minimum(d, 1.0 - d).max())


def test_wrapped_phase_cumsum_matches_jax_at_480000_samples():
    """The blocked phase over 10 s at 48 kHz, 9 harmonics. On increments
    that are multiples of 2^-14 every float32 sum is exact in both
    packages, so the blocking, the carry and the wrap must agree to 1e-5
    of a cycle (here: exactly). On realistic increments the two packages'
    float32 sums part by up to 1.6e-4 of a cycle (JAX's own error against
    the exact float64 phase is 1.5e-4, the port's 5e-5), so there the port
    is held to the exact phase within 1e-4."""
    from rvc_tpu.models.generators.sine import wrapped_phase_cumsum as jax_phase
    from rvc_tpu_torch.models.generators.sine import wrapped_phase_cumsum

    rng = np.random.default_rng(0)
    f0 = 100.0 + 300.0 * rng.random((2, 480000, 1))
    rad = np.mod(f0 * np.arange(1, 10)[None, None, :] / 48000.0, 1.0)
    dyadic = (np.round(rad * 2 ** 14) / 2 ** 14).astype(np.float32)
    ref = np.asarray(jax.jit(jax_phase)(jnp.asarray(dyadic)))
    got = wrapped_phase_cumsum(torch.from_numpy(dyadic)).numpy()
    assert _phase_err(ref, got) <= 1e-5
    real = rad.astype(np.float32)
    got = wrapped_phase_cumsum(torch.from_numpy(real)).numpy()
    assert got.min() >= 0.0 and got.max() < 1.0
    assert _phase_err(np.mod(np.cumsum(real.astype(np.float64), axis=1), 1.0), got) <= 1e-4


def test_cumsum_sine_draws_from_the_generator():
    """The initial phase per harmonic comes from the caller's generator
    (the fundamental keeps 0), nothing is drawn with ``zero_noise``."""
    from rvc_tpu_torch.models.generators.sine import CumsumSineGenerator

    f0 = torch.full((1, 4800, 1), 220.0)
    gen = CumsumSineGenerator(48000, 2)
    a = gen(f0, torch.Generator().manual_seed(1))[0]
    b = gen(f0, torch.Generator().manual_seed(1))[0]
    c = gen(f0, torch.Generator().manual_seed(2))[0]
    # (allclose: the CPU's vectorized cumsum may round by the storage's
    # alignment)
    assert torch.allclose(a, b, atol=1e-6) and not torch.allclose(a, c, atol=1e-3)
    quiet = CumsumSineGenerator(48000, 2, zero_noise=True)
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    s = quiet(f0, g)[0]
    assert torch.equal(g.get_state(), before)
    # no initial phase: the first sample has advanced by one increment
    first = 0.1 * torch.sin(2 * torch.pi * 220.0 * torch.arange(1, 4) / 48000)
    assert torch.allclose(s[0, 0], first, atol=1e-7)


# -- the decoders on their own ----------------------------------------------------

def _decoder_pair(vocoder, seed=0):
    """(flax decoder, its params, the port's decoder) at small widths: 32
    kHz's upsample stack, 32 initial channels (RefineGAN too)."""
    from rvc_tpu.models.generators.mrf import HiFiGANMRFGenerator as JMRF
    from rvc_tpu.models.generators.refinegan import RefineGANGenerator as JRG
    from rvc_tpu_torch.models.generators.mrf import HiFiGANMRFGenerator
    from rvc_tpu_torch.models.generators.refinegan import RefineGANGenerator

    rates, kernels = (10, 8, 2, 2), (20, 16, 4, 4)
    if vocoder == "MRF HiFi-GAN":
        args = (8, 32, rates, kernels, (3, 5), ((1, 3), (1, 3)), 8, 32000)
        fm, tm = JMRF(*args, zero_noise=True), HiFiGANMRFGenerator(*args, zero_noise=True)
        write = convert._mrf_decoder
    else:
        fm = JRG(sample_rate=32000, upsample_rates=rates, num_mels=8,
                 upsample_initial_channel=32, zero_noise=True)
        tm = RefineGANGenerator(32000, rates, num_mels=8, gin_channels=8,
                                upsample_initial_channel=32, zero_noise=True)
        write = convert._refinegan_decoder
    x = _inputs(seed)
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, FRAMES, 8)), jnp.zeros((2, FRAMES)),
                            jnp.zeros((2, 1, 8)))["params"]
    params = _random_params(shapes, seed + 20)
    sd = {}
    write(sd, jax.tree.map(np.asarray, params))
    convert.load_into(tm, {k[len("dec."):]: v for k, v in sd.items()})
    rng = np.random.default_rng(seed + 1)
    z = rng.normal(size=(2, FRAMES, 8)).astype(np.float32)
    g = rng.normal(size=(2, 1, 8)).astype(np.float32)
    return fm, params, tm, z, x["pitchf"], g


@pytest.mark.parametrize("vocoder", ["MRF HiFi-GAN", "RefineGAN"])
def test_decoder_and_its_gradients_match_jax(vocoder):
    """The decoder's audio against JAX's in float32; the gradient of a
    fixed linear functional of it, with respect to every parameter and the
    latent, against ``jax.grad`` of the same JAX function run in float64
    (``jax.enable_x64``): JAX's float32 gradient is itself 1e-3 to 1e-2
    off in norm here (its sine source's phase sums), the port's 2e-5."""
    fm, params, tm, z, f0, g = _decoder_pair(vocoder)
    cot = np.random.default_rng(9).normal(size=(2, FRAMES * 320, 1)).astype(np.float32)

    def apply(p, zz, ff, gg):
        return fm.apply({"params": p}, zz, ff, gg)

    def loss(p, zz, ff, gg, cc):
        return jnp.sum(apply(p, zz, ff, gg) * cc)

    ref = jax.jit(apply)(params, jnp.asarray(z), jnp.asarray(f0), jnp.asarray(g))
    with jax.enable_x64(True):
        f64 = [jnp.asarray(np.asarray(a), jnp.float64) for a in (z, f0, g, cot)]
        g_params, g_z = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params), *f64)
        g_params, g_z = jax.tree.map(np.asarray, g_params), np.asarray(g_z)
    zt = torch.from_numpy(z).transpose(1, 2).contiguous().requires_grad_()
    out = tm(zt, torch.from_numpy(f0), torch.from_numpy(g).transpose(1, 2))
    assert _rel(ref, out.detach().transpose(1, 2).numpy()) <= REL_TOL
    names = [n for n, _ in tm.named_parameters()]
    wrt = [p for _, p in tm.named_parameters()] + [zt]
    # allow_unused: AdaIN's noise scales take no part without noise
    grads = [torch.zeros_like(w) if gr is None else gr for w, gr in zip(wrt, torch.autograd.grad(
        (out.transpose(1, 2) * torch.from_numpy(cot)).sum(), wrt, allow_unused=True))]
    sd = {}
    (convert._mrf_decoder if vocoder == "MRF HiFi-GAN" else convert._refinegan_decoder)(
        sd, g_params)
    refs = [g_z.transpose(0, 2, 1)] + [sd[f"dec.{n}"].numpy() for n in names]
    gots = [grads[-1].numpy()] + [t.numpy() for t in grads[:-1]]
    whole = np.linalg.norm(np.concatenate([r.ravel() for r in refs]))
    assert _norm_rel(np.concatenate([r.ravel() for r in refs]),
                     np.concatenate([t.ravel() for t in gots])) <= REL_TOL
    # per tensor, beside a floor of 1e-6 of the whole gradient: a 1x1
    # weight-normed conv on one channel (RefineGAN's last source conv) has
    # a direction of one element, whose true gradient is 0
    bad = [n for n, r, t in zip(["latent", *names], refs, gots)
           if np.linalg.norm(r - t) > 1e-3 * np.linalg.norm(r) + 1e-6 * whole]
    assert not bad, bad


# -- the synthesizer: every vocoder at every rate --------------------------------

def _synth_pair(vocoder, sr, seed=0):
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    dims = dict(TINY, **_preset(sr), sr=sr, vocoder=vocoder)
    fm = FlaxSynth(spec_channels=33, segment_size=8, posterior_layers=2, flow_layers=2,
                   zero_noise=True, text_enc_hidden_dim=768, **dims)
    x = _inputs(seed)
    shapes = jax.eval_shape(
        fm.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x["phone"]), jnp.asarray(x["lengths"]), jnp.asarray(x["pitch"]),
        jnp.asarray(x["pitchf"]), jnp.zeros((2, FRAMES, 33)), jnp.asarray(x["lengths"]),
        jnp.asarray(x["sid"]))["params"]
    params = _random_params(shapes, seed + 30)
    tm = Synthesizer(flow_layers=2, zero_noise=True, text_enc_hidden_dim=768, **dims)
    convert.load_into(tm, convert.synthesizer_state_dict(jax.tree.map(np.asarray, params)))
    return fm, params, tm.eval(), x


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("vocoder", VOCODERS)
def test_synthesizer_infer_matches_jax(vocoder, sr):
    """``infer`` without and with ``rate`` (the head-trim keeps the last
    60% of the frames)."""
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth

    fm, params, tm, x = _synth_pair(vocoder, sr)
    args = [jnp.asarray(x[k]) for k in ("phone", "lengths", "pitch", "pitchf", "sid")]

    def run(p, *a):
        return [fm.apply({"params": p}, *a, rate=r, method=FlaxSynth.infer)[0]
                for r in (None, 0.6)]

    refs = jax.jit(run)(params, *args)
    targs = [torch.from_numpy(x[k]) for k in ("phone", "lengths", "pitch", "pitchf", "sid")]
    targs[2], targs[4] = targs[2].long(), targs[4].long()
    hop = int(np.prod(_preset(sr)["upsample_rates"]))
    for ref, rate in zip(refs, (None, 0.6)):
        out, mask = tm.infer(*targs, rate=rate)
        frames = FRAMES - (0 if rate is None else int(FRAMES * (1 - rate)))
        assert out.shape == (2, frames * hop, 1) and mask.shape == (2, frames, 1)
        assert _rel(ref, out.numpy()) <= REL_TOL


def test_every_vocoder_builds_at_every_rate():
    """Full width: every vocoder with pitch at every rate, HiFi-GAN
    without; MRF HiFi-GAN and RefineGAN without pitch raise, as in JAX."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    for sr in RATES:
        for vocoder in VOCODERS:
            m = Synthesizer.from_config(get_config(sr, vocoder=vocoder), device="cpu")
            assert m.vocoder == vocoder
        Synthesizer.from_config(get_config(sr, use_f0=False), device="cpu")
        for vocoder in VOCODERS[1:]:
            with pytest.raises(ValueError, match="requires pitch guidance"):
                Synthesizer.from_config(get_config(sr, vocoder=vocoder, use_f0=False),
                                        device="cpu")


# -- model files ----------------------------------------------------------------

@pytest.mark.parametrize("vocoder", ["MRF HiFi-GAN", "RefineGAN"])
def test_port_written_pth_reads_in_jax_with_the_same_audio(tmp_path, vocoder):
    """A deployable .pth written by the port, read by the JAX package's
    ``load_rvc_pth`` (``convert_torch_synthesizer``) and rebuilt from its
    config list, converts to the port's audio."""
    from rvc_tpu.configs import get_config as jax_config
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu.utils.checkpoints import derive_synth_arch as jax_arch
    from rvc_tpu.utils.checkpoints import load_rvc_pth as jax_load
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.utils.checkpoints import (build_synthesizer, export_rvc_pth,
                                                 load_rvc_pth)

    sr = 40000
    _, _, tm, x = _synth_pair(vocoder, sr, seed=4)
    cfg = get_config(sr, vocoder=vocoder, **{k: v for k, v in TINY.items()})
    path = str(tmp_path / "v.pth")
    export_rvc_pth(tm, path, cfg)
    model, got_cfg, use_f0 = build_synthesizer(*load_rvc_pth(path), device="cpu")
    assert use_f0 and got_cfg.model.vocoder == vocoder
    for m in model.modules():  # no noise anywhere, as in the JAX model below
        if hasattr(m, "zero_noise"):
            m.zero_noise = True

    params, meta = jax_load(path)
    over, flow_layers = jax_arch(params, meta)
    assert meta["vocoder"] == vocoder and flow_layers == 2
    jcfg = jax_config(sr, vocoder=vocoder, **over)
    fm = dataclasses.replace(FlaxSynth.from_config(jcfg), flow_layers=flow_layers,
                             zero_noise=True)
    args = [jnp.asarray(x[k]) for k in ("phone", "lengths", "pitch", "pitchf", "sid")]
    ref = jax.jit(lambda p, *a: fm.apply({"params": p}, *a, method=FlaxSynth.infer)[0])(
        params, *args)
    targs = [torch.from_numpy(x[k]) for k in ("phone", "lengths", "pitch", "pitchf", "sid")]
    targs[2], targs[4] = targs[2].long(), targs[4].long()
    out, _ = model.infer(*targs)
    assert _rel(ref, out.numpy()) <= REL_TOL


@pytest.mark.parametrize("vocoder", ["MRF HiFi-GAN", "RefineGAN"])
def test_full_g_file_without_metadata_is_rebuilt_as_its_vocoder(tmp_path, vocoder, capsys):
    """A full training ``G_`` file carries no metadata: the decoder is
    recognised by its keys (MRF's ``dec.mrfs``, RefineGAN's
    ``dec.mel_conv``) and the rate by MRF's first transposed conv (40 kHz
    here); RefineGAN has none that tells, so a warning is printed and
    48 kHz assumed, as in the JAX package."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.utils.checkpoints import (build_synthesizer, export_full_pth,
                                                 load_rvc_pth)

    sr = 40000 if vocoder == "MRF HiFi-GAN" else 48000
    src = Synthesizer.from_config(get_config(sr, vocoder=vocoder), device="cpu",
                                  train=True)
    with torch.no_grad():
        for i, p in enumerate(src.parameters()):
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.02)
    path = str(tmp_path / "G_7.pth")
    export_full_pth(src, path, epoch=7, learning_rate=1e-4)
    sd, meta = load_rvc_pth(path)
    assert not meta.get("vocoder")
    said = capsys.readouterr().out
    if vocoder == "MRF HiFi-GAN":
        assert meta["sr"] == sr and "inferred sample_rate=40000" in said
    else:
        assert not meta.get("sr") and "WARNING" in said
    model, cfg, use_f0 = build_synthesizer(sd, meta, device="cpu")
    assert cfg.model.vocoder == vocoder and cfg.data.sample_rate == sr
    assert type(model.dec) is type(src.dec)
    want = {k: v for k, v in src.state_dict().items() if not k.startswith("enc_q.")}
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert os.path.getsize(path) > 0
