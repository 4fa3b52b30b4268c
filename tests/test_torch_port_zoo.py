"""The port's discriminator zoo (``rvc_tpu_torch/models/custom_discriminators.py``)
against the JAX package's, on the CPU in float32
(``jax_default_matmul_precision="highest"``).

Each family of the JAX registry, ``mpd_v2`` and one combination get flax
weights from a numpy seed, carried across by ``convert.discriminator_state_dict``;
both run real and fake [2, 4096, 1] waves (one doubled batch of 4 rows).
Each JAX module is compiled once (eager flax compiles op by op, which
costs more at this size). Tolerance: logits and every feature map to 1e-4
of their largest magnitude; gradients (every parameter and the fake wave)
to 1e-4 in norm as one vector, and each tensor to 2e-3 in norm
(``GRAD_TENSOR_TOL``). The spectrally normalized convs (MSD's first scale) get kernels
with a separated top singular value, so that both packages' power
iterations, from their own start vectors, reach it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_train_step import two_threads  # noqa: F401

REL_TOL = 1e-4
# one tensor's gradient in norm: the first convs on the CQT and the STFT
# sum sign-alternating spectra over every frame and bin, and the two
# packages' float32 sums part by up to 1.2e-3 there (3e-5 at the median)
GRAD_TENSOR_TOL = 2e-3
T = 4096


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))


def _norm_rel(a, b):
    """||a - b|| / ||a||: a gradient's error over its size. A leaky ReLU
    whose input the two packages round to opposite sides of 0 changes one
    element's gradient tenfold, so the largest element's error is the
    wrong yardstick for gradients through millions of activations."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _dominant(shape, rng):
    """A conv kernel [..., out] whose [-1, out] matrix has a top singular
    value well apart from the rest."""
    rows, out = int(np.prod(shape[:-1])), shape[-1]
    u, v = rng.normal(size=(rows, 1)), rng.normal(size=(1, out))
    w = 3.0 * u @ v / np.linalg.norm(u) / np.linalg.norm(v)
    return (w + 0.005 * rng.normal(size=(rows, out))).reshape(shape)


def _random_params(model, y, seed):
    """Seeded flax weights of ``model``'s shapes: normal(0, 0.1), weight-norm
    gains near 1, spectral-norm kernels (a kernel without a ``g`` beside
    it, under the spectrally normalized MSD scale) with a dominant
    singular value."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), y, y)["params"]
    rng = np.random.default_rng(seed)
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        keys = [getattr(k, "key", str(k)) for k in path]
        if keys[-1] == "g":
            leaf = 1.0 + 0.1 * rng.standard_normal(s.shape, np.float32)
        elif keys[-1] == "kernel" and "disc_s0" in keys:
            leaf = _dominant(s.shape, rng)
        else:
            leaf = 0.1 * rng.standard_normal(s.shape, np.float32)
        leaves.append(leaf.astype(np.float32))
    return jax.tree_util.tree_unflatten(tree, leaves)


def _waves(seed, b=2, t=T):
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 48000
    base = 0.3 * np.sin(2 * np.pi * 220 * tt)[None, :, None]
    return [(base + 0.1 * rng.normal(size=(b, t, 1))).astype(np.float32)
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _pair(names):
    """(flax module, its seeded params, the port's module carrying them)
    for a tuple of registry names; built once per module run."""
    from rvc_tpu.models import custom_discriminators as J
    from rvc_tpu_torch.models import custom_discriminators as P

    fm = J.build_discriminator(list(names), 48000)
    params = _random_params(fm, jnp.zeros((2, T, 1)), len(",".join(names)))
    tm = P.build_discriminator(list(names), 48000)
    convert.load_into(tm, convert.discriminator_state_dict(
        jax.tree.map(np.asarray, params)))
    return fm, params, tm


def _port_layout(o):
    """A port feature map in the JAX package's layout (NTC / NHWC)."""
    return o.permute(0, 2, 1) if o.ndim == 3 else o.permute(0, 2, 3, 1)


def _compare(ref, out):
    assert [len(r) for r in ref[2]] == [len(o) for o in out[2]]
    for side in (0, 1):
        assert len(ref[side]) == len(out[side])
        for r, o in zip(ref[side], out[side]):
            assert _rel(r, o.detach().numpy()) <= REL_TOL
    for side in (2, 3):
        for fr, fo in zip(ref[side], out[side]):
            for r, o in zip(fr, fo):
                assert _rel(r, _port_layout(o.detach()).numpy()) <= REL_TOL


FAMILIES = ["mpd_v1", "mrd", "msstft", "mssbcqt", "msd", "fregan_mpd", "mmsd",
            "mpd_v2", "mpd,mrd"]


@pytest.mark.parametrize("names", FAMILIES)
def test_discriminator_matches_jax(names):
    """Logits and every feature map of each family, real and fake."""
    fm, params, tm = _pair(tuple(names.split(",")))
    y, y_hat = _waves(1)
    ref = jax.jit(lambda p, a, b: fm.apply({"params": p}, a, b))(
        params, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        out = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
    _compare(ref, out)


def test_registry_builds_every_name_and_combination():
    from rvc_tpu.models import custom_discriminators as J
    from rvc_tpu_torch.models import custom_discriminators as P
    from rvc_tpu_torch.models.discriminators import MultiPeriodDiscriminator

    assert set(P.DISCRIMINATOR_REGISTRY) == set(J.DISCRIMINATOR_REGISTRY)
    for name in P.DISCRIMINATOR_REGISTRY:
        assert not isinstance(P.build_discriminator([name]), P.CombinedDiscriminator)
    assert isinstance(P.build_discriminator(["mpd_v2"]), MultiPeriodDiscriminator)
    both = P.build_discriminator(["mpd", "mssbcqt", "msd"], 32000)
    assert isinstance(both, P.CombinedDiscriminator) and len(both.discriminators) == 3
    assert both.discriminators[1].disc_cqt0.sample_rate == 32000
    assert both.group_of("discriminators.2.disc_s1.conv_0.weight_v") == "discriminators_2"
    with pytest.raises(ValueError, match="unknown discriminator"):
        P.build_discriminator(["mpd", "nope"])
    with pytest.raises(ValueError, match="multiple of"):
        P.multirate_cqt(torch.zeros(1, 4096), 48000, 300, 9, 24)


def test_cqt_front_matches_jax():
    """The constant banks and the multirate CQT on their own."""
    from rvc_tpu.models import custom_discriminators as J
    from rvc_tpu_torch.models import custom_discriminators as P

    for args in ((96000, 8372.0, 24, 24), (64000, 4186.0, 48, 48)):
        for a, b in zip(J.cqt_kernels(*args), P.cqt_kernels(*args)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    wav = _waves(2, b=2, t=3000)[0][..., 0]
    np.testing.assert_allclose(np.asarray(J._upsample2(jnp.asarray(wav))),
                               P._upsample2(torch.from_numpy(wav)).numpy(),
                               atol=1e-6)
    ref = J.multirate_cqt(jnp.asarray(wav), 64000, 256, 9, 36)
    got = P.multirate_cqt(torch.from_numpy(wav), 64000, 256, 9, 36)
    assert _rel(ref, got.permute(0, 2, 3, 1).numpy()) <= REL_TOL


def test_run_discriminators_doubled_matches_jax():
    """Per-member inputs of a doubled batch, split real-first; the MPD's
    scale and period discriminators fed their own inputs."""
    from rvc_tpu.models import discriminators as JD
    from rvc_tpu_torch.models import discriminators as PD

    fm, params, tm = _pair(("mpd_v2",))
    rng = np.random.default_rng(4)
    xs = [(0.3 * rng.normal(size=(4, T - 7 * i, 1))).astype(np.float32) for i in range(3)]
    names = ("disc_s", "disc_p2", "disc_p3")

    def jax_fn(sub, inputs):
        discs = [JD.DiscriminatorS(name="disc_s"), JD.DiscriminatorP(2, name="disc_p2"),
                 JD.DiscriminatorP(3, name="disc_p3")]
        return [d.apply({"params": sub[n]}, x) for d, n, x in zip(discs, names, inputs)]

    outs = jax.jit(jax_fn)({n: params[n] for n in names}, [jnp.asarray(x) for x in xs])
    ref = ([o[0][:2] for o in outs], [o[0][2:] for o in outs],
           [[f[:2] for f in o[1]] for o in outs], [[f[2:] for f in o[1]] for o in outs])
    with torch.no_grad():
        got = PD.run_discriminators_doubled(
            tm.discriminators[:3], [torch.from_numpy(x).transpose(1, 2) for x in xs], 2)
    _compare(ref, got)


@pytest.mark.parametrize("masked", [False, True])
def test_feature_loss_masked_matches_jax(masked):
    from rvc_tpu.train import losses as JL
    from rvc_tpu_torch.train import losses as L

    rng = np.random.default_rng(9)
    fm_r = [[rng.normal(size=(3, 5, 4)).astype(np.float32),
             rng.normal(size=(3, 2, 7, 2)).astype(np.float32)] for _ in range(2)]
    fm_g = [[(a + 0.3 * rng.normal(size=a.shape)).astype(np.float32) for a in f]
            for f in fm_r]
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    ref = JL.feature_loss_masked([[jnp.asarray(a) for a in f] for f in fm_r],
                                 [[jnp.asarray(a) for a in f] for f in fm_g],
                                 None if mask is None else jnp.asarray(mask))
    got = L.feature_loss_masked([[torch.from_numpy(a) for a in f] for f in fm_r],
                                [[torch.from_numpy(a) for a in f] for f in fm_g],
                                None if mask is None else torch.from_numpy(mask))
    assert _rel(ref, got.numpy()) <= REL_TOL


@pytest.mark.parametrize("name", ["mssbcqt", "msstft"])
def test_discriminator_gradients_match_jax(name):
    """d/d(params, fake wave) of the D loss plus the feature loss, against
    ``jax.grad`` through the same weights."""
    from rvc_tpu.train import losses as JL
    from rvc_tpu_torch.train import losses as L

    fm, params, tm = _pair((name,))
    # real and fake apart (a fifth up, louder noise): with two waves alike
    # the real and fake halves' terms cancel, and the float32 sums with them
    y = _waves(12)[0]
    tt = np.arange(T) / 48000
    y_hat = (0.3 * np.sin(2 * np.pi * 330 * tt)[None, :, None]
             + 0.3 * np.random.default_rng(13).normal(size=y.shape)).astype(np.float32)

    def jloss(p, fake):
        r, g, fr, fg = fm.apply({"params": p}, jnp.asarray(y), fake)
        return JL.discriminator_loss(r, g) + JL.feature_loss(fr, fg)

    g_params, g_wave = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(y_hat))
    fake = torch.from_numpy(y_hat).requires_grad_()
    r, g, fr, fg = tm(torch.from_numpy(y), fake)
    loss = L.discriminator_loss(r, g) + L.feature_loss(fr, fg)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()] + [fake])
    ref = convert.discriminator_state_dict(jax.tree.map(np.asarray, g_params))
    got = dict(zip(names, grads[:-1]))
    refs = [np.asarray(g_wave)] + [np.asarray(ref[k]) for k in got]
    gots = [grads[-1].numpy()] + [v.numpy() for v in got.values()]
    whole = _norm_rel(np.concatenate([r.ravel() for r in refs]),
                      np.concatenate([g.ravel() for g in gots]))
    assert whole <= REL_TOL, whole
    errs = dict(zip(["wave", *got], (_norm_rel(r, g) for r, g in zip(refs, gots))))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TENSOR_TOL, (worst, errs[worst])
