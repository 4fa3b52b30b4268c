"""Which hand-written kernel takes a decoder's stage tail or chain
(``ops/resblock.py``: ``stage_route``, ``chain_route``, K2's runs of taps
``conv_taps`` / ``conv_launch``), on the CPU: every config the JAX package
converts lands on a kernel whose planner takes it, and a decoder with a
config no preset ships converts as JAX's does.

Tolerances: K2's runs of taps emulated in plain torch, f32, against
``resblock_chain_plain`` within 1e-5 of the output's largest magnitude (the
same products, summed in another order); the decoders against the JAX
package in float32 within 1e-4 (as ``test_torch_port_vocoders.py``). The
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rvc_tpu_torch import convert
from rvc_tpu_torch.ops import resblock as rb
from test_torch_port_vocoders import FRAMES, REL_TOL, _inputs, _preset, _random_params, _rel

DIL = (1, 3, 5)
SHIPPED = ((3, 7, 11), DIL)
# stage configs that K1's and the narrow kernel's planners refused before
# they routed (ROADMAP C1)
REFUSED_STAGES = [((3, 7, 15), DIL), ((3, 7, 11), (1, 3, 9)), ((3, 7, 11), (1, 3, 5, 7))]
# (K, d) that no time tile of K2's conv kernel held
REFUSED_CONVS = [(15, 13), (15, 15), (21, 11), (3, 99)]
DTYPES = (torch.bfloat16, torch.float32)


def _accepts(route, c, dtype, ks, dil):
    """The planner of the kernel ``route`` names takes the stage (or, for
    "chains", each chain's kernel takes its chain)."""
    if route == "k1":
        rb.stage_plan(c, ks, dil)
    elif route == "narrow":
        rb.narrow_plan(c, ks, dil)
    else:
        assert route == "chains"
        for k in ks:
            _chain_accepted(rb.chain_route(c, dtype, k, dil), c, k, dil)
    return True


def _chain_accepted(route, c, k, dil):
    if route == "narrow":
        rb.narrow_plan(c, (k,), dil)
        return
    assert route == "wide"
    for d in (*dil, 1):
        for _, n in rb.conv_taps(k, d):
            rb.conv_launch(n, d, 100_000, -(-c // rb.CONV_BLOCK))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [32, 64, 128])
@pytest.mark.parametrize("ks,dil", REFUSED_STAGES)
def test_stage_route_takes_the_refused_configs(ks, dil, c, dtype):
    """K1 refuses each (a tap reaches past its 32 guard rows), so a bf16
    stage runs chain by chain; an f32 stage at C <= 64 is one launch of the
    narrow kernel (128 guard rows, a 2-block cluster's halo), wider chain
    by chain through K2. Whatever the route, its kernels' planners take the
    shape."""
    route = rb.stage_route(c, dtype, ks, dil)
    want = "narrow" if dtype == torch.float32 and c <= 64 else "chains"
    assert route == want
    with pytest.raises(ValueError):
        rb.stage_plan(c, ks, dil)
    assert _accepts(route, c, dtype, ks, dil)
    for k in ks:
        assert rb.chain_route(c, dtype, k, dil) == ("narrow" if c <= 64 else "wide")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("k,d", REFUSED_CONVS)
def test_chain_route_takes_the_refused_convs(k, d, c, dtype):
    """A chain of dilations (1, d): the narrow kernel at C <= 64 where its
    guard rows hold the reach and a 2-block cluster keeps at least
    NARROW_MIN_SHARE of its rows (at C = 64 only K = 3, d = 99 does: 308 of
    512), else K2, whose runs of taps cover the conv where no time tile
    holds it whole."""
    dil = (1, d)
    route = rb.chain_route(c, dtype, k, dil)
    plan = rb.narrow_plan(c, (k,), dil, cluster=2) if c <= 64 else None
    assert route == ("narrow" if c <= 32 or (c == 64 and (k, d) == (3, 99)) else "wide")
    if plan is not None:
        assert (route == "narrow") == (plan.tile >= rb.NARROW_MIN_SHARE * 2 * plan.rows)
    _chain_accepted(route, c, k, dil)
    _chain_accepted("wide", c, k, dil)  # K2 takes it at every width


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [16, 32, 48, 64, 128, 256, 512])
def test_shipped_configs_keep_their_routes(c, dtype):
    """The presets' stage tails (kernels 3, 7, 11 over dilations 1, 3, 5)
    route as before: a bf16 stage at C <= 128 is one launch of K1, an f32
    stage at C <= 64 one launch of the narrow kernel, the rest chain by
    chain; a chain on its own (RefineGAN's) takes the narrow kernel at C <=
    64 and K2 above, its convs whole."""
    ks, dil = SHIPPED
    route = rb.stage_route(c, dtype, ks, dil)
    if dtype == torch.bfloat16:
        assert route == ("k1" if c <= 128 else "chains")
    else:
        assert route == ("narrow" if c <= 64 else "chains")
    assert _accepts(route, c, dtype, ks, dil)
    for k in ks:
        assert rb.chain_route(c, dtype, k, dil) == ("narrow" if c <= 64 else "wide")
        assert all(len(rb.conv_taps(k, d)) == 1 for d in (*dil, 1))


@pytest.mark.parametrize("k", range(1, 22, 2))
def test_k2_runs_cover_every_conv(k):
    """Every odd K up to 21 at every dilation up to 99: the runs are
    consecutive, cover the K taps once, each fits a time tile's shared
    memory (``conv_launch`` finds one and its ring stages), as few as
    the longest run that fits allows and as even as they come; a conv
    that fits whole is one run."""
    for d in range(1, 100):
        runs = rb.conv_taps(k, d)
        assert runs[0][0] == 0 and sum(n for _, n in runs) == k
        assert all(f2 == f1 + n1 for (f1, n1), (f2, _) in zip(runs, runs[1:]))
        sizes = [n for _, n in runs]
        assert max(sizes) - min(sizes) <= 1
        for _, n in runs:
            tile, stages = rb.conv_launch(n, d, 19176, 2)
            assert tile in rb.CONV_TILES and 2 <= stages <= rb.CONV_MAX_STAGES
            assert rb.conv_plan(n, d, tile)[1] == stages
        fits_whole = any(rb.conv_plan(k, d, t)[1] for t in rb.CONV_TILES)
        assert (len(runs) == 1) == fits_whole
        longest = max(n for n in range(1, k + 1) if rb.conv_plan(n, d, min(rb.CONV_TILES))[1])
        assert len(runs) == -(-k // longest)


def _run_conv(src, w, first, n, d):
    """One K2 launch of taps [first, first + n) of w at dilation d:
    out[t] = sum_j w[:, :, first + j] @ src[t + (first + j - K // 2) * d],
    zero outside the signal (the kernel's ``first`` argument is the offset
    of its first tap, (first - K // 2) * d)."""
    t, k = src.shape[-1], w.shape[-1]
    off, pad = (first - k // 2) * d, abs((first - k // 2) * d) + (n - 1) * d
    y = F.conv1d(F.pad(src, (pad, pad)), w[:, :, first:first + n], dilation=d)
    return y[:, :, off + pad:off + pad + t]


def _wide_runs(x, w1s, b1s, w2s, b2s, dil, slope):
    """K2's chain as ``_chain_wide`` launches it, in plain torch: conv_d's
    runs summed with the bias on the first (the leaky ReLU on the sum where
    the conv is one run, else as conv_1 reads it), then conv_1's runs with
    the residual."""
    leaky = lambda v: torch.where(v >= 0, v, v * slope)
    y = x
    for d, w1, b1, w2, b2 in zip(dil, w1s, b1s, w2s, b2s):
        k = w1.shape[-1]
        runs = rb.conv_taps(k, d)
        m = b1[None, :, None] + sum(_run_conv(leaky(y), w1, f, n, d) for f, n in runs)
        a = leaky(m)
        y = y + b2[None, :, None] + sum(_run_conv(a, w2, f, n, 1)
                                        for f, n in rb.conv_taps(k, 1))
    return y


@pytest.mark.parametrize("k,d", REFUSED_CONVS + [(3, 5), (1, 7)])
def test_k2_runs_match_plain(k, d):
    """K2's runs of taps, placed by their ``first`` offsets and summed in
    f32, are the chain: within 1e-5 of ``resblock_chain_plain``."""
    rng = np.random.default_rng(k * 100 + d)
    c, t, dil = 8, 700, (1, d)
    w = lambda: torch.from_numpy((rng.normal(size=(c, c, k)) / np.sqrt(c * k)).astype(np.float32))
    b = lambda: torch.from_numpy((rng.normal(size=(c,)) * 0.05).astype(np.float32))
    chain = ([w(), w()], [b(), b()], [w(), w()], [b(), b()])
    x = torch.from_numpy((rng.normal(size=(2, c, t)) * 0.3).astype(np.float32))
    ref = rb.resblock_chain_plain(x, *chain, dil, 0.2)
    assert _rel(ref.numpy(), _wide_runs(x, *chain, dil, 0.2).numpy()) <= 1e-5


# a decoder config no preset ships: the refused stage configs in one
NONSHIPPED = dict(resblock_kernel_sizes=(3, 7, 15), resblock_dilation_sizes=((1, 3, 9),) * 3)


@pytest.mark.parametrize("vocoder", ["HiFi-GAN", "MRF HiFi-GAN"])
def test_nonshipped_decoder_config_matches_jax(vocoder):
    """A synthesizer at narrow widths whose decoder has kernels (3, 7, 15)
    over dilations (1, 3, 9), weights from a numpy seed through the weight
    bridge: ``infer`` against the JAX package's in float32 within 1e-4.
    Each stage tail asks ``stage_route`` (on the CPU the routes end on the
    plain versions, the launch counts stay 0)."""
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    dims = dict(inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
                n_layers=2, kernel_size=3, upsample_initial_channel=32, spk_embed_dim=4,
                gin_channels=8, **NONSHIPPED, **_preset(48000), sr=48000, vocoder=vocoder)
    fm = FlaxSynth(spec_channels=33, segment_size=8, posterior_layers=2, flow_layers=2,
                   zero_noise=True, text_enc_hidden_dim=768, **dims)
    x = _inputs(5)
    args = [jnp.asarray(x[k]) for k in ("phone", "lengths", "pitch", "pitchf", "sid")]
    shapes = jax.eval_shape(
        fm.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        *args[:4], jnp.zeros((2, FRAMES, 33)), args[1], args[4])["params"]
    params = _random_params(shapes, 41)
    ref = jax.jit(lambda p, *a: fm.apply({"params": p}, *a, method=FlaxSynth.infer)[0])(
        params, *args)
    tm = Synthesizer(flow_layers=2, zero_noise=True, text_enc_hidden_dim=768, **dims)
    convert.load_into(tm, convert.synthesizer_state_dict(jax.tree.map(np.asarray, params)))
    targs = [torch.from_numpy(x[k]) for k in ("phone", "lengths", "pitch", "pitchf", "sid")]
    targs[2], targs[4] = targs[2].long(), targs[4].long()
    rb.reset_launches()
    with torch.no_grad():
        out, _ = tm.eval().infer(*targs)
    assert not any(rb.launches.values())
    assert out.shape == (2, FRAMES * 480, 1)
    assert _rel(ref, out.numpy()) <= REL_TOL


def test_pack_chain_packs_each_run_of_taps():
    """A conv that no time tile holds whole (K = 15 at d = 15) packs as its
    runs of taps, each the K2 image of its slice of the weights; a conv that
    fits packs whole."""
    rng = np.random.default_rng(15)
    c, k, dil = 32, 15, (1, 15)
    w = lambda: torch.from_numpy((rng.normal(size=(c, c, k)) * 0.1).astype(np.float32))
    b = lambda: torch.from_numpy((rng.normal(size=(c,)) * 0.05).astype(np.float32))
    w1s, b1s, w2s, b2s = [w(), w()], [b(), b()], [w(), w()], [b(), b()]
    packed = rb.pack_chain(w1s, b1s, w2s, b2s, c, dil)
    runs = rb.conv_taps(k, 15)
    assert [len(r) for r in packed.ws] == [1, 1, len(runs), 1] and len(runs) == 2
    for (first, n), image in zip(runs, packed.ws[2]):
        assert torch.equal(image, rb.pack_conv_tf32(w1s[1][:, :, first:first + n]))
    assert torch.equal(packed.ws[0][0], rb.pack_conv_tf32(w1s[0]))
