"""The port's windowed long-audio and batch paths against the JAX package's,
on the CPU in float32.

Small models (flax weights carried across with ``rvc_tpu_torch.convert``),
``zero_noise=True``, and ``PipelineConfig(x_pad=1, x_query=1, x_center=2,
x_max=3)`` in both packages, so that about 7 s of audio cuts into four
windows. Tolerances: the coarse (255-bin) pitch of ``get_f0`` exactly
equal and f0 within 1e-3; audio within 1e-3 absolute and within 1e-3 of
the reference's peak. ``pipeline_many`` must equal serial ``pipeline`` calls
sample for sample, and the windowed f0 comes from the predictor's float32
model even in a bf16 pipeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_models import _fix_var, _random_params
from test_torch_port_pipeline import E2E, HUB, SYN

WIN = dict(x_pad=1, x_query=1, x_center=2, x_max=3)
KW = dict(sid=1, pitch_shift=2, index_rate=0.75, protect=0.33, filter_radius=3)


def _models(use_f0):
    from rvc_tpu.embedders.hubert import FlaxHubert, HubertConfig as FHC
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu.predictors.rmvpe import E2EModel as FlaxE2E
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.rmvpe import E2EModel

    t = 12
    fsyn = FlaxSynth(spec_channels=33, segment_size=8, posterior_layers=2,
                     flow_layers=2, zero_noise=True, use_f0=use_f0, **SYN)
    sp = _random_params(
        fsyn.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, 32)), jnp.asarray([t], jnp.int32),
        jnp.full((1, t), 100, jnp.int32) if use_f0 else None,
        jnp.full((1, t), 220.0, jnp.float32) if use_f0 else None,
        jnp.zeros((1, t, 33)), jnp.asarray([t], jnp.int32),
        jnp.zeros((1,), jnp.int32), seed=11)["params"]
    fhub = FlaxHubert(FHC(**HUB))
    hp = _random_params(fhub.init, jax.random.PRNGKey(0), jnp.zeros((1, 3200)),
                        seed=12)["params"]
    fe2e = FlaxE2E(**E2E)
    ev = _random_params(fe2e.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 128)),
                        seed=13)
    stats = _fix_var(ev["batch_stats"])

    syn = Synthesizer(flow_layers=2, zero_noise=True, use_f0=use_f0, **SYN)
    convert.load_into(syn, convert.synthesizer_state_dict(sp))
    hub = Hubert(HubertConfig(**HUB))
    convert.load_into(hub, convert.hubert_state_dict(hp))
    e2e = E2EModel(**E2E)
    convert.load_into(e2e, convert.rmvpe_state_dict(ev["params"], stats))
    return (fsyn, sp, fhub, hp, fe2e, ev["params"], stats), (syn, hub, e2e)


def _pipes(use_f0, cfg):
    from rvc_tpu.infer.pipeline import Pipeline as JaxPipeline
    from rvc_tpu.infer.pipeline import PipelineConfig as JaxCfg
    from rvc_tpu.predictors.rmvpe import RMVPE as JaxRMVPE
    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig
    from rvc_tpu_torch.predictors.rmvpe import RMVPE

    (fsyn, sp, fhub, hp, fe2e, ep, stats), (syn, hub, e2e) = _models(use_f0)
    jpipe = JaxPipeline(48000, fsyn, sp, fhub, hp, JaxCfg(**cfg),
                        upsample_factor=480, precision="fp32")
    tpipe = Pipeline(48000, syn, hub, PipelineConfig(**cfg), upsample_factor=480,
                     precision="fp32", device="cpu")
    return (jpipe, JaxRMVPE(ep, stats, model=fe2e)), (tpipe, RMVPE(e2e, device="cpu"))


@pytest.fixture(scope="module")
def windowed():
    return _pipes(True, WIN)


@pytest.fixture(scope="module")
def fused():
    """Default windows (t_max 65 s): whole clips take the fused path."""
    (jpipe, jrm), (tpipe, trm) = _pipes(True, {})
    jpipe.set_rmvpe(jrm)
    tpipe.set_rmvpe(trm)
    return jpipe, tpipe


def _audio(n, seed=21, f=220.0):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / 16000
    env = 0.6 + 0.4 * np.sin(2 * np.pi * 0.7 * tt)
    return (0.4 * env * np.sin(2 * np.pi * f * tt)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


def _index():
    return np.random.default_rng(22).normal(size=(600, 32)).astype(np.float32)


def _close(ref, out):
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err, peak = float(np.abs(ref - out).max()), float(np.abs(ref).max())
    assert peak >= 0.02, f"reference peak {peak}"
    assert err <= 1e-3, f"max abs err {err} (peak {peak})"
    assert err <= 1e-3 * peak, f"max abs err {err} > 1e-3 x peak {peak}"


def test_windowed_input_cuts_into_windows(windowed):
    (jpipe, _), (tpipe, _) = windowed
    audio = tpipe._highpass(_audio(112000))
    assert tpipe._find_cut_points(audio) == jpipe._find_cut_points(audio)
    assert len(tpipe._find_cut_points(audio)) == 3


def test_get_f0_matches_jax(windowed):
    (jpipe, jrm), (tpipe, trm) = windowed
    audio_pad = np.pad(tpipe._highpass(_audio(112000)), (16000, 16000), mode="reflect")
    p_len = audio_pad.shape[0] // 160
    ref = jpipe.get_f0(audio_pad, p_len, 2, "rmvpe", {"rmvpe": jrm.infer_from_audio},
                       f0_autotune=True, f0_autotune_strength=0.5, filter_radius=3)
    out = tpipe.get_f0(audio_pad, p_len, 2, "rmvpe", {"rmvpe": trm.infer_from_audio},
                       f0_autotune=True, f0_autotune_strength=0.5, filter_radius=3)
    assert ref[0].shape == out[0].shape == (p_len,)
    assert (ref[1] > 0).any()
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["index", "inp_f0", "volume"])
def test_windowed_pipeline_matches_jax(windowed, case):
    (jpipe, jrm), (tpipe, trm) = windowed
    audio = _audio(112000)
    kw = dict(KW, index_vectors=_index())
    if case == "inp_f0":
        t = np.arange(50, 250) / 100.0
        kw["inp_f0"] = np.stack([t, 180 + 40 * np.sin(t)], axis=1).astype(np.float32)
    if case == "volume":
        kw.update(volume_envelope=0.5, index_rate=0.0)
    ref = jpipe.pipeline(audio, f0_method="rmvpe",
                         predictors={"rmvpe": jrm.infer_from_audio},
                         rng=jax.random.PRNGKey(0), **kw)
    out = tpipe.pipeline(audio, f0_method="rmvpe",
                         predictors={"rmvpe": trm.infer_from_audio}, **kw)
    assert tpipe._rmvpe is None  # the windowed path attaches nothing
    assert out.shape[0] > 112000 * 3  # four windows, each a hop longer
    _close(ref, out)


def test_no_f0_model_matches_jax():
    (jpipe, _), (tpipe, _) = _pipes(False, WIN)
    audio = _audio(112000, seed=23)
    kw = dict(sid=1, index_vectors=_index(), index_rate=0.5, protect=0.33)
    ref = jpipe.pipeline(audio, pitch_guidance=False, rng=jax.random.PRNGKey(0), **kw)
    out = tpipe.pipeline(audio, pitch_guidance=False, **kw)
    _close(ref, out)


def test_convert_segments_batch_matches_jax(windowed):
    (jpipe, jrm), (tpipe, _) = windowed
    segs = [np.pad(_audio(n, seed=s), (16000, 16000), mode="reflect")
            for n, s in ((21000, 1), (30500, 2), (16000, 3))]
    pitches, pitchfs = [], []
    for s in segs:  # one pitch for both packages: the batch path alone
        c, f = jpipe.get_f0(s, s.shape[0] // 160, 0, "rmvpe",
                            {"rmvpe": jrm.infer_from_audio})
        pitches.append(c)
        pitchfs.append(f)
    index = _index()
    ref = jpipe.convert_segments_batch(segs, pitches, pitchfs, [1, 2, 3],
                                       jnp.asarray(index), 0.75, 0.33,
                                       jax.random.PRNGKey(0))
    out = tpipe.convert_segments_batch(segs, pitches, pitchfs, [1, 2, 3], index,
                                       0.75, 0.33)
    assert [o.shape for o in out] == [r.shape for r in ref]
    for r, o in zip(ref, out):
        _close(r, o)
    single = tpipe.voice_conversion(segs[1], pitches[1], pitchfs[1], 2, index,
                                    0.75, 0.33)
    _close(ref[1], single)


def test_fused_many_matches_jax(fused):
    jpipe, tpipe = fused
    segs = [_audio(n, seed=s) for n, s in ((24000, 4), (19000, 5))]
    index = _index()
    kw = dict(sid=1, index_rate=0.75, protect=0.33, pitch_shift=2, filter_radius=3)
    ref = jpipe.voice_conversion_fused_many(segs, index_vectors=jnp.asarray(index),
                                            rng=jax.random.PRNGKey(0), **kw)
    out = tpipe.voice_conversion_fused_many(segs, index_vectors=index, **kw)
    for r, o in zip(ref, out):
        _close(r, o)
    streamed = tpipe.voice_conversion_fused_batch_stream(
        segs + segs[:1], index_vectors=index, batch=2, **kw)
    assert len(streamed) == 3
    for o, s in zip(streamed, out + out[:1]):
        np.testing.assert_allclose(o, s, rtol=0, atol=1e-6)


def test_pipeline_many_equals_serial_pipeline(fused):
    _, tpipe = fused
    audios = [_audio(n, seed=s) for n, s in ((20000, 6), (27000, 7), (9000, 8))]
    kw = dict(KW, index_vectors=_index(), volume_envelope=0.7)
    many = tpipe.pipeline_many(audios, **kw)
    serial = [tpipe.pipeline(a, **kw) for a in audios]
    assert len(many) == 3
    for m, s in zip(many, serial):
        np.testing.assert_array_equal(m, s)


def test_windowed_f0_stays_float32_in_a_bf16_pipeline():
    """set_rmvpe gives the bf16 fused graph a bf16 copy of the predictor's
    model; the predictor stays float32, so the windowed path's f0 of a bf16
    pipeline equals that of an fp32 pipeline."""
    from rvc_tpu_torch.infer.pipeline import Pipeline, PipelineConfig
    from rvc_tpu_torch.predictors.rmvpe import RMVPE

    _, (syn, hub, e2e) = _models(True)
    rmvpe = RMVPE(e2e, device="cpu")
    f32 = Pipeline(48000, syn, hub, PipelineConfig(**WIN), upsample_factor=480,
                   device="cpu")
    f32.set_rmvpe(rmvpe)
    audio_pad = np.pad(_audio(40000), (16000, 16000), mode="reflect")
    ref = f32.get_f0(audio_pad, audio_pad.shape[0] // 160, 2)
    bf16 = Pipeline(48000, syn, hub, PipelineConfig(**WIN), upsample_factor=480,
                    precision="bf16", device="cpu")
    bf16.set_rmvpe(rmvpe)
    assert next(rmvpe.model.parameters()).dtype == torch.float32
    assert next(bf16._rmvpe_model.parameters()).dtype == torch.bfloat16
    assert f32._rmvpe_model is rmvpe.model
    out = bf16.get_f0(audio_pad, audio_pad.shape[0] // 160, 2)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])


def test_unported_f0_methods_raise(windowed):
    _, (tpipe, trm) = windowed
    for method in ("crepe", "fcpe", "yin", "hybrid[rmvpe+fcpe]"):
        with pytest.raises(NotImplementedError, match="A.10"):
            tpipe.pipeline(_audio(8000), f0_method=method)
    with pytest.raises(ValueError, match="unknown f0 method"):
        tpipe.pipeline(_audio(8000), f0_method="pyin")


def test_f0_helpers_match_jax():
    from rvc_tpu.infer import pipeline as jp
    from rvc_tpu.predictors import f0_extractor as jf
    from rvc_tpu_torch.infer import pipeline as tp
    from rvc_tpu_torch.predictors import f0_extractor as tf

    f0 = np.abs(np.random.default_rng(9).normal(200, 80, size=300)).astype(np.float32)
    f0[40:60] = 0.0
    np.testing.assert_array_equal(tp.coarse_f0(f0), jp.coarse_f0(f0))
    np.testing.assert_array_equal(tp.autotune_f0(f0, 0.7), jp.autotune_f0(f0, 0.7))
    np.testing.assert_array_equal(tf.interp_f0_to_grid(f0, 211),
                                  jf.interp_f0_to_grid(f0, 211))
    for m in ("rmvpe", "hybrid[crepe+rmvpe]", "hybrid[ rmvpe + fcpe ]"):
        assert tf.parse_f0_methods(m) == jf.parse_f0_methods(m)
    assert tp.PipelineConfig.from_device("cpu") == tp.PipelineConfig()
