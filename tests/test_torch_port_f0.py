"""The port's f0 methods against the JAX package's, on the CPU in float32.

The same seeded weights go to both packages through the ``convert.py``
bridges (or through a checkpoint file in the reference layout):
- YIN: the same contour (within 1e-4 relative), on a numpy array and on a
  tensor;
- CREPE tiny: the salience within 1e-4, f0 from both decoders within 1e-4
  relative; ``from_torch_checkpoint`` on a torchcrepe file (the port's
  models built with JAX's batch-norm epsilon, 1e-5, where the port's
  default is torchcrepe's 1e-3);
- a narrow FCPE with attention and with ``conv_only``: the latent within
  1e-4, ``compute_f0`` with and without ``p_len`` and a fractional
  threshold; ``from_torch_checkpoint`` on a torchfcpe file with a
  weight-normed output projection;
- ``Pipeline.get_f0`` against JAX's for each method and the hybrids:
  crepe at another hop (interpolated to the 10 ms grid), fcpe with
  ``p_len`` and its threshold, yin without a predictor;
- the registry (``check_f0_method``, ``build_predictors``), the
  ``F0Extractor`` utility, and the MIDI transcription (the same bytes).
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_models import _fix_var, _random_params, _rel
from test_torch_port_pipeline import E2E

FCPE_NARROW = dict(hidden_dims=32, n_layers=2, n_heads=2)
JAX_BN_EPS = 1e-5   # flax's batch-norm epsilon, which the JAX package's CREPE keeps


def _voice(n, seed=0, f=210.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = f * (1 + 0.04 * np.sin(2 * np.pi * 4 * t))
    a = 0.45 * np.sin(2 * np.pi * np.cumsum(f0) / 16000)
    a[n // 3:n // 3 + 2400] = 0.0  # an unvoiced stretch
    return (a + 0.01 * rng.normal(size=n)).astype(np.float32)


@pytest.fixture(scope="module")
def crepe_pair():
    from rvc_tpu.predictors.crepe import CREPE as JaxCREPE
    from rvc_tpu.predictors.crepe import CrepeModel as FlaxCrepe
    from rvc_tpu_torch.predictors.crepe import CREPE, CrepeModel

    ev = _random_params(FlaxCrepe("tiny").init, jax.random.PRNGKey(0),
                        jnp.zeros((1, 1024)), seed=21)
    params, stats = ev["params"], _fix_var(ev["batch_stats"])
    model = CrepeModel("tiny", eps=JAX_BN_EPS)
    model.load_state_dict(convert.crepe_state_dict(params, stats), strict=False)
    return (JaxCREPE("tiny", jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, stats)),
            CREPE("tiny", model, device="cpu"), params, stats)


def _fcpe_pair(conv_only, seed=22):
    from rvc_tpu.predictors.fcpe import FCPE as JaxFCPE
    from rvc_tpu.predictors.fcpe import CFNaiveMelPE as FlaxFCPE
    from rvc_tpu_torch.predictors.fcpe import FCPE, CFNaiveMelPE

    fm = FlaxFCPE(conv_only=conv_only, **FCPE_NARROW)
    params = _random_params(fm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 128)),
                            seed=seed)["params"]
    # a sharper latent, so that frames are voiced
    params["output_proj"]["kernel"] = params["output_proj"]["kernel"] * 20.0
    model = CFNaiveMelPE(conv_only=conv_only, **FCPE_NARROW)
    model.load_state_dict(convert.fcpe_state_dict(params))
    return (JaxFCPE(jax.tree.map(jnp.asarray, params), model=fm),
            FCPE(model, device="cpu"), params)


@pytest.fixture(scope="module")
def fcpe_pair():
    return _fcpe_pair(conv_only=False)


@pytest.fixture(scope="module")
def rmvpe_pair():
    from rvc_tpu.predictors.rmvpe import RMVPE as JaxRMVPE
    from rvc_tpu.predictors.rmvpe import E2EModel as FlaxE2E
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel

    fe2e = FlaxE2E(**E2E)
    ev = _random_params(fe2e.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 128)),
                        seed=13)
    stats = _fix_var(ev["batch_stats"])
    e2e = E2EModel(**E2E)
    convert.load_into(e2e, convert.rmvpe_state_dict(ev["params"], stats))
    return JaxRMVPE(ev["params"], stats, model=fe2e), RMVPE(e2e, device="cpu")


def test_yin_matches_jax():
    from rvc_tpu.predictors.dsp_f0 import yin_f0_np as jax_yin
    from rvc_tpu_torch.predictors.dsp_f0 import yin_f0, yin_f0_np

    audio = _voice(17000)
    ref = jax_yin(audio)
    out = yin_f0_np(audio, device="cpu")
    assert out.shape == ref.shape == (17000 // 160 + 1,)
    assert (ref > 0).sum() > 50 and (ref == 0).sum() > 5
    np.testing.assert_array_equal(out > 0, ref > 0)
    assert _rel(ref, out) <= 1e-4
    np.testing.assert_array_equal(yin_f0(torch.from_numpy(audio)).numpy(), out)
    short = yin_f0_np(audio[:300], device="cpu")  # shorter than the padding
    np.testing.assert_allclose(short, jax_yin(audio[:300]), rtol=1e-4, atol=1e-4)


def test_crepe_tiny_matches_jax(crepe_pair):
    jc, tc, _, _ = crepe_pair
    audio = _voice(9000, seed=1)
    frames = np.stack([audio[i:i + 1024] for i in range(0, 7900, 400)])
    ref = np.asarray(jc._salience(jc.params, jc.batch_stats, jnp.asarray(frames)))
    out = tc.salience(torch.from_numpy(frames)).numpy()
    assert np.abs(ref - out).max() <= 1e-4
    for decoder in ("viterbi", "weighted"):
        for hop in (160, 128):
            r = jc.predict(audio, hop_length=hop, decoder=decoder)
            o = tc.predict(audio, hop_length=hop, decoder=decoder)
            assert o.shape == r.shape == (9000 // hop + 1,)
            assert _rel(r, o) <= 1e-4


@pytest.mark.parametrize("conv_only", [False, True])
def test_fcpe_matches_jax(conv_only, fcpe_pair):
    from rvc_tpu.predictors.fcpe import fcpe_mel as jax_mel

    jf, tf, params = fcpe_pair if not conv_only else _fcpe_pair(True)
    audio = _voice(12000, seed=2)
    mel = np.asarray(jax_mel(jnp.asarray(audio[None])))
    ref = np.asarray(jf.model.apply({"params": jf.params}, jnp.asarray(mel)))
    out = tf.model(torch.from_numpy(mel.copy())).detach().numpy()
    assert np.abs(ref - out).max() <= 1e-4
    for kw in ({}, {"p_len": 90, "filter_radius": 0.5}, {"threshold": 0.3}):
        r, o = jf.compute_f0(audio, **kw), tf.compute_f0(audio, **kw)
        assert o.shape == r.shape and (r > 0).any()
        assert _rel(r, o) <= 1e-4


def test_checkpoint_loaders_match_jax(crepe_pair, fcpe_pair, tmp_path):
    from rvc_tpu.predictors.crepe import CREPE as JaxCREPE
    from rvc_tpu.predictors.fcpe import FCPE as JaxFCPE
    from rvc_tpu_torch.predictors.crepe import CREPE
    from rvc_tpu_torch.predictors.fcpe import FCPE

    _, _, params, stats = crepe_pair
    sd = convert.crepe_state_dict(params, stats)
    for i in range(1, 7):
        sd[f"conv{i}_BN.num_batches_tracked"] = torch.tensor(0)
    crepe_path = str(tmp_path / "crepe.pt")
    torch.save(sd, crepe_path)
    audio = _voice(8000, seed=3)
    ref = JaxCREPE.from_torch_checkpoint(crepe_path, "full").predict(audio)
    out = CREPE.from_torch_checkpoint(crepe_path, "full", device="cpu", eps=JAX_BN_EPS)
    assert out.capacity == "tiny"
    assert _rel(ref, out.predict(audio)) <= 1e-4

    _, _, fparams = fcpe_pair
    sd = convert.fcpe_state_dict(fparams)
    w = sd.pop("output_proj.weight")
    sd["output_proj.parametrizations.weight.original0"] = torch.linalg.norm(
        w, dim=1, keepdim=True)
    sd["output_proj.parametrizations.weight.original1"] = w
    fcpe_path = str(tmp_path / "fcpe.pt")
    torch.save({"model": sd, "config_dict": {"model": {"n_heads": 2}}}, fcpe_path)
    ref = JaxFCPE.from_torch_checkpoint(fcpe_path).compute_f0(audio)
    out = FCPE.from_torch_checkpoint(fcpe_path, device="cpu").compute_f0(audio)
    assert _rel(ref, out) <= 1e-4
    del sd["net.encoder_layers.0.conformer.net.2.weight"]
    torch.save(sd, fcpe_path)
    with pytest.raises(KeyError, match="lacks"):
        FCPE.from_torch_checkpoint(fcpe_path, device="cpu")


METHODS = [
    ("rmvpe", {}), ("crepe-tiny", {"hop_length": 128}), ("crepe-tiny", {}),
    ("fcpe", {"filter_radius": 0.5}), ("fcpe", {"filter_radius": 3}),
    ("yin", {}), ("hybrid[rmvpe+fcpe]", {}), ("hybrid[crepe-tiny+rmvpe+fcpe]",
                                             {"hop_length": 128}),
    ("hybrid[rmvpe+yin]", {"filter_radius": 0}),
]


@pytest.mark.parametrize("method,kw", METHODS)
def test_get_f0_matches_jax(method, kw, crepe_pair, fcpe_pair, rmvpe_pair):
    """``get_f0`` reads only ``_rmvpe``, ``device`` and (for an external
    f0) ``cfg`` of its pipeline, so both run on a stand-in for one."""
    from rvc_tpu.infer.pipeline import Pipeline as JaxPipeline
    from rvc_tpu_torch.infer.pipeline import Pipeline

    jc, tc, _, _ = crepe_pair
    jf, tf, _ = fcpe_pair
    jrm, trm = rmvpe_pair
    jpred = {"rmvpe": jrm.infer_from_audio, "crepe-tiny": jc.predict,
             "fcpe": jf.compute_f0}
    tpred = {"rmvpe": trm.infer_from_audio, "crepe-tiny": tc.predict,
             "fcpe": tf.compute_f0}
    audio = np.pad(_voice(20000, seed=4), (1600, 1600), mode="reflect")
    p_len = audio.shape[0] // 160
    ref = JaxPipeline.get_f0(types.SimpleNamespace(), audio, p_len, 2, method,
                             jpred, **kw)
    me = types.SimpleNamespace(_rmvpe=None, device=torch.device("cpu"))
    out = Pipeline.get_f0(me, audio, p_len, 2, method, tpred, **kw)
    assert out[1].shape == ref[1].shape == (p_len,)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-3, atol=1e-3)
    assert np.abs(out[0].astype(np.int64) - ref[0]).max() <= 1


def test_registry_builds_each_method(crepe_pair, fcpe_pair, tmp_path, capsys):
    from rvc_tpu_torch.predictors import f0_extractor as fx

    for m in ("rmvpe", "crepe", "crepe-tiny", "fcpe", "yin", "hybrid[rmvpe+fcpe]",
              "hybrid[crepe+rmvpe+fcpe]", "hybrid[rmvpe+yin]"):
        fx.check_f0_method(m)
    for bad in ("pyin", "hybrid[rmvpe+pm]", "hybrid[]"):
        with pytest.raises(ValueError, match="unknown f0 method"):
            fx.check_f0_method(bad)
    _, _, params, stats = crepe_pair
    torch.save(convert.crepe_state_dict(params, stats), str(tmp_path / "c.pt"))
    _, tf, _ = fcpe_pair
    torch.save(tf.model.state_dict(), str(tmp_path / "f.pt"))
    preds = fx.build_predictors(("crepe-tiny", "fcpe", "yin"),
                                crepe_ckpt=str(tmp_path / "c.pt"),
                                fcpe_ckpt=str(tmp_path / "f.pt"), device="cpu")
    audio = _voice(6000, seed=5)
    for m, f in preds.items():
        frames = 6000 // 160 if m == "fcpe" else 6000 // 160 + 1
        assert f(audio).shape == (frames,)
    assert "RANDOM" not in capsys.readouterr().out


def test_f0_extractor_and_midi_match_jax(tmp_path):
    from rvc_tpu.predictors.f0_extractor import F0Extractor as JaxExtractor
    from rvc_tpu.predictors.f0_midi import read_midi_notes as jax_read
    from rvc_tpu_torch.predictors import f0_midi
    from rvc_tpu_torch.predictors.f0_extractor import F0Extractor
    from rvc_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / "v.wav")
    write_wav(path, np.concatenate([_voice(24000, seed=6, f=f) for f in
                                    (200.0, 260.0, 330.0)]), 16000, "FLOAT")
    ref_ex, ex = JaxExtractor(path, method="yin"), F0Extractor(path, method="yin",
                                                                device="cpu")
    f0 = ex.extract_f0()
    np.testing.assert_allclose(f0, ref_ex.extract_f0(), rtol=1e-4, atol=1e-4)
    for tempo in (None, 100.0):
        ref_segs = ref_ex.to_midi(str(tmp_path / "a.mid"), tempo=tempo, f0=f0)
        segs = ex.to_midi(str(tmp_path / "b.mid"), tempo=tempo, f0=f0)
        assert segs == ref_segs and len(segs) >= 3
        with open(tmp_path / "a.mid", "rb") as a, open(tmp_path / "b.mid", "rb") as b:
            assert a.read() == b.read()
        assert f0_midi.read_midi_notes(str(tmp_path / "b.mid")) == jax_read(
            str(tmp_path / "a.mid"))
    assert ex.plot_f0(f0, str(tmp_path / "f0.png")) == str(tmp_path / "f0.png")
    with pytest.raises(ValueError, match="not a MIDI file"):
        f0_midi.read_midi_notes(path)
