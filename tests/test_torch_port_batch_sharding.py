"""Sharded batch serving in the port (the counterpart of
``tests/test_batch_sharding.py``): ``Pipeline.enable_batch_sharding`` with
two CPU replicas splits the rows of ``convert_segments_batch`` and
``voice_conversion_fused_many`` over them.

The sharded port is held to JAX's sharded batch on a two-device mesh
(zero-noise models; 1e-3 absolute, as the windowed tests), and to its own
unsharded batch row for row (to float32 rounding, 1e-6), with the models'
noise on (each replica draws its rows of the whole batch's noise), and
including a batch padded to a multiple of the replica count. ``VoiceConverter``'s batch
path on two replicas writes the files the unsharded one writes (within one
step of their 16-bit samples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_converter import LSB, _write_model
from test_torch_port_windowed import WIN, _audio, _close, _index, _pipes

KW = dict(index_rate=0.75, protect=0.33)
# the CPU's kernels round a batch of two rows and one of four apart by a few
# float32 steps (1e-8 here); a row given another row's noise would be 1e-2 off
ROUNDING = 1e-6


def _segments(n_rows):
    return [np.pad(_audio(n, seed=s), (16000, 16000), mode="reflect")
            for n, s in ((21000, 1), (30500, 2), (16000, 3), (25000, 4))[:n_rows]]


@pytest.fixture(scope="module")
def pipes():
    """The JAX and port pipelines on the same zero-noise models, and a port
    pipeline with the models' noise on, each with RMVPE attached."""
    (jpipe, jrm), (tpipe, trm) = _pipes(True, WIN)
    jpipe.set_rmvpe(jrm)
    tpipe.set_rmvpe(trm)
    (_, _), (noisy, nrm) = _pipes(True, {})
    for m in noisy.synthesizer.modules():
        if hasattr(m, "zero_noise"):
            m.zero_noise = False
    noisy.set_rmvpe(nrm)
    return jpipe, jrm, tpipe, noisy


def _pitch(jpipe, jrm, segs):
    got = [jpipe.get_f0(s, s.shape[0] // 160, 0, "rmvpe", {"rmvpe": jrm.infer_from_audio})
           for s in segs]
    return [c for c, _ in got], [f for _, f in got]


def test_sharded_segments_batch_matches_jax(pipes):
    from jax.sharding import Mesh

    jpipe, jrm, tpipe, _ = pipes
    segs = _segments(3)  # padded to 4 rows on 2 devices
    pitches, pitchfs = _pitch(jpipe, jrm, segs)
    index = _index()
    jpipe.enable_batch_sharding(Mesh(np.asarray(jax.devices()[:2]), ("dp",)))
    tpipe.enable_batch_sharding(["cpu", "cpu"])
    try:
        ref = jpipe.convert_segments_batch(segs, pitches, pitchfs, [1, 2, 3],
                                           jnp.asarray(index), 0.75, 0.33,
                                           jax.random.PRNGKey(0))
        out = tpipe.convert_segments_batch(segs, pitches, pitchfs, [1, 2, 3], index,
                                           0.75, 0.33)
    finally:
        jpipe._mesh, tpipe._replicas = None, None
    assert [o.shape for o in out] == [r.shape for r in ref]
    for r, o in zip(ref, out):
        _close(r, o)


@pytest.mark.parametrize("n_rows", [3, 4])
def test_sharded_rows_equal_unsharded(pipes, n_rows):
    jpipe, jrm, _, noisy = pipes
    segs = _segments(n_rows)
    pitches, pitchfs = _pitch(jpipe, jrm, segs)
    sids = [1, 2, 3, 0][:n_rows]
    index = _index()
    raw = [s[16000:-16000] for s in segs]
    gen = torch.Generator().manual_seed(5)
    want = noisy.convert_segments_batch(segs, pitches, pitchfs, sids, index, **KW)
    want_fused = noisy.voice_conversion_fused_many(raw, 1, index, generator=gen, **KW)
    want_state = gen.get_state()
    noisy.enable_batch_sharding(["cpu", "cpu"])
    try:
        assert len(noisy._replicas) == 2
        assert all(r.synthesizer is not noisy.synthesizer for r in noisy._replicas)
        gen = torch.Generator().manual_seed(5)
        got = noisy.convert_segments_batch(segs, pitches, pitchfs, sids, index, **KW)
        got_fused = noisy.voice_conversion_fused_many(raw, 1, index, generator=gen, **KW)
        streamed = noisy.voice_conversion_fused_batch_stream(raw, 1, index, batch=3, **KW)
    finally:
        noisy._replicas = None
    # the caller's generator stands where the unsharded batch left it
    assert torch.equal(gen.get_state(), want_state)
    for w, g in zip(want + want_fused, got + got_fused):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ROUNDING)
    unsharded = noisy.voice_conversion_fused_batch_stream(raw, 1, index, batch=3, **KW)
    for w, g in zip(unsharded, streamed):
        np.testing.assert_allclose(g, w, rtol=0, atol=ROUNDING)


def test_one_device_shards_nothing(pipes):
    _, _, tpipe, _ = pipes
    tpipe.enable_batch_sharding()  # the CPU pipeline, no list: no replicas
    assert tpipe._replicas is None


def test_converter_batch_on_two_replicas(tmp_path):
    from rvc_tpu_torch.infer.converter import VoiceConverter
    from rvc_tpu_torch.utils.audio_io import read_wav, write_wav

    _write_model(tmp_path / "model.pth")
    src = tmp_path / "in"
    src.mkdir()
    for name, n in (("a", 16000), ("b", 27000), ("c", 9000)):
        tt = np.arange(n) / 16000
        write_wav(str(src / f"{name}.wav"), 0.3 * np.sin(2 * np.pi * 150 * tt), 16000)
    kw = dict(model_path=str(tmp_path / "model.pth"), pitch=2, f0_method="rmvpe",
              sid=0, index_rate=0.0)
    outs = {}
    vc = VoiceConverter(precision="fp32", device="cpu")
    vc.get_vc(kw["model_path"])  # one converter: the same (random) embedder
    for sharded in (False, True):
        if sharded:
            vc.pipeline.enable_batch_sharding(["cpu", "cpu"])
        dst = tmp_path / f"out{int(sharded)}"
        vc.convert_audio_batch(str(src), str(dst), **kw)
        outs[sharded] = {p.name: read_wav(str(p))[0] for p in sorted(dst.iterdir())}
    assert list(outs[True]) == ["a_output.wav", "b_output.wav", "c_output.wav"]
    for name, data in outs[False].items():
        # 16-bit files: a float32 rounding difference at a step's edge moves
        # a sample by one step
        np.testing.assert_allclose(outs[True][name], data, rtol=0, atol=LSB)
