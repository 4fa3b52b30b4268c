"""The whole ported slice on the CPU against the JAX package.

Same tiny models (flax weights carried across with ``rvc_tpu_torch.convert``),
same audio and index: JAX ``Pipeline(precision="fp32")`` + ``set_rmvpe`` +
``voice_conversion_fused`` against the port's. Tolerances: the coarse
(255-bin) pitch must be exactly equal, the f0 within 1e-3 relative, and the
audio within 1e-3 absolute and within 1e-3 of the reference's peak. Also
checked here: the entry points refuse to
fall back to the CPU, and no module of the port imports JAX, flax or the
JAX package.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert
from test_torch_port_models import _fix_var, _random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HUB = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
           conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
           num_conv_pos_embedding_groups=4)
SYN = dict(inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
           n_layers=2, kernel_size=3, resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(12, 10, 2, 2),
           upsample_initial_channel=32, upsample_kernel_sizes=(24, 20, 4, 4),
           spk_embed_dim=4, gin_channels=8, sr=48000, text_enc_hidden_dim=32)
E2E = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4,
           gru_hidden=16)


@pytest.fixture(scope="module")
def pipes():
    from rvc_tpu.embedders.hubert import FlaxHubert, HubertConfig as FHC
    from rvc_tpu.infer.pipeline import Pipeline as JaxPipeline
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu.predictors.rmvpe import RMVPE as JaxRMVPE
    from rvc_tpu.predictors.rmvpe import E2EModel as FlaxE2E
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.infer.pipeline import Pipeline
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.rmvpe import RMVPE, E2EModel

    t = 12
    fsyn = FlaxSynth(spec_channels=33, segment_size=8, posterior_layers=2,
                     flow_layers=2, zero_noise=True, **SYN)
    sp = _random_params(
        fsyn.init, {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, 32)), jnp.asarray([t], jnp.int32),
        jnp.full((1, t), 100, jnp.int32), jnp.full((1, t), 220.0, jnp.float32),
        jnp.zeros((1, t, 33)), jnp.asarray([t], jnp.int32),
        jnp.zeros((1,), jnp.int32), seed=11)["params"]
    fhub = FlaxHubert(FHC(**HUB))
    hp = _random_params(fhub.init, jax.random.PRNGKey(0), jnp.zeros((1, 3200)),
                        seed=12)["params"]
    fe2e = FlaxE2E(**E2E)
    ev = _random_params(fe2e.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 128)),
                        seed=13)
    stats = _fix_var(ev["batch_stats"])

    jpipe = JaxPipeline(48000, fsyn, sp, fhub, hp, upsample_factor=480,
                        precision="fp32")
    jpipe.set_rmvpe(JaxRMVPE(ev["params"], stats, model=fe2e))

    syn = Synthesizer(flow_layers=2, zero_noise=True, **SYN)
    convert.load_into(syn, convert.synthesizer_state_dict(sp))
    hub = Hubert(HubertConfig(**HUB))
    convert.load_into(hub, convert.hubert_state_dict(hp))
    e2e = E2EModel(**E2E)
    convert.load_into(e2e, convert.rmvpe_state_dict(ev["params"], stats))
    tpipe = Pipeline(48000, syn, hub, upsample_factor=480, precision="fp32",
                     device="cpu")
    tpipe.set_rmvpe(RMVPE(e2e, device="cpu"))
    return jpipe, tpipe


def _inputs():
    rng = np.random.default_rng(21)
    tt = np.arange(24000) / 16000
    audio = (0.4 * np.sin(2 * np.pi * 220 * tt)
             + 0.05 * rng.normal(size=tt.size)).astype(np.float32)
    index = rng.normal(size=(600, 32)).astype(np.float32)
    return audio, index


KW = dict(sid=1, index_rate=0.75, protect=0.33, pitch_shift=2, filter_radius=3)


def test_fused_conversion_matches_jax(pipes):
    jpipe, tpipe = pipes
    audio, index = _inputs()
    ref = jpipe.voice_conversion_fused(audio, index_vectors=jnp.asarray(index),
                                       rng=jax.random.PRNGKey(0), **KW)
    out = tpipe.voice_conversion_fused(audio, index_vectors=index, **KW)
    assert out.shape == ref.shape == (150 * 480,)
    assert np.isfinite(out).all()
    err, peak = float(np.abs(ref - out).max()), float(np.abs(ref).max())
    # the reference is far from silence (peak about 0.038), and the error is
    # held both absolutely and relative to that peak
    assert peak >= 0.02, f"reference peak {peak}"
    assert err <= 1e-3, f"max abs err {err} (peak {peak})"
    assert err <= 1e-3 * peak, f"max abs err {err} > 1e-3 x peak {peak}"


def test_fused_pitch_quantization_matches_jax(pipes):
    """Coarse pitch exactly equal, f0 close: the device f0 chain (RMVPE,
    median filter, shift, rint quantization) seen through _convert_core."""
    jpipe, tpipe = pipes
    audio, index = _inputs()
    from rvc_tpu.predictors.rmvpe import RMVPE as JaxRMVPE

    j_core, t_core = jpipe._convert_core, tpipe._convert_core
    try:
        jpipe._convert_core = lambda sp, ep, a, pitch, pitchf, *r, **k: jnp.stack(
            [pitch.astype(jnp.float32), pitchf])[None, :, 0]
        jpipe.set_rmvpe(JaxRMVPE(jpipe._rmvpe.params, jpipe._rmvpe.batch_stats,
                                 model=jpipe._rmvpe.model))
        tpipe._convert_core = lambda a, pitch, pitchf, *r, **k: torch.stack(
            [pitch.float(), pitchf])[None, :, 0]
        ref = jpipe.voice_conversion_fused(audio, index_vectors=None,
                                           rng=jax.random.PRNGKey(0), **KW)
        out = tpipe.voice_conversion_fused(audio, index_vectors=None, **KW)
    finally:
        jpipe._convert_core, tpipe._convert_core = j_core, t_core
        jpipe.set_rmvpe(JaxRMVPE(jpipe._rmvpe.params, jpipe._rmvpe.batch_stats,
                                 model=jpipe._rmvpe.model))
    assert ref.shape == out.shape == (2, 200)
    np.testing.assert_array_equal(ref[0], out[0])
    assert (ref[1] > 0).any()
    np.testing.assert_allclose(ref[1], out[1], rtol=1e-3, atol=1e-3)


def test_stream_matches_single_requests(pipes):
    _, tpipe = pipes
    audio, index = _inputs()
    segs = [audio, audio[:20000]]
    outs = tpipe.voice_conversion_fused_stream(segs, index_vectors=index, seed=5,
                                               **KW)
    singles = [tpipe.voice_conversion_fused(
        s, index_vectors=index, generator=torch.Generator().manual_seed(5 + i), **KW)
        for i, s in enumerate(segs)]
    assert [o.shape for o in outs] == [s.shape for s in singles]
    for o, s in zip(outs, singles):
        np.testing.assert_array_equal(o, s)


def test_pipeline_refuses_cpu_fallback():
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig
    from rvc_tpu_torch.infer.pipeline import Pipeline
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    syn = Synthesizer(flow_layers=1, **SYN)
    hub = Hubert(HubertConfig(**HUB))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(48000, syn, hub, upsample_factor=480)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(48000, syn, hub, upsample_factor=480, device="cuda")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(os.path.join(REPO, "rvc_tpu_torch")):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    rel = {os.path.relpath(f, REPO) for f in files}
    for mod in ("cli.py", "infer/converter.py", "infer/pipeline.py",
                "utils/checkpoints.py", "utils/faiss_io.py", "utils/audio_io.py",
                "utils/native.py", "utils/split_audio.py", "predictors/bucketing.py",
                "predictors/f0_extractor.py", "models/generators/hifigan.py",
                "parallel/mesh.py", "ui/app.py", "ui/tabs.py", "ui/gradio_lite.py",
                "ui/i18n.py", "utils/downloads.py", "utils/tts.py",
                "utils/link_resolver.py", "utils/http_server.py"):
        assert f"rvc_tpu_torch/{mod}" in rel, mod
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "rvc_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {name}"


def test_port_package_imports_without_jax(tmp_path):
    """Importing every module of the port leaves JAX and the JAX package
    out of sys.modules, and starts no thread (no server) and no process
    (checked in a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import rvc_tpu_torch\n"
        "for m in pkgutil.walk_packages(rvc_tpu_torch.__path__, 'rvc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'rvc_tpu')]\n"
        "assert not bad, bad\n"
        "import multiprocessing, threading\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not multiprocessing.active_children()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
