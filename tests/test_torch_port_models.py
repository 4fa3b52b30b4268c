"""The port's models against the JAX package's, on the CPU in float32.

Each model is built in flax with seeded random weights, carried across with
``rvc_tpu_torch.convert`` and run on the same numpy inputs. Tolerance:
max abs error <= 1e-4 relative to the output's max magnitude (the two
frameworks sum in different orders; JAX runs at "highest" matmul precision).
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu_torch import convert

REL_TOL = 1e-4


def _random_params(init_fn, *args, seed=0, scale=0.1):
    """Seeded normal values of the shapes ``init_fn`` would create (no
    init program is compiled; every path, including zero-initialized
    biases and flow posts, sees nonzero weights)."""
    shapes = jax.eval_shape(init_fn, *args)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32), shapes)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))


TINY_SYNTH = dict(
    inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2,
    n_layers=2, kernel_size=3, resblock_kernel_sizes=(3, 5),
    resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(8, 4, 2),
    upsample_initial_channel=32, upsample_kernel_sizes=(16, 8, 4),
    spk_embed_dim=4, gin_channels=8, sr=32000,
)


def build_synth_pair(seed=0, flow_layers=2):
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    fm = FlaxSynth(spec_channels=33, segment_size=8, posterior_layers=2,
                   flow_layers=flow_layers, zero_noise=True,
                   text_enc_hidden_dim=768, **TINY_SYNTH)
    t = 12
    rng = np.random.default_rng(seed)
    params = _random_params(
        fm.init,
        {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(rng.normal(size=(1, t, 768)), jnp.float32),
        jnp.asarray([t], jnp.int32), jnp.full((1, t), 100, jnp.int32),
        jnp.full((1, t), 220.0, jnp.float32), jnp.zeros((1, t, 33)),
        jnp.asarray([t], jnp.int32), jnp.zeros((1,), jnp.int32),
        seed=seed + 10)["params"]
    tm = Synthesizer(flow_layers=flow_layers, zero_noise=True,
                     text_enc_hidden_dim=768, **TINY_SYNTH).eval()
    convert.load_into(tm, convert.synthesizer_state_dict(params))
    return fm, params, tm


def test_synthesizer_infer_matches_flax():
    from rvc_tpu.models.synthesizer import Synthesizer as FlaxSynth

    fm, params, tm = build_synth_pair()
    rng = np.random.default_rng(3)
    t = 30
    phone = rng.normal(size=(1, t, 768)).astype(np.float32)
    pitch = rng.integers(1, 255, size=(1, t)).astype(np.int32)
    f0 = (100 + 200 * rng.random((1, t))).astype(np.float32)
    f0[0, t // 2:t // 2 + 4] = 0.0
    lengths = np.array([t - 3], np.int32)
    sid = np.array([1], np.int32)
    o_ref, _ = jax.jit(fm.apply, static_argnames="method")(
                        {"params": params}, jnp.asarray(phone),
                        jnp.asarray(lengths), jnp.asarray(pitch),
                        jnp.asarray(f0), jnp.asarray(sid),
                        method=FlaxSynth.infer,
                        rngs={"noise": jax.random.PRNGKey(0)})
    o, mask = tm.infer(torch.from_numpy(phone), torch.from_numpy(lengths).long(),
                       torch.from_numpy(pitch).long(), torch.from_numpy(f0),
                       torch.from_numpy(sid).long())
    assert o.shape == (1, t * 64, 1)
    assert _rel(o_ref, o.numpy()) <= REL_TOL


def test_hubert_matches_flax():
    from rvc_tpu.embedders.hubert import FlaxHubert, HubertConfig as FHC
    from rvc_tpu_torch.embedders.hubert import Hubert, HubertConfig

    small = dict(hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, conv_dim=(16,) * 7,
                 num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    fm = FlaxHubert(FHC(**small))
    audio = (np.random.default_rng(4).normal(size=(1, 8000)) * 0.3).astype(np.float32)
    params = _random_params(fm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3200)), seed=5)["params"]
    ref = jax.jit(fm.apply)({"params": params}, jnp.asarray(audio))
    tm = Hubert(HubertConfig(**small)).eval()
    convert.load_into(tm, convert.hubert_state_dict(params))
    out = tm(torch.from_numpy(audio))
    assert out.shape == (1, 24, 32)
    assert _rel(ref, out.numpy()) <= REL_TOL


def build_rmvpe_pair(seed=0):
    from rvc_tpu.predictors.rmvpe import E2EModel as FlaxE2E
    from rvc_tpu_torch.predictors.rmvpe import E2EModel

    dims = dict(n_blocks=1, en_de_layers=2, inter_layers=1, en_out_channels=4,
                gru_hidden=16)
    fm = FlaxE2E(**dims)
    variables = _random_params(fm.init, jax.random.PRNGKey(seed),
                               jnp.zeros((1, 32, 128)), seed=seed + 20)
    params = variables["params"]
    stats = _fix_var(variables["batch_stats"])  # running variances > 0
    tm = E2EModel(**dims).eval()
    convert.load_into(tm, convert.rmvpe_state_dict(params, stats))
    return fm, params, stats, tm


def _fix_var(tree):
    if isinstance(tree, dict):
        return {k: (np.abs(v) + 0.5 if k == "var" else _fix_var(v))
                for k, v in tree.items()}
    return tree


def test_e2e_model_matches_flax():
    fm, params, stats, tm = build_rmvpe_pair()
    mel = np.random.default_rng(6).normal(size=(1, 64, 128)).astype(np.float32)
    ref = jax.jit(fm.apply)({"params": params, "batch_stats": stats},
                            jnp.asarray(mel))
    out = tm(torch.from_numpy(mel))
    assert out.shape == (1, 64, 360)
    assert _rel(ref, out.numpy()) <= REL_TOL


def test_mel_and_decode_match_flax():
    from rvc_tpu.predictors.rmvpe import decode_salience as f_decode
    from rvc_tpu.predictors.rmvpe import rmvpe_mel as f_mel
    from rvc_tpu_torch.predictors.rmvpe import decode_salience, rmvpe_mel

    rng = np.random.default_rng(7)
    audio = (0.3 * rng.normal(size=(1, 4000))).astype(np.float32)
    ref = np.asarray(f_mel(jnp.asarray(audio)))
    out = rmvpe_mel(torch.from_numpy(audio)).numpy()
    assert np.abs(ref - out).max() <= 1e-3  # log-mel, abs tolerance
    sal = rng.random((50, 360)).astype(np.float32) ** 4
    sal[:5] *= 0.01  # below threshold -> unvoiced
    np.testing.assert_allclose(np.asarray(f_decode(jnp.asarray(sal))),
                               decode_salience(torch.from_numpy(sal)).numpy(),
                               rtol=1e-5)


def test_builders_refuse_cpu_fallback():
    """Entry points default to the card and raise without one."""
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.embedders.hubert import Hubert
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.predictors.rmvpe import RMVPE

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config(48000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer.from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Hubert.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RMVPE()
    assert dataclasses.asdict(cfg.model)["upsample_rates"] == (12, 10, 2, 2)
