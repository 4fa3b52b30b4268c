"""The port's dataset preprocessing and configuration against the JAX
package's, on the CPU.

- ``config.json``: ``get_config(sr).to_json()`` is JAX's text, byte for
  byte, for 32, 40 and 48 kHz, and ``from_json`` reads it (and a
  reference-style JSON with extra keys) back;
- the C++ engine's ``frame_rms`` and ``normalize_blend``: the same samples,
  None without the library, ``ValueError`` on a rejected take;
- the ``Slicer``'s chunks, exactly, over leading, short, medium, long and
  trailing silences; ``spectral_gate`` within 1e-6;
- ``preprocess_training_set`` on a seeded dataset (16-bit stereo and float
  mono files, speaker subfolders, one take above peak 2.5) in each cut mode,
  with effects and noise reduction on and off: the same file names and
  ``model_info.json`` text, samples within 1e-6; and the ``preprocess``
  subcommand;
- the ``--use_orbax`` refusal names what the port writes instead.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import dataclasses
import json
import os

import numpy as np
import pytest

SR_IN = 22050


def _tone(sec, sr, f=220.0, amp=0.4):
    t = np.arange(int(sec * sr)) / sr
    return (amp * np.sin(2 * np.pi * f * t) * (1 + 0.1 * np.sin(2 * np.pi * 5 * t))
            ).astype(np.float32)


def _silence(sec, sr, rng):
    return (1e-4 * rng.normal(size=int(sec * sr))).astype(np.float32)


def _speech(sr, rng, leading=1.2):
    """Tones between silences the Slicer treats in each of its ways:
    leading, short (<= max_sil_kept), medium (<= 2x), long, trailing."""
    parts = [_silence(leading, sr, rng), _tone(2.0, sr)]
    for sec, f in ((0.5, 250.0), (0.8, 180.0), (1.5, 300.0)):
        parts += [_silence(sec, sr, rng), _tone(2.0, sr, f)]
    parts.append(_silence(0.6, sr, rng))
    return np.concatenate(parts) + (0.002 * rng.normal(size=sum(map(len, parts)))
                                    ).astype(np.float32)


def write_dataset(root, seed=0):
    """Root files (sid 0) and a ``spk_1`` subfolder: a 16-bit stereo file,
    float mono files, and one float take peaking at 3.0 (rejected when the
    effects are on)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "spk_1"), exist_ok=True)
    left, right = _speech(SR_IN, rng), _speech(SR_IN, rng, leading=0.7)
    st = np.stack([left[:len(right)], right], axis=1)
    wavfile.write(os.path.join(root, "a.wav"), SR_IN,
                  (np.clip(st, -1, 1) * 32767).astype(np.int16))
    wavfile.write(os.path.join(root, "spk_1", "b.wav"), SR_IN, _speech(SR_IN, rng))
    wavfile.write(os.path.join(root, "spk_1", "c.wav"), SR_IN,
                  _tone(4.0, SR_IN, 200.0, amp=0.5))
    wavfile.write(os.path.join(root, "spk_1", "loud.wav"), SR_IN,
                  _tone(4.0, SR_IN, amp=3.0))


# -- configuration --------------------------------------------------------------

@pytest.mark.parametrize("sr", [32000, 40000, 48000])
def test_config_json_is_jax_text(sr):
    from rvc_tpu.configs import get_config as jax_config
    from rvc_tpu_torch.configs import ExperimentConfig, get_config

    text = get_config(sr).to_json()
    assert text == jax_config(sr).to_json()
    assert ExperimentConfig.from_json(text) == get_config(sr)


def test_config_reads_reference_style_json():
    from rvc_tpu.configs import ExperimentConfig as JaxConfig
    from rvc_tpu_torch.configs import ExperimentConfig, TrainConfig

    raw = json.loads(ExperimentConfig().to_json())
    raw["train"]["fp16_run"] = True  # a key the reference has and we do not
    raw["model"]["upsample_rates"] = [10, 10, 2, 2]
    raw["extra_section"] = {"x": 1}
    text = json.dumps(raw)
    cfg = ExperimentConfig.from_json(text)
    assert cfg.model.upsample_rates == (10, 10, 2, 2)
    assert cfg.to_json() == JaxConfig.from_json(text).to_json()
    # the four fields the JAX package's TrainConfig carries
    t = TrainConfig()
    assert (t.log_interval, t.seed, t.betas, t.eps) == (200, 1234, (0.8, 0.99), 1e-9)


def test_use_orbax_refusal_names_the_pth_files():
    from rvc_tpu_torch.configs import get_config
    from rvc_tpu_torch.train.trainer import Trainer, TrainerArgs

    with pytest.raises(NotImplementedError, match="will not have orbax"):
        Trainer(get_config(48000), TrainerArgs(exp_dir="unused", use_orbax=True,
                                               device="cpu"))


# -- the C++ engine ---------------------------------------------------------------

def test_native_frame_rms_and_blend_match_jax(monkeypatch):
    from rvc_tpu.utils import native as jn
    from rvc_tpu_torch.utils import native

    x = (0.3 * np.random.default_rng(1).normal(size=20011)).astype(np.float32)
    np.testing.assert_array_equal(native.frame_rms(x, 960, 240), jn.frame_rms(x, 960, 240))
    np.testing.assert_array_equal(native.normalize_blend(x, 0.9, 0.75),
                                  jn.normalize_blend(x, 0.9, 0.75))
    with pytest.raises(ValueError, match="rejected"):
        native.normalize_blend(x * 20.0)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.frame_rms(x, 960, 240) is None
    assert native.normalize_blend(x) is None


# -- slicer, spectral gate ----------------------------------------------------------

@pytest.mark.parametrize("leading", [0.7, 1.2, 0.0])
def test_slicer_chunks_equal_jax(leading):
    from rvc_tpu.train.preprocess import Slicer as JaxSlicer
    from rvc_tpu_torch.train.preprocess import Slicer

    sr = 16000
    w = _speech(sr, np.random.default_rng(2), leading=leading)
    kw = dict(threshold=-42, min_length=1500, min_interval=400, hop_size=15,
              max_sil_kept=500)
    ref = JaxSlicer(sr, **kw).slice(w)
    out = Slicer(sr, **kw).slice(w)
    assert len(out) == len(ref) >= 4
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    short = w[:sr]  # under min_length: one chunk, the input
    assert len(Slicer(sr, **kw).slice(short)) == 1


def test_spectral_gate_matches_jax():
    from rvc_tpu.train.preprocess import spectral_gate as jax_gate
    from rvc_tpu_torch.train.preprocess import spectral_gate

    rng = np.random.default_rng(3)
    w = _speech(16000, rng) + (0.01 * rng.normal(size=1)).astype(np.float32)
    for strength in (0.7, 0.3):
        ref = jax_gate(w, 16000, strength)
        out = spectral_gate(w, 16000, strength)
        assert out.dtype == np.float32 and out.shape == w.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


# -- preprocess_training_set -------------------------------------------------------

MODES = [(cut, fx, nr) for cut in ("Skip", "Simple", "Automatic")
         for fx in (True, False) for nr in (False, True)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dataset"))
    write_dataset(root)
    return root


@pytest.fixture(scope="module")
def jax_runs(dataset, tmp_path_factory):
    """JAX's preprocess_training_set for each mode, computed on first use."""
    from rvc_tpu.train.preprocess import preprocess_training_set

    cache = {}

    def run(mode):
        if mode not in cache:
            cut, fx, nr = mode
            exp = str(tmp_path_factory.mktemp("jax_exp"))
            hours = preprocess_training_set(dataset, 32000, exp, cut_preprocess=cut,
                                            process_effects=fx, noise_reduction=nr,
                                            num_workers=2)
            cache[mode] = (exp, hours)
        return cache[mode]

    return run


def _listing(exp):
    return {d: sorted(os.listdir(os.path.join(exp, d)))
            for d in ("sliced_audios", "sliced_audios_16k")}


def _same_outputs(exp, ref_exp):
    from scipy.io import wavfile

    assert _listing(exp) == _listing(ref_exp)
    with open(os.path.join(exp, "model_info.json")) as f, \
            open(os.path.join(ref_exp, "model_info.json")) as g:
        assert f.read() == g.read()
    for d, names in _listing(exp).items():
        for n in names:
            sr_a, a = wavfile.read(os.path.join(exp, d, n))
            sr_b, b = wavfile.read(os.path.join(ref_exp, d, n))
            assert sr_a == sr_b and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_preprocess_writes_what_jax_writes(dataset, jax_runs, tmp_path, mode):
    from rvc_tpu_torch.train.preprocess import preprocess_training_set

    cut, fx, nr = mode
    ref_exp, ref_hours = jax_runs(mode)
    exp = str(tmp_path / "exp")
    hours = preprocess_training_set(dataset, 32000, exp, cut_preprocess=cut,
                                    process_effects=fx, noise_reduction=nr,
                                    num_workers=2)
    assert hours == ref_hours
    _same_outputs(exp, ref_exp)
    names = _listing(exp)["sliced_audios"]
    assert {n.split("_")[0] for n in names} == {"0", "1"}
    # the loud take (idx0 3) is rejected only when the effects are on
    assert any(n.startswith("1_3_") for n in names) == (not fx)


def test_preprocess_cli_equals_jax(dataset, jax_runs, tmp_path, monkeypatch):
    from rvc_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["preprocess", "--model_name", "m", "--dataset_path", dataset,
                     "--sample_rate", "32000", "--cut_preprocess", "Automatic",
                     "--process_effects", "True", "--noise_reduction", "True",
                     "--cpu_cores", "2"]) == 0
    ref_exp, _ = jax_runs(("Automatic", True, True))
    _same_outputs(str(tmp_path / "logs" / "m"), ref_exp)


def test_preprocess_config_fields_feed_the_trainer():
    """The training preset of 32 and 40 kHz slices 12800 samples, as the
    JAX package's."""
    from rvc_tpu.configs import get_config as jax_config
    from rvc_tpu_torch.configs import get_config

    for sr in (32000, 40000, 48000):
        assert dataclasses.asdict(get_config(sr).train) == dataclasses.asdict(
            jax_config(sr).train)


@pytest.mark.parametrize("mode", ["preprocess", "extract", "index", "train"])
def test_cli_subcommand_takes_the_jax_flags(mode):
    """Every flag of the JAX CLI's subcommand, with its default and
    choices, plus ``--device`` (preprocess runs on the host)."""
    import argparse

    from rvc_tpu.cli import build_parser as jax_parser
    from rvc_tpu_torch.cli import build_parser

    def options(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction)).choices[mode]
        return {s: (a.dest, a.default, a.choices) for a in sub._actions
                for s in a.option_strings if s not in ("-h", "--help")}

    ours, theirs = options(build_parser()), options(jax_parser())
    assert {k: v for k, v in ours.items() if k in theirs} == theirs
    assert set(ours) - set(theirs) == (set() if mode == "preprocess" else {"--device"})
