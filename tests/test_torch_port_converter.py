"""The port's VoiceConverter and CLI on the CPU (``--device cpu``).

A small 48 kHz model is written as a reference ``.pth`` and a flat faiss
index beside it; the embedder and RMVPE come from the registry's
random-initialized fallback (no files are staged), seeded the same way for
every run. ``rvc_tpu_torch.cli.main(["infer", ...])`` must write exactly the
samples the port's ``Pipeline.pipeline`` gives on the same loaded models
(after the same 16-bit WAV quantization); ``batch_infer`` writes one output
per input; formant shifting, ``--clean_audio``, the post-FX chain and the
export formats give, through both ``infer`` and ``batch_infer``, the file
the JAX package's ``convert_audio`` writes with the same option (its
synthesis stage stood in by the port's pipeline on the same models, so the
two differ only in what the option does); FLAC export round-trips; and
every command line of the JAX CLI's ``infer`` parses in the port's parser
to the same values.
"""

import argparse
import shutil

import numpy as np
import pytest
import torch

from test_torch_port_pipeline import SYN

CFG_LIST = [1025, 36, *[SYN[k] for k in ("inter_channels", "hidden_channels",
                                         "filter_channels", "n_heads", "n_layers",
                                         "kernel_size")],
            0.0, "1", list(SYN["resblock_kernel_sizes"]),
            [list(d) for d in SYN["resblock_dilation_sizes"]],
            list(SYN["upsample_rates"]), SYN["upsample_initial_channel"],
            list(SYN["upsample_kernel_sizes"]), SYN["spk_embed_dim"],
            SYN["gin_channels"], 48000]


def _write_model(path, use_f0=True):
    """A small model (768-wide content features) in the deployable .pth
    layout: fp16 tensors under "weight", the config list, metadata."""
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    model = Synthesizer(flow_layers=2, use_f0=use_f0,
                        **dict(SYN, text_enc_hidden_dim=768))
    rng = np.random.default_rng(5)
    sd = {}
    for k, v in model.state_dict().items():  # weight-norm gains near 1: audible
        a = (rng.uniform(0.5, 1.5, size=tuple(v.shape)) if k.endswith("weight_g")
             else 0.1 * rng.normal(size=tuple(v.shape)))
        sd[k] = torch.from_numpy(a.astype(np.float16))
    torch.save({"weight": sd, "config": CFG_LIST, "sr": 48000, "f0": int(use_f0),
                "version": "v2", "vocoder": "HiFi-GAN"}, str(path))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from rvc_tpu_torch.utils.audio_io import write_wav
    from rvc_tpu_torch.utils.faiss_io import write_index_flat

    d = tmp_path_factory.mktemp("conv")
    _write_model(d / "model.pth")
    write_index_flat(str(d / "added_model.index"),
                     np.random.default_rng(6).normal(size=(500, 768)).astype(np.float32))
    tt = np.arange(24000) / 16000
    audio = (0.4 * np.sin(2 * np.pi * 200 * tt)
             + 0.05 * np.random.default_rng(7).normal(size=tt.size)).astype(np.float32)
    write_wav(str(d / "in.wav"), audio, 16000)
    return d


LSB = 1.0 / 32768  # one step of a 16-bit WAV
ARGS = ["--pitch", "2", "--index_rate", "0.75", "--protect", "0.33",
        "--f0_method", "rmvpe", "--precision", "fp32", "--device", "cpu"]


def test_cli_infer_equals_pipeline(files, tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.infer.converter import VoiceConverter
    from rvc_tpu_torch.utils.audio_io import load_audio, read_wav, write_wav

    monkeypatch.chdir(tmp_path)  # nothing staged under models/: random embedder, RMVPE
    out = tmp_path / "out.wav"
    torch.manual_seed(0)
    assert cli.main(["infer", "--input_path", str(files / "in.wav"),
                     "--output_path", str(out), "--pth_path", str(files / "model.pth"),
                     "--index_path", str(files), *ARGS]) == 0
    got, sr = read_wav(str(out))

    torch.manual_seed(0)  # the same random embedder and RMVPE
    vc = VoiceConverter(precision="fp32", device="cpu")
    vc.get_vc(str(files / "model.pth"))
    predictors = vc.get_predictors("rmvpe")
    audio = load_audio(str(files / "in.wav"), 16000)
    audio = audio / max(np.abs(audio).max() / 0.95, 1.0)
    ref = vc.pipeline.pipeline(
        audio, sid=0, pitch_shift=2, f0_method="rmvpe",
        index_vectors=vc._load_index(str(files / "added_model.index")),
        index_rate=0.75, protect=0.33, predictors=predictors, filter_radius=3)
    write_wav(str(tmp_path / "ref.wav"), ref, 48000)
    want, _ = read_wav(str(tmp_path / "ref.wav"))
    assert sr == 48000 and vc.pipeline._rmvpe is not None
    assert got.shape == want.shape == (72000,)
    assert np.abs(got).max() > 0.01
    np.testing.assert_array_equal(got, want)


def test_cli_batch_infer_writes_one_output_per_input(files, tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils.audio_io import read_wav, write_wav

    monkeypatch.chdir(tmp_path)
    src = tmp_path / "in"
    src.mkdir()
    for name, n in (("a", 16000), ("b", 27000), ("c", 9000)):
        tt = np.arange(n) / 16000
        write_wav(str(src / f"{name}.wav"), 0.3 * np.sin(2 * np.pi * 150 * tt), 16000)
    (src / "notes.txt").write_text("not audio")
    dst = tmp_path / "out"
    assert cli.main(["batch_infer", "--input_folder", str(src), "--output_folder",
                     str(dst), "--pth_path", str(files / "model.pth"),
                     "--index_path", str(files / "added_model.index"), *ARGS]) == 0
    outs = sorted(p.name for p in dst.iterdir())
    assert outs == ["a_output.wav", "b_output.wav", "c_output.wav"]
    for name, n in (("a", 16000), ("b", 27000), ("c", 9000)):
        data, sr = read_wav(str(dst / f"{name}_output.wav"))
        # whole 10 ms frames of the input padded by 3 s a side, less the pads
        frames = (n + 2 * 48000) // 160
        assert sr == 48000 and data.shape == (frames * 480 - 2 * 144000,)
        assert np.isfinite(data).all() and np.abs(data).max() > 0.01


def test_no_f0_model_converts(files, tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils.audio_io import read_wav

    monkeypatch.chdir(tmp_path)
    _write_model(tmp_path / "nof0.pth", use_f0=False)
    out = tmp_path / "out.wav"
    assert cli.main(["infer", "--input_path", str(files / "in.wav"), "--output_path",
                     str(out), "--pth_path", str(tmp_path / "nof0.pth"), *ARGS]) == 0
    data, sr = read_wav(str(out))
    assert sr == 48000 and data.shape == (72000,) and np.abs(data).max() > 0.01


def _jax_convert(files, tmp_path, out_name, **options):
    """The JAX package's ``convert_audio`` with ``options``, its synthesis
    stage stood in by the port's ``Pipeline.pipeline`` on the models the
    port's CLI builds (the same seed, the same order)."""
    from rvc_tpu.infer.converter import VoiceConverter as JaxConverter
    from rvc_tpu_torch.infer.converter import VoiceConverter

    torch.manual_seed(0)
    vc = VoiceConverter(precision="fp32", device="cpu")
    vc.get_vc(str(files / "model.pth"))
    predictors = vc.get_predictors("rmvpe")
    index = vc._load_index(str(files / "added_model.index"))

    class Synthesis:
        def pipeline(self, audio16, **kw):
            return vc.pipeline.pipeline(audio16, **dict(
                kw, index_vectors=index, predictors=predictors))

    def get_vc(*_args, **_kw):
        jvc.pipeline, jvc.tgt_sr, jvc.use_f0 = Synthesis(), 48000, True

    jvc = JaxConverter(precision="fp32")
    jvc.get_vc = get_vc
    jvc.get_predictors = lambda method: {}
    jvc._load_index = lambda path: None
    return jvc.convert_audio(
        str(files / "in.wav"), str(tmp_path / out_name), str(files / "model.pth"),
        index_path=str(files), pitch=2, f0_method="rmvpe", index_rate=0.75,
        protect=0.33, **options)


OPTION_CASES = [
    (["--formant_shifting", "True", "--formant_timbre", "1.2"], "formant"),
    (["--post_process", "True", "--reverb", "True", "--chorus", "True",
      "--compressor", "True", "--compressor_ratio", "4"], "post-FX"),
    (["--clean_audio", "True"], "clean_audio"),
    (["--export_format", "MP3"], "export format"),
    (["--export_format", "OGG"], "export format"),
]


@pytest.mark.parametrize("flags,match", OPTION_CASES)
def test_unported_options_raise(files, tmp_path, monkeypatch, capsys, flags, match):
    """The options the port once refused (formant shifting, the post-FX
    chain, ``--clean_audio``, MP3 and OGG export) now convert, through
    ``infer`` and ``batch_infer``, to the samples the JAX package writes
    with the same option. Without ``ffmpeg`` (none here) MP3 and OGG keep
    the WAV and say so, as the JAX package does."""
    from rvc_tpu import cli as jax_cli
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils.audio_io import read_wav

    monkeypatch.chdir(tmp_path)
    which = shutil.which  # no ffmpeg, whatever the machine has
    monkeypatch.setattr(shutil, "which",
                        lambda name, *a, **k: None if name == "ffmpeg" else which(name, *a, **k))
    jargs = jax_cli.build_parser().parse_args(
        ["infer", "--input_path", "i", "--output_path", "o", "--pth_path", "m",
         *flags])
    options = {f.lstrip("-"): getattr(jargs, f.lstrip("-")) for f in flags[::2]}
    want_path = _jax_convert(files, tmp_path, "jax.wav", **options)
    want_said = capsys.readouterr().out
    want, _ = read_wav(want_path)
    assert np.abs(want).max() > 0.01

    torch.manual_seed(0)
    out = tmp_path / "out.wav"
    assert cli.main(["infer", "--input_path", str(files / "in.wav"), "--output_path",
                     str(out), "--pth_path", str(files / "model.pth"),
                     "--index_path", str(files), *ARGS, *flags]) == 0
    said = capsys.readouterr().out
    got, sr = read_wav(str(out))
    assert sr == 48000
    # the option's float64 steps differ from numpy's in the last bits, which
    # may move a sample across a 16-bit step of the WAV
    np.testing.assert_allclose(got, want, rtol=0, atol=LSB)

    src = tmp_path / "in"
    src.mkdir()
    (src / "in.wav").write_bytes((files / "in.wav").read_bytes())
    torch.manual_seed(0)
    assert cli.main(["batch_infer", "--input_folder", str(src), "--output_folder",
                     str(tmp_path / "b"), "--pth_path", str(files / "model.pth"),
                     "--index_path", str(files), *ARGS, *flags]) == 0
    said += capsys.readouterr().out
    got, _ = read_wav(str(tmp_path / "b" / "in_output.wav"))
    np.testing.assert_allclose(got, want, rtol=0, atol=LSB)
    if "--export_format" in flags:
        line = f"ffmpeg unavailable; keeping WAV for requested {flags[-1]}"
        assert line in want_said and said.count(line) == 2
        assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["in_output.wav"]


def test_flac_export_round_trips(files, tmp_path, monkeypatch):
    """``--export_format FLAC`` writes, beside the WAV, the FLAC the JAX
    package's ``_export`` writes from it, byte for byte; it reads back as
    the WAV's samples."""
    from rvc_tpu.infer.converter import VoiceConverter as JaxConverter
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils.audio_io import read_wav
    from rvc_tpu_torch.utils.native import flac_read

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.wav"
    assert cli.main(["infer", "--input_path", str(files / "in.wav"), "--output_path",
                     str(out), "--pth_path", str(files / "model.pth"), *ARGS,
                     "--export_format", "FLAC"]) == 0
    wav, sr = read_wav(str(out))
    flac, flac_sr = flac_read(str(tmp_path / "out.flac"))
    assert flac_sr == sr == 48000 and flac.shape == wav.shape == (72000,)
    np.testing.assert_array_equal(flac, wav)
    (tmp_path / "jax").mkdir()
    copy = tmp_path / "jax" / "out.wav"
    copy.write_bytes(out.read_bytes())
    assert JaxConverter._export(str(copy), "FLAC") == str(tmp_path / "jax" / "out.flac")
    assert (tmp_path / "jax" / "out.flac").read_bytes() == (
        tmp_path / "out.flac").read_bytes()


def _infer_argv(parser):
    """Every option of a parser's ``infer`` subcommand with a value other
    than its default (a choice, a flipped boolean, a shifted number)."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    argv = ["infer"]
    for act in sub.choices["infer"]._actions:
        if not act.option_strings or act.dest == "help":
            continue
        flag = act.option_strings[0]
        if act.choices:
            value = list(act.choices)[-1]
        elif act.type is int:
            value = str((act.default or 0) + 3)
        elif act.type is float:
            value = str((act.default or 0.0) + 0.25)
        elif act.default is False:
            value = "True"
        else:
            value = f"/x/{act.dest}"
        argv += [flag, value]
    return argv


def test_jax_cli_infer_arguments_parse_in_the_port():
    from rvc_tpu.cli import build_parser as jax_parser
    from rvc_tpu_torch.cli import build_parser

    argv = _infer_argv(jax_parser())
    ref = vars(jax_parser().parse_args(argv))
    got = vars(build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref
    assert len(got) > 60


def test_audio_io_and_split_match_jax(tmp_path):
    """FLAC through the repo's codec, resampling and the silence split and
    merge give what the JAX package's give."""
    from rvc_tpu.utils import audio_io as ja
    from rvc_tpu.utils import split_audio as js
    from rvc_tpu_torch.utils import audio_io, split_audio

    rng = np.random.default_rng(11)
    audio = (0.3 * rng.normal(size=(60000, 2))).astype(np.float32)
    audio[15000:45000] = 0.0  # a silent stretch for the split
    path = str(tmp_path / "x.flac")
    audio_io.save_audio(path, audio, 44100)
    got, sr = audio_io.read_audio(path)
    want, _ = ja.read_audio(path)
    assert sr == 44100 and got.shape == audio.shape
    np.testing.assert_array_equal(got, want)
    mono = audio_io.load_audio(path, 16000)
    np.testing.assert_allclose(mono, ja.load_audio(path, 16000), rtol=0, atol=1e-6)
    segs, iv = split_audio.process_audio(mono, 16000)
    jsegs, jiv = js.process_audio(mono, 16000)
    np.testing.assert_array_equal(iv, jiv)
    assert len(segs) == 2
    new = [np.repeat(s, 3) for s in segs]
    np.testing.assert_array_equal(split_audio.merge_audio(segs, new, iv, 16000, 48000),
                                  js.merge_audio(jsegs, new, jiv, 16000, 48000))


def test_split_audio_option_converts(files, tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils.audio_io import read_wav, write_wav
    from rvc_tpu_torch.utils.split_audio import process_audio

    monkeypatch.chdir(tmp_path)
    tt = np.arange(40000) / 16000
    audio = 0.4 * np.sin(2 * np.pi * 200 * tt)
    audio[14000:26000] = 0.0
    write_wav(str(tmp_path / "gap.wav"), audio, 16000)
    out = tmp_path / "out.wav"
    assert cli.main(["infer", "--input_path", str(tmp_path / "gap.wav"),
                     "--output_path", str(out), "--pth_path", str(files / "model.pth"),
                     "--split_audio", "True", *ARGS]) == 0
    data, sr = read_wav(str(out))
    assert sr == 48000 and abs(data.shape[0] - 120000) <= 960
    _, iv = process_audio(audio.astype(np.float32), 16000)
    assert len(iv) == 2
    gap = 3 * (iv[1][0] - iv[0][1])  # restored as zeros between the segments
    silent = np.flatnonzero(np.abs(data) > 0)
    assert np.diff(silent).max() - 1 >= gap - 960
