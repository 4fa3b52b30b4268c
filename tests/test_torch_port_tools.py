"""The port's offline tools on the CPU against the JAX package's.

``model_blender`` and ``model_information`` on small ``.pth`` files (the
JAX blend, an ``.npz``, carried across with ``convert.synthesizer_state_dict``;
weights within 1e-6), ``analyze_audio``'s seven statistics (within 1e-4
relative), presets, ``inspect_artifacts``, ``extras``, ``py_kill`` and
``slice_file`` (equal), the four tool subcommands' flags, and the port's
``check_environment`` and profiling helpers without a card.
"""

import _torch_threads  # noqa: F401  one CPU thread a process (see the module)

import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_port_pipeline import SYN


def _write_model(path, spk=4, sr=48000, plain=(), first_kernel=24, seed=5):
    """A small model in the deployable ``.pth`` layout; ``plain`` lists
    weight-normalized modules stored as one plain ``weight``; ``sr=None``
    leaves the rate out."""
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    syn = dict(SYN, text_enc_hidden_dim=768, spk_embed_dim=spk,
               upsample_kernel_sizes=(first_kernel, 20, 4, 4))
    model = Synthesizer(flow_layers=2, use_f0=True, **syn)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = (rng.uniform(0.5, 1.5, size=tuple(v.shape)) if k.endswith("weight_g")
             else 0.1 * rng.normal(size=tuple(v.shape)))
        sd[k] = torch.from_numpy(a.astype(np.float16))
    for base in plain:
        g, v = sd.pop(f"{base}.weight_g").float(), sd.pop(f"{base}.weight_v").float()
        norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
        sd[f"{base}.weight"] = (g * v / norm).half()
    config = [1025, 36, *[syn[k] for k in ("inter_channels", "hidden_channels",
                                             "filter_channels", "n_heads", "n_layers",
                                             "kernel_size")],
              0.0, "1", list(syn["resblock_kernel_sizes"]),
              [list(d) for d in syn["resblock_dilation_sizes"]],
              list(syn["upsample_rates"]), syn["upsample_initial_channel"],
              list(syn["upsample_kernel_sizes"]), spk, syn["gin_channels"],
              sr or 48000]
    cpt = {"weight": sd, "config": config, "f0": 1, "version": "v2",
           "vocoder": "HiFi-GAN", "author": "seed"}
    if sr:
        cpt["sr"] = sr
    torch.save(cpt, str(path))
    return str(path)


PLAIN = ("flow.flows.2.enc.in_layers.1", "dec.resblocks.0.convs1.0", "dec.ups.1")


@pytest.mark.parametrize("case", ["equal", "speakers", "plain"])
def test_model_blender_matches_jax(tmp_path, monkeypatch, case):
    from rvc_tpu.utils.model_tools import model_blender as jax_blender
    from rvc_tpu_torch import convert
    from rvc_tpu_torch.utils.checkpoints import (build_synthesizer, load_checkpoint,
                                                 load_rvc_pth)
    from rvc_tpu_torch.utils.model_tools import model_blender

    monkeypatch.chdir(tmp_path)
    a = _write_model(tmp_path / "a.pth", plain=PLAIN if case == "plain" else ())
    b = _write_model(tmp_path / "b.pth", spk=6 if case == "speakers" else 4, seed=6)
    want_path = jax_blender("mix", a, b, 0.3, output_dir=str(tmp_path / "jax"))
    tree, want_meta = load_checkpoint(want_path)
    want = convert.synthesizer_state_dict(tree)
    out = model_blender("mix", a, b, 0.3, output_dir=str(tmp_path / "port"))
    assert out == str(tmp_path / "port" / "mix.pth")
    got, meta = load_rvc_pth(out)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ("blended_from", "blend_ratio", "name", "sr", "f0", "version",
              "vocoder", "author"):
        assert meta.get(k, want_meta.get(k)) == want_meta[k], k
    cpt = torch.load(out, weights_only=True)
    assert cpt["blended_from"] == ["a.pth", "b.pth"] and cpt["blend_ratio"] == 0.3
    model, cfg, _ = build_synthesizer(got, meta, device="cpu")  # deployable
    assert cfg.model.spk_embed_dim == 4 and cfg.data.sample_rate == 48000
    if case == "plain":
        # as in JAX, a plain weight is folded (g = its norm) before the
        # blend, so the blend is not the blend of the plain weights
        sd_a = torch.load(a, weights_only=True)["weight"]
        sd_b = torch.load(b, weights_only=True)["weight"]
        key = "dec.resblocks.0.convs1.0"
        v_b = sd_b[f"{key}.weight_v"].float()
        w_b = sd_b[f"{key}.weight_g"].float() * v_b / v_b.pow(2).sum((1, 2), True).sqrt()
        plain_blend = 0.3 * sd_a[f"{key}.weight"].float() + 0.7 * w_b
        eff = model.state_dict()
        v = eff[f"{key}.weight_v"]
        w = eff[f"{key}.weight_g"] * v / v.pow(2).sum((1, 2), True).sqrt()
        assert torch.abs(w - plain_blend).max() > 1e-3


@pytest.mark.parametrize("case", ["rates", "missing"])
def test_model_blender_checks_rates_as_jax(tmp_path, capsys, case):
    from rvc_tpu.utils.model_tools import model_blender as jax_blender
    from rvc_tpu_torch.utils.model_tools import model_blender

    a = _write_model(tmp_path / "a.pth")
    if case == "rates":
        b = _write_model(tmp_path / "b.pth", sr=40000, seed=6)
        for blend in (jax_blender, model_blender):
            with pytest.raises(ValueError, match="different sample rates"):
                blend("mix", a, b, 0.5, output_dir=str(tmp_path))
        return
    b = _write_model(tmp_path / "b.pth", sr=None, first_kernel=22, seed=6)
    jax_blender("mix", a, b, 0.5, output_dir=str(tmp_path / "jax"))
    want = capsys.readouterr().out
    model_blender("mix", a, b, 0.5, output_dir=str(tmp_path / "port"))
    got = capsys.readouterr().out
    line = ("model_blender: WARNING — sample-rate metadata missing on one model(s);"
            " blending without the rate compatibility check")
    assert line in want and line in got


@pytest.mark.parametrize("plain", [(), PLAIN])
def test_model_information_matches_jax(tmp_path, capsys, plain):
    from rvc_tpu.utils.model_tools import model_information as jax_info
    from rvc_tpu_torch.utils.model_tools import model_information

    path = _write_model(tmp_path / "m.pth", plain=plain)
    want = jax_info(path)
    want_said = capsys.readouterr().out
    got = model_information(path)
    assert got == want and got["parameters"] > 0
    assert capsys.readouterr().out == want_said


def test_change_model_info(tmp_path):
    from rvc_tpu.utils.checkpoints import load_checkpoint as jax_load
    from rvc_tpu.utils.model_tools import change_model_info as jax_change
    from rvc_tpu.utils.model_tools import model_blender as jax_blender
    from rvc_tpu_torch.utils.model_tools import change_model_info

    a = _write_model(tmp_path / "a.pth")
    change_model_info(a, author="someone", name="voice")
    cpt = torch.load(a, weights_only=True)
    assert cpt["author"] == "someone" and cpt["name"] == "voice" and "weight" in cpt
    npz = jax_blender("mix", a, a, 0.5, output_dir=str(tmp_path))
    want = tmp_path / "want.npz"
    want.write_bytes(open(npz, "rb").read())
    jax_change(str(want), author="x")
    change_model_info(npz, author="x")
    (tw, mw), (tg, mg) = jax_load(str(want)), jax_load(npz)
    assert mg == mw and mg["author"] == "x"


def _tone_file(path, sr=16000, seconds=2.0, seed=0):
    """A 300 Hz tone, 2 s on and 0.8 s off, over a faint noise."""
    from rvc_tpu_torch.utils.audio_io import write_wav

    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * 300 * t) * (t % 2.8 < 2.0) + 0.002 * rng.normal(size=t.size)
    write_wav(str(path), x.astype(np.float32), sr)
    return str(path)


def test_analyze_audio_matches_jax(tmp_path, monkeypatch, capsys):
    from rvc_tpu.utils.analyzer import analyze_audio as jax_analyze
    from rvc_tpu_torch.utils.analyzer import analyze_audio

    path = _tone_file(tmp_path / "a.wav", sr=22050)
    want, _ = jax_analyze(path)
    got, plot = analyze_audio(path, str(tmp_path / "p.png"), device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-9), k
    assert plot == str(tmp_path / "p.png") and os.path.getsize(plot) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # no plotting library
    capsys.readouterr()
    got2, plot2 = analyze_audio(path, str(tmp_path / "q.png"), device="cpu")
    assert plot2 is None and got2 == got
    assert "plot skipped" in capsys.readouterr().out


def test_presets_round_trip(tmp_path):
    from rvc_tpu.utils import presets as jax_presets
    from rvc_tpu_torch.utils import presets

    assert presets.PRESET_KEYS == jax_presets.PRESET_KEYS
    params = {"pitch": 3, "reverb": True, "reverb_room_size": 0.8,
              "model_path": "not a preset key"}
    path = presets.save_preset("p", params, preset_dir=str(tmp_path))
    assert presets.load_preset("p", preset_dir=str(tmp_path)) == {
        "pitch": 3, "reverb": True, "reverb_room_size": 0.8}
    assert jax_presets.load_preset(path) == presets.load_preset(path)
    assert presets.list_presets(str(tmp_path)) == ["p"]
    assert presets.list_presets(str(tmp_path / "none")) == []


def test_inspect_artifacts_and_extras_match_jax(tmp_path, capsys):
    from rvc_tpu.utils import extras as jax_extras
    from rvc_tpu.utils import inspect_artifacts as jax_inspect
    from rvc_tpu_torch.utils import extras, inspect_artifacts

    np.save(tmp_path / "f.npy", np.zeros((3, 4), np.float32))
    np.savez(tmp_path / "t.npz", a=np.ones(2), __meta__=np.frombuffer(b'{"x": 1}', np.uint8))
    model = _write_model(tmp_path / "m.pth")
    paths = [str(tmp_path / n) for n in ("f.npy", "t.npz", "x.txt", "none.npy")] + [model]
    (tmp_path / "x.txt").write_text("")
    assert jax_inspect.main(paths) == inspect_artifacts.main(paths) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:] and len(out) > 10
    assert inspect_artifacts.main([]) == 1
    for w in (0.25, 1.0, 45.0):
        s = extras.log_sigma_for_weight(w)
        assert s == jax_extras.log_sigma_for_weight(w)
        assert extras.weight_for_log_sigma(s) == pytest.approx(w)
    with pytest.raises(ValueError):
        extras.log_sigma_for_weight(0.0)


def test_py_kill_finds_and_signals_as_jax(tmp_path):
    import json

    from rvc_tpu.utils import py_kill as jax_kill
    from rvc_tpu_torch.utils import py_kill

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        for name, pid in (("live", child.pid), ("me", os.getpid()), ("gone", 2 ** 22 + 7)):
            (tmp_path / name).mkdir()
            (tmp_path / name / "heartbeat.json").write_text(json.dumps({"pid": pid}))
        (tmp_path / "bad").mkdir()
        (tmp_path / "bad" / "heartbeat.json").write_text("{")
        pids = py_kill.framework_pids(str(tmp_path))
        assert pids == jax_kill.framework_pids(str(tmp_path)) == [child.pid]
        assert child.pid in py_kill.all_python_pids()
        assert py_kill.kill_pids(pids, signal.SIGTERM) == 1
        assert child.wait(timeout=30) == -signal.SIGTERM
    finally:
        child.kill()
        child.wait(timeout=30)


@pytest.mark.parametrize("mode", ["fixed", "silence"])
def test_slice_file_matches_jax(tmp_path, mode):
    from rvc_tpu.utils.slice_gui import slice_file as jax_slice
    from rvc_tpu_torch.utils.audio_io import read_wav
    from rvc_tpu_torch.utils.blender_gui import normalize_sr
    from rvc_tpu_torch.utils.slice_gui import slice_file

    path = _tone_file(tmp_path / "take.wav", sr=44100, seconds=9.0)
    want = jax_slice(path, str(tmp_path / "jax"), mode=mode, slice_ms=2000,
                     sample_rate=40000)
    got = slice_file(path, str(tmp_path / "port"), mode=mode, slice_ms=2000,
                     sample_rate=40000)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) >= 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(read_wav(g)[0], read_wav(w)[0])
    with pytest.raises(ValueError, match="unknown slice mode"):
        slice_file(path, str(tmp_path / "x"), mode="other")
    assert normalize_sr("48k") == 48000 and normalize_sr(40000) == 40000


TOOL_ARGV = {
    "model_information": ["--pth_path", "/x/m.pth"],
    "model_blender": ["--model_name", "mix", "--pth_path_1", "/x/a.pth",
                      "--pth_path_2", "/x/b.pth", "--ratio", "0.25"],
    "tensorboard": ["--logdir", "/x/logs", "--port", "9100"],
    "audio_analyzer": ["--input_path", "/x/a.wav", "--save_plot_path", "/x/p.png"],
}


@pytest.mark.parametrize("mode", list(TOOL_ARGV))
@pytest.mark.parametrize("given", ["defaults", "every_flag"])
def test_tool_subcommands_parse_jax_flags(mode, given):
    from rvc_tpu.cli import build_parser as jax_parser
    from rvc_tpu_torch.cli import build_parser

    argv = TOOL_ARGV[mode]
    if given == "defaults":  # only the required flags
        required = {"model_information": 2, "model_blender": 6, "tensorboard": 0,
                    "audio_analyzer": 2}[mode]
        argv = argv[:required]
    want = vars(jax_parser().parse_args([mode, *argv]))
    got = vars(build_parser().parse_args([mode, *argv]))
    if mode == "audio_analyzer":
        assert got.pop("device") == "cuda"
    assert got == want


def test_tool_subcommands_run(tmp_path, monkeypatch, capsys):
    from rvc_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    a = _write_model(tmp_path / "a.pth")
    b = _write_model(tmp_path / "b.pth", seed=6)
    assert cli.main(["model_blender", "--model_name", "mix", "--pth_path_1", a,
                     "--pth_path_2", b]) == 0
    assert capsys.readouterr().out.strip().endswith(os.path.join("logs", "mix.pth"))
    assert cli.main(["model_information", "--pth_path", "logs/mix.pth"]) == 0
    said = capsys.readouterr().out
    assert "blend_ratio: 0.5" in said and "parameters: " in said
    wav = _tone_file(tmp_path / "a.wav")
    assert cli.main(["audio_analyzer", "--input_path", wav, "--device", "cpu"]) == 0
    assert "spectral_centroid_hz: " in capsys.readouterr().out

    launched = {}

    class FakeBoard:
        def configure(self, argv):
            launched["argv"] = argv

        def launch(self):
            return "http://localhost:9100/"

    board = types.ModuleType("tensorboard")  # TensorBoard itself is never started
    board.program = types.SimpleNamespace(TensorBoard=FakeBoard)
    monkeypatch.setitem(sys.modules, "tensorboard", board)
    monkeypatch.setattr(cli, "_serve_forever", lambda: launched.setdefault("served", True))
    assert cli.main(["tensorboard", "--port", "9100"]) == 0
    assert launched == {"argv": [None, "--logdir", "logs", "--port", "9100"],
                        "served": True}
    assert "TensorBoard at http://localhost:9100/" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "tensorboard", None)  # not installed
    assert cli.main(["tensorboard"]) == 0
    assert ("tensorboard not installed; metrics are in logs/*/metrics.jsonl"
            in capsys.readouterr().out)


def test_environment_and_profiling_without_a_card(tmp_path, capsys):
    from rvc_tpu_torch.utils import profiling
    from rvc_tpu_torch.utils.env_check import WHEELS, check_environment

    report = check_environment()
    assert report["torch"] == torch.__version__ and report["wheels"]["torch"]
    assert set(report["wheels"]) == set(WHEELS) and "jax" not in WHEELS
    if not torch.cuda.is_available():
        assert report["device"] is None
    assert isinstance(report["kernels_built"], list)
    assert "wheels present: " in capsys.readouterr().out

    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.request(160) as req, profiling.span("work"), profiling.annotate("op"):
            torch.ones(64).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"rvc.request", "work", "op"} <= names
    record = profiling.requests()[-1]
    assert record["id"] == req.id and [s["name"] for s in record["spans"]] == [
        "rvc.request", "work"]
    assert [e["name"] for e in events if e.get("cat") == profiling.TRACK_CAT] == [
        "rvc.request", "work"]
