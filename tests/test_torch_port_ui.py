"""The port's web UI, its download server and the ``tts`` / ``download`` /
``prerequisites`` subcommands, on the CPU, against the JAX package's.

The tab builders run through a fake ``gr`` (as ``tests/test_ui_builders.py``
drives JAX's): both packages' builders make the same components (kind,
label, arguments) wired the same way (trigger, inputs, outputs), and the
inference tab's Convert event writes the file ``cli infer`` writes with the
same settings. The stdlib renderer passes the cases of
``tests/test_gradio_lite.py``; the app builds and serves its config; the
language packs are byte for byte JAX's; the offline TTS writes JAX's
samples; the link resolver (with an injected ``http_get``), the archive
install, the prerequisites fetch and the trigger server work offline; and
the JAX CLI's ``tts``, ``download`` and ``prerequisites`` command lines
parse in the port's parser to the same values.
"""

import filecmp
import io
import json
import os
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from test_torch_port_converter import _write_model


class FakeComponent:
    def __init__(self, gr, kind, *args, **kw):
        self.kind, self.args, self.kw = kind, args, kw
        self.label = kw.get("label")
        self.value = kw.get("value", args[2] if len(args) > 2 else None)
        self.events = []
        gr.components.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _on(self, trigger):
        def register(fn, inputs=None, outputs=None):
            self.events.append((trigger, fn, inputs or [], outputs or []))
            return self
        return register

    def __getattr__(self, trigger):  # click, change, upload, ...
        if trigger.startswith("_"):
            raise AttributeError(trigger)
        return self._on(trigger)


class FakeGradio:
    def __init__(self):
        self.components = []

    def __getattr__(self, kind):
        return lambda *args, **kw: FakeComponent(self, kind, *args, **kw)

    @staticmethod
    def update(**kw):
        return kw


def _i18n():
    from rvc_tpu_torch.ui.i18n import I18nAuto

    return I18nAuto("en_US")


TABS = ["inference_tab", "train_tab", "tts_tab", "voice_blender_tab", "download_tab",
        "utilities_tab", "settings_tab"]
DEVICE_TABS = {"inference_tab", "train_tab", "tts_tab", "utilities_tab"}


def _build(tabs, name, **kw):
    gr = FakeGradio()
    getattr(tabs, name)(gr, _i18n(), **kw)
    return gr


def _layout(gr):
    """Each component's kind, label and arguments; each event's trigger and
    its inputs and outputs as component positions."""
    pos = {id(c): i for i, c in enumerate(gr.components)}
    comps = [(c.kind, c.label, c.args, sorted((k, repr(v)) for k, v in c.kw.items()))
             for c in gr.components]
    events = [(pos[id(c)], trig, [pos[id(x)] for x in ins], [pos[id(x)] for x in outs])
              for c in gr.components for trig, _, ins, outs in c.events]
    return comps, events


@pytest.mark.parametrize("name", TABS)
def test_builders_match_jax(name, tmp_path, monkeypatch):
    from rvc_tpu.ui import tabs as jax_tabs
    from rvc_tpu_torch.ui import tabs

    monkeypatch.chdir(tmp_path)
    kw = {"device": "cpu"} if name in DEVICE_TABS else {}
    got = _layout(_build(tabs, name, **kw))
    ref = _layout(_build(jax_tabs, name))
    assert len(got[0]) > 0
    assert got == ref


def test_device_tabs_refuse_a_missing_card():
    from rvc_tpu_torch.ui import tabs

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build(tabs, "inference_tab")


def test_inference_tab_knob_surface():
    from rvc_tpu_torch.cli import build_parser
    from rvc_tpu_torch.ui import tabs

    gr = _build(tabs, "inference_tab", device="cpu")
    sliders = [c for c in gr.components if c.kind == "Slider"]
    checkboxes = [c for c in gr.components if c.kind == "Checkbox"]
    assert len(sliders) >= 2 * 26 and len(checkboxes) >= 2 * 14
    assert len(tabs._KNOBS) == 52
    surface = set(vars(build_parser().parse_args(
        ["infer", "--input_path", "a", "--output_path", "b", "--pth_path", "m"])))
    assert set(tabs._KNOBS) <= surface


def test_index_matching_and_presets(tmp_path, monkeypatch):
    from rvc_tpu_torch.ui import tabs
    from rvc_tpu_torch.utils import presets

    monkeypatch.chdir(tmp_path)
    a = tmp_path / "logs" / "migrated"
    a.mkdir(parents=True)
    (a / "added_IVF256_Flat_nprobe_1_migrated_v2.index").write_bytes(b"x")
    b = tmp_path / "logs" / "native"
    b.mkdir(parents=True)
    (b / "native.index.npz").write_bytes(b"x")
    (b / "added_IVF9_Flat_nprobe_1_native_v2.index").write_bytes(b"x")
    (b / "native_10e.pth").write_bytes(b"x")
    (b / "D_10.pth").write_bytes(b"x")
    choices = tabs._index_choices()
    assert any(c.endswith("migrated_v2.index") for c in choices)
    assert tabs._match_index(str(a / "migrated_10e.pth")).endswith(".index")
    assert tabs._match_index(str(b / "native_10e.pth")).endswith(".index.npz")
    assert tabs._match_index("") == ""
    assert tabs._model_choices() == [os.path.join("logs", "native", "native_10e.pth")]
    values = {k: 0 for k in tabs._KNOBS}
    values.update(pitch=7, protect=0.2, f0_method="fcpe")
    presets.save_preset("t", values, preset_dir=str(tmp_path))
    loaded = presets.load_preset("t", preset_dir=str(tmp_path))
    assert loaded["pitch"] == 7 and loaded["f0_method"] == "fcpe"


def test_settings_save_and_restart_target(tmp_path, monkeypatch):
    from rvc_tpu_torch.ui import tabs

    monkeypatch.chdir(tmp_path)
    gr = _build(tabs, "settings_tab")
    save, restart = [c for c in gr.components if c.kind == "Button"]
    assert "saved" in save.events[0][1]("en_US", "soft", "fp32", "me")
    cfg = tabs.load_ui_config()
    assert (cfg["theme"], cfg["language"], cfg["precision"]) == ("soft", "en_US", "fp32")
    execs = []
    monkeypatch.setattr(os, "execv", lambda exe, argv: execs.append(argv))
    restart.events[0][1]()
    assert execs[0][1:3] == ["-m", "rvc_tpu_torch.ui.app"]


def test_inference_event_equals_cli_infer(tmp_path, monkeypatch):
    """The Convert button of the inference tab, with its knobs at their
    defaults, writes the samples ``cli infer`` writes with the same values
    (the embedder and RMVPE are the registry's random fallbacks, seeded
    alike)."""
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.ui import tabs
    from rvc_tpu_torch.utils.audio_io import read_wav, write_wav

    monkeypatch.chdir(tmp_path)
    _write_model(tmp_path / "model.pth")
    tt = np.arange(24000) / 16000
    write_wav(str(tmp_path / "in.wav"), 0.4 * np.sin(2 * np.pi * 200 * tt), 16000)
    gr = _build(tabs, "inference_tab", device="cpu")
    (convert,) = [c for c in gr.components
                  if c.kind == "Button" and c.args == ("Convert",)][:1]
    trigger, fn, inputs, _ = convert.events[0]
    values = [str(tmp_path / "in.wav"), str(tmp_path / "model.pth"), "", 0, "", ""]
    values += [c.value for c in inputs[6:]]
    torch.manual_seed(0)
    out = fn(*values)
    got, sr = read_wav(out)
    torch.manual_seed(0)
    assert cli.main(["infer", "--input_path", str(tmp_path / "in.wav"), "--output_path",
                     str(tmp_path / "cli.wav"), "--pth_path", str(tmp_path / "model.pth"),
                     "--device", "cpu"]) == 0
    want, _ = read_wav(str(tmp_path / "cli.wav"))
    assert trigger == "click" and sr == 48000
    assert got.shape == want.shape and np.abs(want).max() > 0.01
    np.testing.assert_array_equal(got, want)


def test_gradio_lite_contract(tmp_path):
    """``tests/test_gradio_lite.py``'s cases on the port's renderer: the
    tree and config, event dispatch with value coercion, an audio tuple
    written as a WAV, ``update`` patches, the page, and the HTTP surface."""
    import wave

    from rvc_tpu_torch.ui import gradio_lite as gr

    def build():
        with gr.Blocks(title="t") as app:
            gr.Markdown("## hello")
            with gr.Tab("One"):
                with gr.Row():
                    name = gr.Textbox(label="Name", value="w")
                    n = gr.Slider(0, 10, 2, step=1, label="N")
                    flag = gr.Checkbox(value=False, label="Flag")
                pick = gr.Dropdown(choices=["a", "b"], label="Pick")
                out = gr.Textbox(label="Out")
                gr.Button("Go").click(lambda a, b, c, d: f"{a}:{int(b) * 2}:{c}:{d}",
                                      [name, n, flag, pick], [out])
                au = gr.Audio(label="Audio out")
                gr.Button("Make").click(lambda: (8000, np.zeros(800, np.float32)), [], [au])
                drop = gr.Dropdown(choices=["x"], label="Dyn")
                gr.Button("Upd").click(lambda: gr.update(choices=["p", "q"], value="q"),
                                       [], [drop])
            with gr.Tab("Two"):
                gr.JSON(label="J")
        return app

    app = build()
    cfg = app.config()
    assert len(cfg["events"]) == 3 and cfg["events"][0]["trigger"] == "click"
    assert len({c["id"] for c in cfg["components"]}) == len(cfg["components"])
    assert app.call_event(0, ["v", "3", "true", "b"])["data"][0]["value"] == "v:6:True:b"
    patch = app.call_event(1, [])["data"][0]
    with wave.open(patch["value"]) as w:
        assert (w.getframerate(), w.getnframes()) == (8000, 800)
    patch = app.call_event(2, [])["data"][0]
    assert patch["choices"] == ["p", "q"] and patch["value"] == "q"
    page = app.render_page()
    assert page.count('class="tabbtn"') == 2 and "hello</h2>" in page
    app.launch(server_name="127.0.0.1", server_port=0, prevent_thread_lock=True)
    try:
        base = f"http://127.0.0.1:{app.server.server_address[1]}"
        req = urllib.request.Request(f"{base}/api/0", data=json.dumps(
            {"data": ["x", 1, False, "a"]}).encode(),
            headers={"Content-Type": "application/json"})
        assert json.loads(urllib.request.urlopen(req, timeout=10).read()
                          )["data"][0]["value"] == "x:2:False:a"
        p = tmp_path / "f.txt"
        p.write_text("hi")
        assert urllib.request.urlopen(f"{base}/file?p={p}", timeout=10).read() == b"hi"
        with pytest.raises(OSError):  # a taken port: app.launch tries the next
            build().launch(server_name="127.0.0.1",
                           server_port=app.server.server_address[1],
                           prevent_thread_lock=True)
    finally:
        app.close()


def test_app_builds_and_serves_its_config(tmp_path, monkeypatch, capsys):
    from rvc_tpu_torch.ui import app as ui_app

    monkeypatch.chdir(tmp_path)
    app = ui_app.build_app(device="cpu")
    assert "prerequisites missing" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "models")  # the check fetched nothing
    app.launch(server_name="127.0.0.1", server_port=0, prevent_thread_lock=True)
    try:
        port = app.server.server_address[1]
        cfg = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/config",
                                                timeout=10).read())
        tabs = iter(c["label"] for c in cfg["components"] if c["kind"] == "tab")
        assert all(t in tabs for t in ("Inference", "Training", "TTS", "Voice Blender",
                                       "Download", "Extra", "Settings"))
        assert len(cfg["events"]) > 20
    finally:
        app.close()


def test_language_packs_are_jax_packs():
    import rvc_tpu.ui as jax_ui
    import rvc_tpu_torch.ui as port_ui

    a = os.path.join(os.path.dirname(jax_ui.__file__), "languages")
    b = os.path.join(os.path.dirname(port_ui.__file__), "languages")
    names = sorted(os.listdir(a))
    assert len(names) == 60 and sorted(os.listdir(b)) == names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert (mismatch, errors) == ([], []) and len(match) == 60
    from rvc_tpu.ui.i18n import I18nAuto as JaxI18n

    for lang in ("de_DE", "pt_BR", "cs_CZ", "xx_XX"):
        assert _i18n().__class__(lang).mapping == JaxI18n(lang).mapping, lang


def test_fallback_tts_and_voices_match_jax(tmp_path):
    from rvc_tpu.utils import tts as jax_tts
    from rvc_tpu_torch.utils import tts
    from rvc_tpu_torch.utils.audio_io import read_wav

    for text in ("hello world", "x" * 40):
        tts._fallback_tts(text, str(tmp_path / "p.wav"))
        jax_tts._fallback_tts(text, str(tmp_path / "j.wav"))
        got, sr = read_wav(str(tmp_path / "p.wav"))
        want, sr_j = read_wav(str(tmp_path / "j.wav"))
        assert sr == sr_j == 16000 and got.size > 0
        np.testing.assert_array_equal(got, want)
    assert tts.list_voices() == jax_tts.list_voices()
    assert len(tts.list_voices()) == 318


def test_tts_subcommand_speaks_then_converts(tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils.audio_io import read_wav

    monkeypatch.chdir(tmp_path)
    _write_model(tmp_path / "model.pth")
    (tmp_path / "text.txt").write_text("a short sentence", encoding="utf-8")
    assert cli.main(["tts", "--tts_voice", "en-US-AriaNeural", "--input_path",
                     str(tmp_path / "text.txt"), "--output_tts_path",
                     str(tmp_path / "tts.wav"), "--output_rvc_path",
                     str(tmp_path / "out.wav"), "--pth_path", str(tmp_path / "model.pth"),
                     "--device", "cpu"]) == 0
    spoken, _ = read_wav(str(tmp_path / "tts.wav"))
    out, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == 48000 and np.isfinite(out).all()
    assert abs(out.size / 48000 - spoken.size / 16000) < 0.05


class FakeResponse:
    def __init__(self, content=b"", headers=None, status_code=200):
        self.content, self.headers, self.status_code = content, headers or {}, status_code

    @property
    def text(self):
        return self.content.decode()

    def iter_content(self, chunk_size=1):
        yield self.content


def make_get(routes):
    calls = []

    def get(url, stream=True):
        calls.append(url)
        for prefix, resp in routes.items():
            if url.startswith(prefix):
                return resp
        return FakeResponse(status_code=404)

    get.calls = calls
    return get


def test_link_resolver_flows(tmp_path):
    """``tests/test_link_resolver.py``'s cases on the port's resolver."""
    from rvc_tpu_torch.utils.link_resolver import (LinkResolveError, download_link,
                                                   filename_from_headers,
                                                   gdrive_confirm_url, parse_gdrive_id,
                                                   scrape_zip_link)

    assert parse_gdrive_id("https://drive.google.com/file/d/F1/view?usp=sharing") == "F1"
    assert parse_gdrive_id("https://drive.google.com/open?id=XYZ") == "XYZ"
    assert parse_gdrive_id("https://example.com/file/d/NOPE/view") is None
    assert gdrive_confirm_url(
        '<a href="/uc?export=download&amp;confirm=TOK&amp;id=F1">ok</a>') == (
        "https://docs.google.com/uc?export=download&confirm=TOK&id=F1")
    interstitial = ('<form action="https://drive.usercontent.google.com/download">'
                    '<input type="hidden" name="id" value="F2">'
                    '<input type="hidden" name="confirm" value="t">'
                    '<input type="hidden" name="uuid" value="UU"></form>')
    get = make_get({
        "https://drive.google.com/uc?id=F2": FakeResponse(
            interstitial.encode(), {"Content-Type": "text/html; charset=utf-8"}),
        "https://drive.usercontent.google.com/download?id=F2": FakeResponse(
            b"MODEL", {"Content-Type": "application/octet-stream",
                       "Content-Disposition": 'attachment; filename="m.pth"'})})
    path = download_link("https://drive.google.com/file/d/F2/view", str(tmp_path),
                         http_get=get)
    assert os.path.basename(path) == "m.pth" and open(path, "rb").read() == b"MODEL"
    get = make_get({"https://huggingface.co/u/m/resolve/main/model.pth": FakeResponse(
        b"PTH", {"Content-Type": "application/octet-stream"})})
    path = download_link("https://huggingface.co/u/m/blob/main/model.pth",
                         str(tmp_path / "hf"), http_get=get)
    assert open(path, "rb").read() == b"PTH"
    assert scrape_zip_link('<a href="/r/blob/main/a.zip">a</a>') == (
        "https://huggingface.co/r/resolve/main/a.zip")
    assert filename_from_headers(
        {"Content-Disposition": "attachment; filename*=UTF-8''m%20x.pth"}, "https://x/y"
    ) == "m x.pth"
    with pytest.raises(LinkResolveError, match="404"):
        download_link("https://example.com/x.pth", str(tmp_path), http_get=make_get({}))


def _zip_bytes():
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("voice.pth", b"P")
        z.writestr("voice.index", b"I")
        z.writestr("__MACOSX/._voice.pth", b"x")
    return buf.getvalue()


def test_model_download_pipeline_matches_jax(tmp_path):
    from rvc_tpu.utils.downloads import model_download_pipeline as jax_pipeline
    from rvc_tpu_torch.utils.downloads import model_download_pipeline
    from rvc_tpu_torch.utils.link_resolver import search_pth_index

    routes = {"https://huggingface.co/u/m/tree/main": FakeResponse(
        b'<a href="/u/m/blob/main/voice.zip">voice.zip</a>', {"Content-Type": "text/html"}),
        "https://huggingface.co/u/m/resolve/main/voice.zip": FakeResponse(
            _zip_bytes(), {"Content-Type": "application/zip"})}
    got = model_download_pipeline("https://huggingface.co/u/m/tree/main",
                                  str(tmp_path / "port"), http_get=make_get(routes))
    want = jax_pipeline("https://huggingface.co/u/m/tree/main", str(tmp_path / "jax"),
                        http_get=make_get(routes))
    assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == ["voice.index",
                                                                   "voice.pth"]
    pths, idxs = search_pth_index(got)
    assert [os.path.basename(p) for p in pths + idxs] == ["voice.pth", "voice.index"]
    with pytest.raises(RuntimeError, match="download failed"):
        model_download_pipeline("https://example.com/x.pth", str(tmp_path / "e"),
                                http_get=make_get({}))


def test_install_archive_and_file_urls(tmp_path):
    from rvc_tpu_torch.utils.downloads import (install_model_archive,
                                               model_download_pipeline)

    (tmp_path / "voice.zip").write_bytes(_zip_bytes())
    dest = install_model_archive(str(tmp_path / "voice.zip"), str(tmp_path / "logs"))
    assert os.path.exists(os.path.join(dest, "voice.pth"))
    (tmp_path / "m.index").write_bytes(b"I")
    got = model_download_pipeline(f"file://{tmp_path / 'm.index'}", str(tmp_path / "logs"))
    assert open(got, "rb").read() == b"I"
    (tmp_path / "m.txt").write_text("t")
    with pytest.raises(ValueError, match="unsupported"):
        install_model_archive(str(tmp_path / "m.txt"))


def test_prerequisites_report_and_fetch(tmp_path, monkeypatch):
    from rvc_tpu_torch import cli
    from rvc_tpu_torch.utils import downloads

    monkeypatch.chdir(tmp_path)
    missing = downloads.missing_prerequisites()
    assert len(missing) == 8 and not os.path.exists("models")
    get = make_get({"https://": FakeResponse(b"W")})
    still = downloads.prerequisites_download_pipeline(exe=False, http_get=get)
    assert still == [] and len(get.calls) == 8
    assert downloads.missing_prerequisites() == []
    assert open(os.path.join("models", "predictors", "rmvpe.pt"), "rb").read() == b"W"
    # everything present: the subcommand fetches nothing
    assert cli.main(["prerequisites", "--exe", "False"]) == 0


def test_download_trigger_server(tmp_path, monkeypatch):
    from rvc_tpu_torch.parallel.mesh import free_port
    from rvc_tpu_torch.utils.http_server import start_download_server

    monkeypatch.chdir(tmp_path)
    (tmp_path / "voice.zip").write_bytes(_zip_bytes())
    port = free_port()
    srv = start_download_server(port=port)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/download/file://{tmp_path / 'voice.zip'}",
                timeout=10) as r:
            assert r.status == 200 and b"downloaded" in r.read()
        assert os.path.exists(tmp_path / "logs" / "voice" / "voice.pth")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/download/nowhere.pth",
                                   timeout=10)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/shutdown", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
    finally:
        srv.shutdown()
        srv.server_close()


JAX_ARGVS = [
    ["tts", "--tts_text", "hi there", "--tts_voice", "en-US-GuyNeural", "--tts_rate",
     "-10", "--output_tts_path", "t.wav", "--output_rvc_path", "o.wav", "--pth_path",
     "m.pth", "--index_path", "m.index", "--pitch", "3", "--f0_method", "fcpe"],
    ["tts", "--tts_file", "text.txt", "--tts_voice", "en-US-AriaNeural",
     "--output_tts_path", "t.wav", "--output_rvc_path", "o.wav", "--pth_path", "m.pth",
     "--export_format", "FLAC", "--reverb", "True"],
    ["download", "--model_link", "https://huggingface.co/u/m/blob/main/m.zip"],
    ["prerequisites"],
    ["prerequisites", "--models", "False", "--pretraineds_hifigan", "0", "--exe",
     "True", "--prime_cache", "1-10,30"],
]


@pytest.mark.parametrize("argv", JAX_ARGVS)
def test_jax_cli_argv_parses_in_the_port(argv):
    from rvc_tpu.cli import build_parser as jax_parser
    from rvc_tpu_torch.cli import build_parser

    ref = vars(jax_parser().parse_args(argv))
    got = vars(build_parser().parse_args(argv))
    if argv[0] == "tts":
        assert got.pop("device") == "cuda"
    assert got == ref


def test_gui_launchers_without_a_window(tmp_path):
    from rvc_tpu_torch.utils import blender_gui, slice_gui
    from rvc_tpu_torch.utils.audio_io import write_wav

    write_wav(str(tmp_path / "long.wav"), 0.3 * np.sin(np.arange(40000) / 9.0), 16000)
    slice_gui.main([str(tmp_path / "long.wav"), str(tmp_path / "chunks"), "--slice_ms",
                    "1000"])
    assert len(os.listdir(tmp_path / "chunks")) == 3  # 2.5 s: the last 0.5 s kept
    _write_model(tmp_path / "a.pth")
    _write_model(tmp_path / "b.pth")
    blender_gui.main([str(tmp_path / "a.pth"), str(tmp_path / "b.pth"), "--name", "mix",
                      "--ratio", "0.3", "--output_dir", str(tmp_path / "out")])
    assert os.path.exists(tmp_path / "out" / "mix.pth")
