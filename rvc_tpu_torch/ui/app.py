"""The web application (port of ``rvc_tpu/ui/app.py``): seven tabs.

The reference's app.py:22-112 (a Blocks app on port 7897 that retries the
next ports) and its tabs: inference, training, TTS, voice blender,
download, utilities (analyzer and f0 extractor), settings. The callbacks
call the same library functions as the CLI, on ``device`` (the card unless
the caller asks for the CPU). The ``gradio`` wheel renders it where
installed, else the stdlib ``gradio_lite``.

    python -m rvc_tpu_torch.ui.app [port] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from .i18n import I18nAuto

DEFAULT_PORT = 7897
MAX_PORT_RETRIES = 10


def _require_gradio():
    try:
        import gradio as gr

        return gr
    except ImportError:
        from . import gradio_lite as gr

        print("[ui] gradio wheel not found - using the vendored gradio_lite renderer")
        return gr


def build_app(device: str = "cuda"):
    """The app's Blocks, its models on ``device``."""
    from ..device import resolve_device

    device = str(resolve_device(device))
    gr = _require_gradio()

    # the boot-time prerequisites check (the reference's app.py:33-37
    # downloads them): it reports what is missing and never blocks
    from ..utils.downloads import missing_prerequisites

    missing = missing_prerequisites()
    if missing:
        print("prerequisites missing (run `python -m rvc_tpu_torch.cli "
              f"prerequisites` or place them): {', '.join(missing)}")

    from .tabs import (download_tab, inference_tab, load_ui_config, settings_tab,
                       train_tab, tts_tab, utilities_tab, voice_blender_tab)

    ui_cfg = load_ui_config()
    i18n = I18nAuto(ui_cfg.get("language") or None)
    theme = ui_cfg.get("theme", "default")
    theme = None if theme in ("default", "", None) else theme

    with gr.Blocks(title="rvc_tpu_torch", theme=theme) as app:
        gr.Markdown("## rvc_tpu_torch — voice conversion on the GPU")
        with gr.Tab(i18n("Inference")):
            inference_tab(gr, i18n, device=device)
        with gr.Tab(i18n("Training")):
            train_tab(gr, i18n, device=device)
        with gr.Tab(i18n("TTS")):
            tts_tab(gr, i18n, device=device)
        with gr.Tab(i18n("Voice Blender")):
            voice_blender_tab(gr, i18n)
        with gr.Tab(i18n("Download")):
            download_tab(gr, i18n)
        with gr.Tab(i18n("Extra")):
            utilities_tab(gr, i18n, device=device)
        with gr.Tab(i18n("Settings")):
            settings_tab(gr, i18n)
    return app


def launch(port: int = DEFAULT_PORT, share: bool = False, device: str = "cuda") -> None:
    """Launch, trying the next ports when one is taken (reference
    app.py:99-112)."""
    app = build_app(device)
    for offset in range(MAX_PORT_RETRIES):
        try:
            app.launch(server_name="0.0.0.0", server_port=port + offset, share=share,
                       favicon_path=None)
            return
        except OSError:
            print(f"port {port + offset} busy, retrying...")
    raise RuntimeError("no free port found for the UI")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="the rvc_tpu_torch web UI")
    p.add_argument("port", nargs="?", type=int, default=DEFAULT_PORT)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models (the card by default)")
    args = p.parse_args(argv)
    launch(args.port, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
