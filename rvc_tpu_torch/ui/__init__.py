"""The web UI (port of ``rvc_tpu/ui``): the Gradio Blocks app of seven
tabs and its i18n. Importing the package starts nothing; ``app.build_app``
builds the app (the ``gradio`` wheel where installed, else the stdlib
``gradio_lite`` renderer)."""

from .i18n import I18nAuto

__all__ = ["I18nAuto"]
