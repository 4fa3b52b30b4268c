"""The model-download trigger server (port of ``rvc_tpu/utils/http_server.py``).

The reference's assets/flask/{server.py,routes.py}: a localhost HTTP
endpoint that a website or any client calls to install a model into the
running app. ``GET /download/<url>`` runs ``model_download_pipeline`` on
the URL (a ``file://`` URL or a path installs without the network);
``POST /shutdown`` stops the server. Stdlib ``http.server``, on a daemon
thread of the calling process.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

DEFAULT_PORT = 8000


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, body: bytes = b"") -> None:
        self.send_response(code)
        self.send_header("Content-Type", "text/plain")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if not self.path.startswith("/download/"):
            self._reply(404)
            return
        url = unquote(self.path[len("/download/"):])
        try:
            from .downloads import model_download_pipeline

            self._reply(200, f"downloaded to {model_download_pipeline(url)}".encode())
        except Exception as e:  # the client gets the error; the server runs on
            self._reply(500, f"Error: {e}".encode())

    def do_POST(self):
        if self.path != "/shutdown":
            self._reply(404)
            return
        self._reply(200)
        threading.Thread(target=self.server.shutdown, daemon=True).start()


def start_download_server(port: int = DEFAULT_PORT,
                          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve on a daemon thread; returns the server (``shutdown()`` it, or
    ``POST /shutdown``, then ``server_close()``)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
