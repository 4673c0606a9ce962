"""Live progressive-render preview over HTTP (counterpart of
ptsharp_tpu/viewer.py; the reference shows an OpenGL window,
Program.cs:110-135).

A render host is headless, so a small HTTP server on 127.0.0.1 serves
the latest frame as /frame.png and a page at / that reloads it every
second. `ViewerServer.update(image01)` swaps in each new frame, encoded
by film.encode_png (standard library only), so it runs wherever the
port does.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ptsharp_tpu_torch.film import encode_png

_PAGE = b"""<!doctype html><html><head><title>ptsharp_tpu_torch</title>
<style>body{background:#111;margin:0;display:flex;align-items:center;
justify-content:center;height:100vh}img{image-rendering:pixelated;
max-width:95vw;max-height:95vh}</style></head>
<body><img id=f src=/frame.png>
<script>setInterval(()=>{document.getElementById('f').src=
'/frame.png?'+Date.now()},1000)</script></body></html>"""


class ViewerServer:
    def __init__(self, port: int = 8765):
        self.port = port
        self._png: bytes = b""
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        data = viewer._png
                    if not data:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self._reply("image/png", data, no_store=True)
                else:
                    self._reply("text/html", _PAGE)

            def _reply(self, kind, data, no_store=False):
                self.send_response(200)
                self.send_header("Content-Type", kind)
                if no_store:
                    self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "ViewerServer":
        self._thread.start()
        return self

    def update(self, image01) -> None:
        """Swap in a new (H, W, 3) [0, 1] frame: a tensor on any device,
        or an array."""
        data = encode_png(image01)
        with self._lock:
            self._png = data

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
