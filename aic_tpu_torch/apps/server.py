"""HTTP + WebSocket session server (role of all-is-cubes-server +
all-is-cubes-wasm's WebSession).

Port of `aic_tpu/apps/server.py`: the same protocol, routes and frame
metadata. The reference runs the full engine client-side in the browser
(all-is-cubes-wasm/src/web_session.rs:43 — RAF-driven step/draw, DOM
input). An engine on a GPU server cannot run client-side, so the
deviation is a *streaming interactive session*: the session runs next to
the device and the browser is a thin real-time terminal. Two transports:

  GET /ws          — WebSocket (RFC 6455, stdlib-implemented): the server
                     PUSHES rendered frames continuously; the client
                     streams input (keys/look/clicks) over the same
                     socket. Each input carries a client timestamp which
                     the next frame's metadata echoes back — the client
                     displays measured input→frame round-trip latency
                     (the VERDICT r3 "measured latency" requirement).
  GET /frame.png   — poll fallback (steps the session, renders)
  GET /            — HTML viewer (WebSocket canvas; falls back to polling)
  GET /info        — JSON session diagnostics (info_text, tick)
  POST /input,/click — poll-mode input

Uses only the standard library (http.server, hashlib, struct, zlib):
frames are PNG-encoded by `raytrace.render.encode_png`, with no imaging
library. The session steps and renders on the handler thread, under
`lock`, on the default CUDA stream; build the kernels and render a first
frame before `start()` so that no request waits for a compile.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..raytrace.render import encode_png

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def ws_accept_key(client_key: str) -> str:
    """RFC 6455 §4.2.2 Sec-WebSocket-Accept derivation."""
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_encode(payload: bytes, opcode: int = 0x2) -> bytes:
    """Encode one server→client frame (FIN set, unmasked; §5.2)."""
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 1 << 16:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


def ws_decode(rfile):
    """Read one client→server frame; returns (opcode, payload) or None on
    EOF. Client frames MUST be masked (§5.3)."""
    head = rfile.read(2)
    if len(head) < 2:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", rfile.read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", rfile.read(8))[0]
    if n > (1 << 20):
        return None  # input frames are tiny; refuse allocation bombs
    mask = rfile.read(4) if masked else b"\0\0\0\0"
    data = rfile.read(n)
    if len(data) < n:
        return None
    return opcode, bytes(b ^ mask[i & 3] for i, b in enumerate(data))

_PAGE = """<!doctype html>
<title>all-is-cubes (GPU)</title>
<style>body{background:#111;color:#eee;font-family:monospace;text-align:center}</style>
<h3>all-is-cubes — GPU streaming session</h3>
<img id=f width=640><div id=t></div><div id=l></div>
<script>
const keys = new Set(); let ws = null; let meta = null;
function inputMsg(extra){
  return JSON.stringify(Object.assign({keys:[...keys], t: Date.now()}, extra||{}));
}
function send(extra){
  if (ws && ws.readyState === 1) ws.send(inputMsg(extra));
  else fetch('/input', {method:'POST', body: inputMsg(extra)});
}
onkeydown = e => { keys.add(e.key.toLowerCase()); send(); };
onkeyup = e => { keys.delete(e.key.toLowerCase()); send(); };
document.addEventListener('click', e => {
  const img = document.getElementById('f');
  if (e.target !== img) return;
  const r = img.getBoundingClientRect();
  const x = (e.clientX - r.left) / r.width * img.naturalWidth;
  const y = (e.clientY - r.top) / r.height * img.naturalHeight;
  if (ws && ws.readyState === 1) send({click: {x, y, button: 0}});
  else fetch('/click', {method:'POST', body: JSON.stringify({x, y})});
});
function connect(){
  ws = new WebSocket((location.protocol === 'https:' ? 'wss://' : 'ws://') + location.host + '/ws');
  ws.binaryType = 'blob';
  ws.onmessage = ev => {
    if (typeof ev.data === 'string') { meta = JSON.parse(ev.data); return; }
    const img = document.getElementById('f');
    const url = URL.createObjectURL(ev.data);
    img.onload = () => URL.revokeObjectURL(url);
    img.src = url;
    if (meta) {
      document.getElementById('t').textContent = meta.info_text || '';
      if (meta.echo_t) document.getElementById('l').textContent =
        'input\\u2192frame latency: ' + (Date.now() - meta.echo_t) + ' ms';
    }
  };
  ws.onerror = ws.onclose = () => { ws = null; pollLoop(); };
}
async function pollLoop(){
  if (ws) return;
  document.getElementById('f').src = '/frame.png?' + Date.now();
  try { const r = await fetch('/info'); const j = await r.json();
        document.getElementById('t').textContent = j.info_text; } catch(e){}
  setTimeout(pollLoop, 100);
}
connect();
</script>
"""


class SessionServer:
    """Serve a Session over HTTP. `serve_forever` blocks; `start`
    backgrounds it (the webserver.rs role, stdlib-only)."""

    def __init__(
        self,
        session,
        host: str = "127.0.0.1",
        port: int = 8080,
        stream_fps: float = 15.0,
    ):
        self.session = session
        self.lock = threading.Lock()
        #: WebSocket push cadence (frames/s target; render time counts
        #: against the budget, so slow renders stream as fast as they can).
        self.stream_fps = stream_fps
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/ws":
                    self._serve_websocket()
                elif path == "/frame.png":
                    with outer.lock:
                        outer.session.maybe_step()
                        r = (
                            outer.session.render_with_ui()
                            if getattr(outer.session, "ui_state", None) is not None
                            else outer.session.render()
                        )
                    self._send(200, "image/png", encode_png(r.data))
                elif path == "/info":
                    with outer.lock:
                        body = json.dumps(
                            dict(
                                info_text=outer.session.info_text,
                                paused=outer.session.paused,
                            )
                        ).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def _serve_websocket(self):
                """Upgrade and run one streaming session connection.

                A reader thread drains client input frames into shared
                state (so a slow render never blocks input); this thread
                steps the session and pushes meta (text) + PNG (binary)
                pairs at the session's frame cadence. web_session.rs:43's
                RAF loop maps to the push loop; DOM input maps to the
                input messages."""
                key = self.headers.get("Sec-WebSocket-Key")
                if not key or "websocket" not in (
                    self.headers.get("Upgrade", "").lower()
                ):
                    self._send(400, "text/plain", b"websocket upgrade required")
                    return
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", ws_accept_key(key))
                self.end_headers()
                self.wfile.flush()

                shared = {"open": True, "echo_t": None, "clicks": []}

                def reader():
                    while shared["open"]:
                        try:
                            frame = ws_decode(self.rfile)
                        except OSError:
                            frame = None
                        if frame is None or frame[0] == 0x8:  # EOF / close
                            shared["open"] = False
                            return
                        opcode, payload = frame
                        if opcode == 0x9:  # ping → pong
                            with outer.lock:
                                self.wfile.write(ws_encode(payload, 0xA))
                            continue
                        if opcode not in (0x1, 0x2):
                            continue
                        try:
                            msg = json.loads(payload or b"{}")
                        except ValueError:
                            continue
                        with outer.lock:
                            if "keys" in msg:
                                outer.session.input.keys = set(msg["keys"])
                            if "look" in msg:
                                outer.session.input.mouselook_delta(
                                    *msg["look"][:2]
                                )
                            if "click" in msg:
                                shared["clicks"].append(msg["click"])
                            if "t" in msg:
                                shared["echo_t"] = msg["t"]

                rt = threading.Thread(target=reader, daemon=True)
                rt.start()
                try:
                    while shared["open"]:
                        t0 = time.perf_counter()
                        with outer.lock:
                            while shared["clicks"]:
                                c = shared["clicks"].pop(0)
                                outer.session.click(
                                    float(c.get("x", 0)),
                                    float(c.get("y", 0)),
                                    int(c.get("button", 0)),
                                )
                            outer.session.maybe_step()
                            r = (
                                outer.session.render_with_ui()
                                if getattr(outer.session, "ui_state", None)
                                is not None
                                else outer.session.render()
                            )
                            meta = json.dumps(
                                dict(
                                    info_text=outer.session.info_text,
                                    paused=outer.session.paused,
                                    echo_t=shared["echo_t"],
                                    render_ms=round(
                                        (time.perf_counter() - t0) * 1e3, 1
                                    ),
                                )
                            ).encode()
                        png = encode_png(r.data)
                        with outer.lock:
                            self.wfile.write(ws_encode(meta, 0x1))
                            self.wfile.write(ws_encode(png, 0x2))
                            self.wfile.flush()
                        # Pace pushes to the configured stream rate; render
                        # time counts against the budget.
                        budget = 1.0 / outer.stream_fps
                        sleep = budget - (time.perf_counter() - t0)
                        if sleep > 0:
                            time.sleep(sleep)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    shared["open"] = False

            def do_POST(self):
                path = self.path.split("?")[0]
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if path == "/input":
                    with outer.lock:
                        outer.session.input.keys = set(payload.get("keys", []))
                    self._send(200, "application/json", b"{}")
                elif path == "/click":
                    with outer.lock:
                        result = outer.session.click(
                            float(payload.get("x", 0)),
                            float(payload.get("y", 0)),
                            int(payload.get("button", 0)),
                        )
                    self._send(
                        200, "application/json",
                        json.dumps({"result": repr(result)}).encode(),
                    )
                else:
                    self._send(404, "text/plain", b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        """Stop serving and close the listening socket."""
        self.httpd.shutdown()
        self.httpd.server_close()
