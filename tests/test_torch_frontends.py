"""The port's frontends (aic_tpu_torch.apps.server, terminal, window and
main's session modes) on the CPU.

The server runs a session at 32×24 on port 0: the WebSocket handshake,
the `echo_t` round trip of an input message, ping/pong, `/info`,
`/frame.png` decoded to the session's own frame (bit for bit: the player
flies still, so nothing moves between the two renders) and POST
`/input`. `_ansi_image` equals `aic_tpu`'s string on a seeded image;
`WindowMain.frame` (SDL's dummy driver) presents the session's frame;
`main` runs `terminal` (stdin is not a tty under pytest: the one-shot
print) and `print` on a saved universe with `--device cpu`.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

import aic_tpu.apps.terminal as jterminal
import aic_tpu_torch.apps.terminal as tterminal
from aic_tpu_torch import main as tmain
from aic_tpu_torch.apps.server import SessionServer, ws_accept_key
from aic_tpu_torch.apps.session import Session
from aic_tpu_torch.content import TemplateParameters, build_universe
from aic_tpu_torch.raytrace import GraphicsOptions, Viewport, decode_png, encode_png
from test_server_ws import _client_frame, _handshake, _read_server_frame

W, H = 32, 24


def _still_session():
    """Cornell-box 8 with a player flying still: frames do not change."""
    u = build_universe("cornell-box", TemplateParameters(size=8), device="cpu")
    u.light_rounds_per_tick = 0
    s = Session(u, viewport=Viewport(W, H), options=GraphicsOptions(lighting_display="smoothstep", fog="none"))
    s.toggle_flying()
    s.enable_ui()
    s.maybe_step()
    s.render_with_ui()  # the first frame before the server starts
    return s


@pytest.fixture(scope="module")
def served():
    s = _still_session()
    srv = SessionServer(s, port=0, stream_fps=60.0)
    srv.start()
    yield s, srv
    srv.shutdown()


def test_ws_stream_echo_t_and_ping(served):
    session, srv = served
    sock, f, headers = _handshake(srv.port)
    try:
        assert headers["sec-websocket-accept"] == ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==")
        sock.sendall(_client_frame(json.dumps({"keys": ["w"], "look": [4, -2], "t": 424242}).encode()))
        sock.sendall(_client_frame(b"ping!", opcode=0x9))
        echoed = pong = png = None
        deadline = time.time() + 60
        while time.time() < deadline and (echoed is None or pong is None or png is None):
            opcode, payload = _read_server_frame(f)
            if opcode == 0x1:
                meta = json.loads(payload)
                assert {"info_text", "paused", "echo_t", "render_ms"} <= set(meta)
                if meta["echo_t"] is not None:
                    echoed = meta["echo_t"]
            elif opcode == 0x2 and echoed is not None:
                png = decode_png(payload)
            elif opcode == 0xA:
                pong = payload
        assert echoed == 424242 and pong == b"ping!"
        assert png.shape == (H, W, 4) and png[..., 3].min() == 255
        assert "w" in session.input.keys
        sock.sendall(_client_frame(b"", opcode=0x8))
    finally:
        sock.close()
    with srv.lock:
        session.input.keys = set()


def test_http_info_frame_and_input(served):
    session, srv = served
    base = f"http://127.0.0.1:{srv.port}"
    info = json.loads(urllib.request.urlopen(base + "/info", timeout=60).read())
    assert set(info) == {"info_text", "paused"} and info["paused"] is False
    png = urllib.request.urlopen(base + "/frame.png", timeout=60).read()
    with srv.lock:
        want = session.render_with_ui().data
    np.testing.assert_array_equal(decode_png(png), want)
    req = urllib.request.Request(base + "/input", data=json.dumps({"keys": ["a", "d"]}).encode(), method="POST")
    assert json.loads(urllib.request.urlopen(req, timeout=60).read()) == {}
    assert session.input.keys == {"a", "d"}
    with srv.lock:
        session.input.keys = set()
    assert urllib.request.urlopen(base + "/", timeout=60).read().startswith(b"<!doctype html>")


def test_encode_png_decodes_to_the_image():
    rng = np.random.default_rng(2)
    for shape in ((5, 7, 4), (3, 2, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def test_ansi_image_matches_aic_tpu():
    img = np.random.default_rng(7).integers(0, 256, (9, 6, 4), dtype=np.uint8)
    img[2:4, 1:3] = img[0, 0]  # runs of equal colours share one escape
    assert tterminal._ansi_image(img) == jterminal._ansi_image(img)


def test_window_frame_presents_the_session_frame():
    pygame = pytest.importorskip("pygame")
    from aic_tpu_torch.apps.window import WindowMain

    s = _still_session()
    with WindowMain(s, title="test") as wm:
        pygame.event.post(pygame.event.Event(pygame.KEYDOWN, key=pygame.K_p, mod=0, unicode="p"))
        frame = wm.frame(time.monotonic())
        assert s.paused  # the `p` key reached the session
        np.testing.assert_array_equal(frame, s.render_with_ui().data)
        shown = np.swapaxes(pygame.surfarray.array3d(wm.screen), 0, 1)
        np.testing.assert_array_equal(shown, frame[..., :3])
        assert wm.frames == 1


def test_main_terminal_and_print_on_a_saved_universe(tmp_path, capsys):
    path = str(tmp_path / "box.json")
    tmain.main(["--template", "cornell-box", "--size", "8", "--graphics", "record", "--output", path,
                "--device", "cpu", "--no-relight"])
    assert os.path.exists(path)
    capsys.readouterr()
    outs = {}
    for mode in ("terminal", "print"):
        tmain.main([path, "--graphics", mode, "--width", "16", "--height", "8", "--device", "cpu", "--no-relight"])
        out, err = capsys.readouterr()
        assert "[open] box.json" in err
        outs[mode] = out
    assert outs["terminal"] == outs["print"]
    assert outs["print"].count("\n") == 4 and "▀" in outs["print"]


def test_main_serve_refuses_cuda_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmain.main(["--graphics", "serve", "--port", "0"])
