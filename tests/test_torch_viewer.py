"""The port's SIBR network viewer (``fourdgs_tpu_torch/viewer.py``) against
the JAX package's (``fourdgs_tpu/viewer.py``), over loopback sockets.

- A round trip: a client connecting as SIBR does (``chip_smoke.sibr_client``)
  asks for two frames, one with ``keep_alive`` on; ``poll`` serves both with
  the render function's image and the source path as the verify string.
- ``receive()`` gives JAX's ``ViewerCamera`` for the same message, bit for
  bit (the Y and Z flips of the view matrix, the Y flip of the
  view-projection, the centre from the inverted view matrix), a message
  without ``time`` and a zero resolution included.
- ``send()`` writes JAX's bytes for the same image and verify string.
- A viewer that goes away is dropped; a render that fails raises (JAX's
  ``poll`` would swallow it).
- ``scene_reconstruction(viewer=…)`` serves, before iteration 1, the port's
  render of the state it was given.
- ``train_torch.py --port 0 --device cpu`` trains with the listener up.
"""

import json
import socket
import threading

import numpy as np
import pytest
import torch

import chip_smoke as CS
import train_torch
from fourdgs_tpu.viewer import NetworkGUI as JGUI
from fourdgs_tpu_torch.render import CameraArrays, render
from fourdgs_tpu_torch.viewer import NetworkGUI, ViewerCamera
from tests.test_data import make_dnerf_dataset
from tests.test_torch_cli import OVERRIDES, one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_loop import EXTENT, _port_cfg, _port_start
from tests.test_torch_train import _camera

CAM = _camera(0, 40, 24, time=0.35)


def serve(gui, render_fn, source, result, timeout=60.0):
    """Poll ``gui`` until the client's thread has ended."""
    import time

    thread = threading.Thread(target=CS.sibr_client, args=(
        gui.port, [(CAM, True), (CAM, False)], result, timeout), daemon=True)
    thread.start()
    deadline = time.monotonic() + timeout
    while thread.is_alive() and time.monotonic() < deadline:
        gui.poll(render_fn, source, training_done=False)
        time.sleep(0.001)
    thread.join(1)
    assert not thread.is_alive()


def test_socket_round_trip():
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (3, CAM.height, CAM.width))
    seen = []

    def render_fn(cam):
        seen.append(cam)
        return img

    gui = NetworkGUI(port=0)
    result = {}
    try:
        serve(gui, render_fn, "/data/scene", result)
    finally:
        gui.close()
    assert "error" not in result and len(result["frames"]) == 2 and len(seen) == 2
    want = (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    for frame in result["frames"]:
        np.testing.assert_array_equal(frame, want)
    assert result["verify"] == ["/data/scene"] * 2
    assert all(isinstance(c, ViewerCamera) for c in seen)
    np.testing.assert_array_equal(seen[0].world_view, np.asarray(CAM.world_view, np.float32))
    np.testing.assert_array_equal(seen[0].full_proj, np.asarray(CAM.full_proj, np.float32))
    assert gui.conn is None or gui.conn.fileno() == -1


def _received(gui_cls, payload: bytes):
    """What ``gui_cls``'s ``receive`` makes of ``payload``."""
    gui = gui_cls(port=0)
    port = gui.listener.getsockname()[1]
    try:
        with socket.create_connection(("127.0.0.1", port)) as conn:
            conn.sendall(payload)
            while gui.conn is None:
                gui.try_connect()
            return gui.receive()
    finally:
        gui.close()


def _raw(msg: dict) -> bytes:
    body = json.dumps(msg).encode()
    return len(body).to_bytes(4, "little") + body


@pytest.mark.parametrize("kind", ["keep_alive", "no_time", "paused", "zero_resolution"])
def test_receive_matches_jax(kind):
    msg = json.loads(CS.sibr_message(CAM, keep_alive=kind == "keep_alive")[4:])
    if kind == "no_time":
        del msg["time"]
    elif kind == "paused":
        msg["train"] = False
    elif kind == "zero_resolution":
        msg["resolution_y"] = 0
    got, want = _received(NetworkGUI, _raw(msg)), _received(JGUI, _raw(msg))
    assert got[1:] == want[1:]
    if kind == "zero_resolution":
        assert got == want == (None, None, None, None)
        return
    cam, jcam = got[0], want[0]
    assert cam._fields == jcam._fields
    for f in cam._fields:
        a, b = getattr(cam, f), getattr(jcam, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert type(a) is type(b) and a == b, f
    assert (cam.tanfovx, cam.tanfovy) == (jcam.tanfovx, jcam.tanfovy)
    # the viewer's camera is the scene camera the message was made from
    np.testing.assert_array_equal(cam.world_view, np.asarray(CAM.world_view, np.float32))
    np.testing.assert_allclose(cam.camera_center, CAM.camera_center, rtol=1e-5, atol=1e-6)
    arrays = CameraArrays.from_camera(cam, device="cpu")
    assert float(arrays.time) == (0.0 if kind == "no_time" else np.float32(CAM.time))


def _sent(gui_cls, img, verify: str) -> bytes:
    gui = gui_cls(port=0)
    port = gui.listener.getsockname()[1]
    try:
        with socket.create_connection(("127.0.0.1", port)) as conn:
            while gui.conn is None:
                gui.try_connect()
            gui.send(img, verify)
            gui.conn.close()
            gui.conn = None
            data = b""
            while chunk := conn.recv(1 << 16):
                data += chunk
            return data
    finally:
        gui.close()


@pytest.mark.parametrize("with_image", [True, False])
def test_send_matches_jax(with_image):
    img = (np.random.default_rng(1).uniform(-0.5, 1.5, (3, 7, 5)).astype(np.float32)
           if with_image else None)
    got, want = _sent(NetworkGUI, img, "/a/b"), _sent(JGUI, img, "/a/b")
    assert got == want
    assert len(got) == (7 * 5 * 3 if with_image else 0) + 4 + 4


def test_a_viewer_that_goes_away_is_dropped_and_a_failing_render_raises():
    gui = NetworkGUI(port=0)
    try:
        conn = socket.create_connection(("127.0.0.1", gui.port))
        conn.close()
        while gui.conn is None:
            gui.try_connect()
        assert gui.poll(lambda c: None, "x", training_done=False) is True
        assert gui.conn is None

        def broken(cam):
            raise RuntimeError("the render failed")

        with socket.create_connection(("127.0.0.1", gui.port)) as conn:
            conn.sendall(CS.sibr_message(CAM, keep_alive=False))
            with pytest.raises(RuntimeError, match="the render failed"):
                while True:
                    gui.poll(broken, "x", training_done=False)
    finally:
        gui.close()


def test_scene_reconstruction_serves_the_render(tmp_path):
    """A viewer connected before the stage: the poll before iteration 1
    serves the render of the state the stage was given; the next poll finds
    the viewer gone."""
    from fourdgs_tpu_torch.train import loop as tloop

    cfg = _port_cfg()
    cams, state, opt = _port_start(cfg)
    cam = cams[0][0]
    bg = torch.zeros(3)
    with torch.no_grad():
        # the centre as receive() rebuilds it from the view matrix
        vcam = cam._replace(camera_center=np.linalg.inv(
            np.asarray(cam.world_view, np.float64)).T[:3, 3].astype(np.float32))
        want = render(state.params, state, CameraArrays.from_camera(vcam, device="cpu"),
                      cfg, cam.width, cam.height, "coarse", bg, state.active_sh_degree,
                      device="cpu").color
    want8 = (np.clip(want.numpy(), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
    gui = NetworkGUI(port=0)
    try:
        with socket.create_connection(("127.0.0.1", gui.port)) as conn:
            conn.sendall(CS.sibr_message(cam, keep_alive=False))
            conn.shutdown(socket.SHUT_WR)
            _, _, log = tloop.scene_reconstruction(
                cfg, state, opt, cams, "coarse", 2, EXTENT, device="cpu", viewer=gui,
                source_path="/src/scene")
            data = b""
            while chunk := conn.recv(1 << 16):
                data += chunk
    finally:
        gui.close()
    n = cam.width * cam.height * 3
    assert len(data) == n + 4 + len("/src/scene")
    frame = np.frombuffer(data[:n], np.uint8).reshape(cam.height, cam.width, 3)
    np.testing.assert_array_equal(frame, want8)
    assert data[n + 4:].decode() == "/src/scene"
    assert np.isfinite(log.iterations[-1]["loss"]) and gui.conn is None


def test_train_cli_with_a_port(tmp_path, monkeypatch, capsys):
    from fourdgs_tpu_torch.data import scene as tscene

    monkeypatch.setattr(tscene, "TARGET_SIZE", (64, 64))
    make_dnerf_dataset(tmp_path / "data", n_train=4, n_test=1, size=64)
    model = str(tmp_path / "model")
    state, _ = train_torch.main(["-s", str(tmp_path / "data"), "--model_path", model,
                                 "--quiet", "--port", "0", "--test_iterations", "-1",
                                 "--save_iterations", "-1", "--device", "cpu",
                                 "--override", *OVERRIDES])
    assert "network viewer listening on 127.0.0.1:" in capsys.readouterr().out
    assert int(state.alive.sum()) > 0
