"""Live-viewer socket server (the SIBR remote-viewer wire protocol).

A copy of ``fourdgs_tpu/viewer.py`` (the reference's
gaussian_renderer/network_gui.py): a non-blocking TCP listener the training
loop polls before each iteration (train.py:117-142). The viewer sends a
little-endian length-prefixed JSON camera message (resolution, fovs, z
range, the flattened view and view-projection matrices, the train and
keep_alive flags, a scaling modifier); the trainer replies with raw RGB
bytes (H·W·3, uint8, row-major), then a length-prefixed verify string (the
source path). The wire format and the sign flips of the matrices' Y and Z
columns are JAX's, byte for byte.

One difference: JAX's ``poll`` drops the connection on any exception,
a failing render included. The port drops it on a socket error or a
malformed message only (the viewer went away); a render that fails raises.
"""

from __future__ import annotations

import json
import math
import socket
from typing import NamedTuple

import numpy as np


class ViewerCamera(NamedTuple):
    """The viewer's camera (MiniCam, scene/cameras.py:68-80): raw matrices,
    no R/T; ``render.py::CameraArrays.from_camera`` takes it."""

    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view: np.ndarray  # [4, 4], row-vector convention
    full_proj: np.ndarray
    camera_center: np.ndarray
    time: float

    @property
    def tanfovx(self):
        return math.tan(self.fovx / 2)

    @property
    def tanfovy(self):
        return math.tan(self.fovy / 2)


class NetworkGUI:
    """The listener on ``host:port`` (port 0 picks a free one: read it back
    from :attr:`port`) and at most one viewer connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.port = self.listener.getsockname()[1]
        self.conn: socket.socket | None = None

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nviewer connected from {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _recv_exactly(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def _read_msg(self) -> dict:
        n = int.from_bytes(self._recv_exactly(4), "little")
        return json.loads(self._recv_exactly(n).decode("utf-8"))

    def receive(self):
        """→ (ViewerCamera or None, do_training, keep_alive, scaling_modifier).

        As network_gui.py:72-77: the view matrix's Y and Z columns negated
        (SIBR's handedness against COLMAP's), the view-projection's Y
        column negated."""
        msg = self._read_msg()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        wv = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] = -fp[:, 1]
        center = np.linalg.inv(wv.astype(np.float64)).T[:3, 3].astype(np.float32)
        cam = ViewerCamera(
            width=width, height=height, fovx=msg["fov_x"], fovy=msg["fov_y"],
            znear=msg["z_near"], zfar=msg["z_far"], world_view=wv, full_proj=fp,
            camera_center=center, time=float(msg.get("time", 0.0)))
        return cam, bool(msg["train"]), bool(msg["keep_alive"]), msg["scaling_modifier"]

    def send(self, image_chw: np.ndarray | None, verify: str):
        """Send the raw RGB bytes of ``image_chw`` ([3, H, W] in [0, 1]),
        then the length-prefixed verify string."""
        if image_chw is not None:
            img = np.clip(np.asarray(image_chw), 0.0, 1.0)
            self.conn.sendall((img.transpose(1, 2, 0) * 255).astype(np.uint8).tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def poll(self, render_fn, source_path: str, training_done: bool) -> bool:
        """One poll of the training loop (train.py:117-142):
        ``render_fn(ViewerCamera) → [3, H, W]`` serves each camera the
        viewer sends until it lets training go on. Returns the do_training
        flag (False only if the viewer paused training)."""
        do_training = True
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, _scale = self.receive()
            except (OSError, ValueError, KeyError):   # gone, or not a viewer
                self._drop()
                break
            img = render_fn(cam) if cam is not None else None
            try:
                self.send(img, source_path)
            except OSError:
                self._drop()
                break
            if do_training and (not keep_alive or training_done):
                break
        return bool(do_training)

    def _drop(self):
        self.conn.close()
        self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
