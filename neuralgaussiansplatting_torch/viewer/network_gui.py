"""SIBR remote-viewer wire protocol (the reference's
``gaussian_renderer/network_gui.py``).

Port of ``viewer/network_gui.py``, the same bytes on the wire, so the
stock SIBR ``remote`` viewer connects unchanged:

- inbound: a 4-byte little-endian length, then that many bytes of JSON
  (camera matrices, resolution, the train / keep-alive flags, the
  python-path toggles, the scaling modifier);
- outbound: the raw H * W * 3 uint8 image, then a 4-byte little-endian
  length and the ASCII source path.

The viewer ships its matrices in the reference's transposed (row-vector)
storage with columns 1 and 2 of the view (column 1 of the projection)
sign-flipped; ``receive`` undoes the flips and transposes them into this
package's ``M @ p`` convention.

The JAX module keeps its socket in module globals, opened at import; here
a ``NetworkGUI`` owns it, and binding happens when one is made.
"""

from __future__ import annotations

import json
import socket

import numpy as np
import torch

from neuralgaussiansplatting_torch.scene.cameras import minicam


class NetworkGUI:
    """A listening socket at (``host``, ``port``) (port 0: any free port)
    and the viewer connection it accepted, if any; cameras are made on
    ``device``. Binding raises ``OSError`` when the address is taken."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 device="cuda"):
        self.device = device
        self.conn = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                     1)
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)
        self.host, self.port = self.listener.getsockname()[:2]

    def try_connect(self):
        """Accept a waiting viewer without blocking (the training loop
        polls this once per iteration)."""
        try:
            self.conn, self.addr = self.listener.accept()
        except (BlockingIOError, socket.timeout):
            return
        print(f"\nConnected by {self.addr}")
        self.conn.settimeout(None)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer closed")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, message_bytes, verify: str):
        if message_bytes is not None:
            self.conn.sendall(message_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """One viewer message: (CameraParams or None, do_training,
        shs_python, rot_scale_python, keep_alive, scaling_modifier); all
        None when the viewer asks for no image (a zero resolution)."""
        message = self.read()
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        wv = np.array(message["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = np.array(message["view_projection_matrix"],
                      np.float32).reshape(4, 4)
        fp[:, 1] = -fp[:, 1]
        cam = minicam(width, height, message["fov_x"], message["fov_y"],
                      message["z_near"], message["z_far"], wv.T, fp.T,
                      device=self.device)
        return (cam, bool(message["train"]), bool(message["shs_python"]),
                bool(message["rot_scale_python"]),
                bool(message["keep_alive"]), message["scaling_modifier"])

    def drop(self):
        """Close the viewer connection (the listener stays open)."""
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def close(self):
        self.drop()
        self.listener.close()


def render_to_bytes(image) -> memoryview:
    """(3, H, W) float image (a tensor on any device, or an array) ->
    interleaved (H, W, 3) uint8 bytes for the wire, converted on the host
    as the JAX package converts them."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)
    return memoryview(np.ascontiguousarray(arr.transpose(1, 2, 0)))
