"""The viewer, port vs the JAX package: the SIBR remote-viewer wire
protocol (``viewer/network_gui.py``), the local viewer's orbit camera, and
the train entry point serving a viewer.

The JAX module keeps its connection in module globals; its ``receive`` is
fed through a socket pair set as that connection. The port's sockets bind
port 0 (any free port), so the parallel test workers do not collide, and a
client always connects before ``try_connect`` polls, so the non-blocking
accept cannot miss it.
"""

import json
import math
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.viewer import local_viewer as jlv
from neuralgaussiansplatting_tpu.viewer import network_gui as jng
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.scene.scene import Scene
from neuralgaussiansplatting_torch.train import __main__ as entry
from neuralgaussiansplatting_torch.viewer import local_viewer as tlv
from neuralgaussiansplatting_torch.viewer import network_gui as tng

from scenes import make_camera
from test_torch_multistep import _scene_dir
from torch_parity import port_camera

torch.set_num_threads(2)

TIMEOUT = 60


def _message(view, full_proj, width, height, train=True, **extra):
    """A SIBR request: the matrices in the viewer's transposed storage,
    the view's columns 1 and 2 and the projection's column 1 negated."""
    wv = np.asarray(view, np.float32).T.copy()
    wv[:, 1] *= -1
    wv[:, 2] *= -1
    fp = np.asarray(full_proj, np.float32).T.copy()
    fp[:, 1] *= -1
    msg = {"resolution_x": width, "resolution_y": height, "train": train,
           "fov_y": 0.6, "fov_x": 0.8, "z_near": 0.01, "z_far": 100.0,
           "shs_python": False, "rot_scale_python": True,
           "keep_alive": True, "scaling_modifier": 0.75,
           "view_matrix": wv.reshape(-1).tolist(),
           "view_projection_matrix": fp.reshape(-1).tolist()}
    msg.update(extra)
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "the server closed"
        buf += chunk
    return buf


@pytest.mark.parametrize("size", [(32, 24), (0, 0)])
def test_receive_matches_jax(size):
    """One message through JAX's ``receive`` and the port's: the same
    camera (matrices, centre, fov, size, frustum limits) and flags; a zero
    resolution gives six Nones in both."""
    cam = make_camera(W=32, H=24)
    wire = _message(cam.view, cam.full_proj, *size)
    a, b = socket.socketpair()
    saved = jng.conn
    try:
        jng.conn = b
        a.sendall(wire)
        want = jng.receive()
    finally:
        jng.conn = saved
        a.close()
        b.close()
    gui = tng.NetworkGUI("127.0.0.1", 0, device="cpu")
    a, gui.conn = socket.socketpair()
    try:
        a.sendall(wire)
        got = gui.receive()
    finally:
        a.close()
        gui.close()
    assert got[1:] == want[1:]
    if size == (0, 0):
        assert got[0] is None and want[0] is None
        return
    tc, jc = got[0], want[0]
    for name in ("view", "full_proj", "campos"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert (tc.tan_fovx, tc.tan_fovy, tc.width, tc.height, tc.limit_x,
            tc.limit_y) == (jc.tan_fovx, jc.tan_fovy, jc.width, jc.height,
                            jc.limit_x, jc.limit_y)
    np.testing.assert_allclose(tc.view.numpy(), np.asarray(cam.view),
                               atol=1e-5)


def test_render_to_bytes_matches_jax():
    img = np.random.default_rng(0).normal(0.5, 0.6, (3, 24, 32)).astype(
        np.float32)
    want = bytes(jng.render_to_bytes(img))
    assert len(want) == 24 * 32 * 3
    assert bytes(tng.render_to_bytes(torch.from_numpy(img))) == want
    assert bytes(tng.render_to_bytes(img)) == want


def test_orbit_camera_matches_jax():
    """``OrbitCamera.params()`` after the same moves in both packages."""
    cams = (jlv.OrbitCamera(width=64, height=48, distance=3.1),
            tlv.OrbitCamera(width=64, height=48, distance=3.1))
    for c in cams:
        c.yaw, c.pitch, c.distance = 0.7, -0.4, c.distance * 0.92
    want, got = cams[0].params(), cams[1].params(device="cpu")
    for name in ("view", "full_proj", "campos"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(),
            np.asarray(getattr(want, name), np.float32))
    assert (got.tan_fovx, got.tan_fovy, got.width, got.height) == (
        want.tan_fovx, want.tan_fovy, want.width, want.height)
    cams[1].reset()
    assert (cams[1].distance, cams[1].yaw, cams[1].pitch) == (3.1, 0.0, 0.3)


def test_run_viewer_without_gui(monkeypatch, capsys):
    """No display: ``run_viewer`` says so and returns False, before it
    would import ``cv2``."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("NGS_FORCE_GUI", raising=False)
    model = tgm.GaussianModel(0, device="cpu")
    model.params, model.state = tgm.create_from_pcd(
        np.zeros((4, 3)), np.zeros((4, 3)), np.zeros((4, 3)), 0,
        device="cpu")
    assert tlv.run_viewer(model.params, model.state.alive, 0) is False
    assert "no GUI available" in capsys.readouterr().out


def test_socket_round_trip():
    """A client connected before ``try_connect``: the request parsed, the
    image bytes and the source path received, a closed viewer dropped."""
    gui = tng.NetworkGUI("127.0.0.1", 0, device="cpu")
    try:
        gui.try_connect()
        assert gui.conn is None          # nobody waiting: no block
        cam = make_camera(W=32, H=24)
        client = socket.create_connection(("127.0.0.1", gui.port),
                                          timeout=TIMEOUT)
        with client:
            gui.try_connect()
            assert gui.conn is not None
            client.sendall(_message(cam.view, cam.full_proj, 32, 24))
            tcam, train, shs, rot, keep, scale = gui.receive()
            assert (tcam.width, tcam.height, train, shs, rot, keep, scale) \
                == (32, 24, True, False, True, True, 0.75)
            img = np.random.default_rng(1).random((3, 24, 32)).astype(
                np.float32)
            gui.send(tng.render_to_bytes(img), "source/path")
            assert _recv_exact(client, 32 * 24 * 3) == bytes(
                jng.render_to_bytes(img))
            n = int.from_bytes(_recv_exact(client, 4), "little")
            assert _recv_exact(client, n) == b"source/path"
        with pytest.raises(ConnectionError):
            gui.receive()
        gui.drop()
        assert gui.conn is None
    finally:
        gui.close()


def _request(cam, train):
    return _message(cam.view, cam.full_proj, cam.width, cam.height,
                    train=train, scaling_modifier=1.0,
                    fov_x=2 * math.atan(cam.tan_fovx),
                    fov_y=2 * math.atan(cam.tan_fovy))


def _parsed(wire):
    """The camera the port's ``receive`` makes of ``wire``."""
    gui = tng.NetworkGUI("127.0.0.1", 0, device="cpu")
    a, gui.conn = socket.socketpair()
    try:
        a.sendall(wire)
        return gui.receive()[0]
    finally:
        a.close()
        gui.close()


def _viewer_client(port, cams, got):
    """Connect once the entry point listens, ask for one frame per camera
    (training held until the last) and keep the image bytes."""
    deadline = time.monotonic() + TIMEOUT
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=TIMEOUT)
            break
        except ConnectionRefusedError:
            assert time.monotonic() < deadline, "the entry never listened"
            time.sleep(0.01)
    with sock:
        for i, cam in enumerate(cams):
            sock.sendall(_request(cam, train=i == len(cams) - 1))
            got.setdefault("frames", []).append(
                _recv_exact(sock, cam.width * cam.height * 3))
            n = int.from_bytes(_recv_exact(sock, 4), "little")
            got.setdefault("paths", []).append(_recv_exact(sock, n))


def test_entry_point_serves_the_viewer(tmp_path, monkeypatch):
    """The train entry point (CPU) with the viewer on a free loopback port:
    a client asks for two frames before the first iteration (the entry's
    first accept waits for it) and closes; each frame is byte-equal to a
    direct render of the scene's initial model, and the run completes."""
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    src = _scene_dir(str(tmp_path / "scene"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    accept = tng.NetworkGUI.try_connect

    def first_accept_waits(gui):
        gui.listener.settimeout(TIMEOUT)
        try:
            accept(gui)
        finally:
            gui.listener.settimeout(0)
            monkeypatch.setattr(tng.NetworkGUI, "try_connect", accept)

    monkeypatch.setattr(tng.NetworkGUI, "try_connect", first_accept_waits)
    cams = [port_camera(make_camera(W=32, H=32, angle=a))
            for a in (0.3, 2.0)]
    got = {}
    client = threading.Thread(target=_viewer_client, args=(port, cams, got))
    client.start()
    argv = ["-s", src, "-m", str(tmp_path / "out"), "--iterations", "3",
            "--test_iterations", "3", "--model_capacity", "512",
            "--capacity", "8192", "--port", str(port), "--quiet"]
    summary = entry.main(argv)
    client.join(timeout=TIMEOUT)
    assert not client.is_alive()
    assert summary["viewer"] == [1, 1]
    assert got["paths"] == [src.encode()] * 2
    assert set(summary["evals"][3]) == {"train"}

    random.seed(0)          # as safe_state seeds it before the Scene
    np.random.seed(0)
    torch.manual_seed(0)
    model = tgm.GaussianModel(3, device="cpu")
    Scene(src, str(tmp_path / "ref"), model, capacity=512)
    settings = entry.pipeline_settings(entry.build_parser().parse_args(argv))
    for cam, frame in zip(cams, got["frames"]):
        cam = _parsed(_request(cam, train=True))
        with torch.no_grad():
            want = render(cam, model.params, model.state.alive,
                          model.active_sh_degree, torch.zeros(3),
                          settings)["render"]
        assert bytes(tng.render_to_bytes(want)) == frame
