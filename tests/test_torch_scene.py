"""PyTorch port vs the JAX package (and Pillow): the scene layer.

The port reads images without Pillow (``scene/image_io.py``), so its PNG
decoder, encoder and resize are held to Pillow here; the COLMAP parsers,
the input point-cloud I/O, the native kNN, ``Scene`` (Blender and COLMAP
layouts) and the ``cfg_args`` files are held to the JAX package.
"""

import io
import json
import os
import random
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from neuralgaussiansplatting_tpu import config as jconfig
from neuralgaussiansplatting_tpu import native as jnative
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.scene import colmap as jcolmap
from neuralgaussiansplatting_tpu.scene import ply as jply
from neuralgaussiansplatting_tpu.scene.scene import Scene as JScene
from neuralgaussiansplatting_torch import config as tconfig
from neuralgaussiansplatting_torch import native as tnative
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.scene import colmap as tcolmap
from neuralgaussiansplatting_torch.scene import image_io
from neuralgaussiansplatting_torch.scene import ply as tply
from neuralgaussiansplatting_torch.scene.scene import Scene as TScene

from test_scene import _make_blender_scene, _write_colmap_binary

torch.set_num_threads(2)

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _pillow_array(data: bytes) -> np.ndarray:
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr[..., None] if arr.ndim == 2 else arr


def _test_images(channels, seed):
    """A noise image and a smooth one (which makes every PNG predictor
    matter), uint8 (H, W, C)."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (23, 41, channels), dtype=np.uint8)
    steps = rng.integers(-3, 4, (23, 41, channels))
    smooth = (np.cumsum(np.cumsum(steps, 0), 1) + 128).astype(np.uint8)
    return noise, smooth


def _filter_types(data: bytes) -> set:
    """The row filter types of a PNG file."""
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    width, height, _, ctype = header[:4]
    stride = 1 + width * {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(height, stride)[:, 0].tolist())


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("channels", sorted(MODES))
def test_png_decode_matches_pillow_per_filter(channels, filter_type):
    """Every row forced to one filter by the port's encoder: Pillow and the
    port decode the same pixels, the source's."""
    for image in _test_images(channels, seed=channels * 10 + filter_type):
        data = image_io.encode_png(image, filter_type)
        assert _filter_types(data) == {filter_type}
        want = _pillow_array(data)
        np.testing.assert_array_equal(want, image)
        np.testing.assert_array_equal(image_io.decode_png(data), want)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("channels", sorted(MODES))
def test_png_decode_matches_pillow_on_pillow_files(channels, optimize):
    """Files Pillow writes (its per-row filter choice; Average only with
    ``optimize``), decoded bit-equal to Pillow's own decode."""
    seen = set()
    for image in _test_images(channels, seed=channels):
        pil = Image.fromarray(image[..., 0] if channels == 1 else image,
                              MODES[channels])
        buf = io.BytesIO()
        pil.save(buf, "PNG", optimize=optimize)
        data = buf.getvalue()
        seen |= _filter_types(data)
        np.testing.assert_array_equal(image_io.decode_png(data),
                                      _pillow_array(data))
    # the files mix filters, so the wavefront path is exercised
    assert len(seen) >= 2 and seen & {3, 4}, seen


def _rewrite_ihdr(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields (depth, ctype, interlace) replaced."""
    width, height, depth, ctype, comp, filt, lace = struct.unpack(
        ">IIBBBBB", data[16:29])
    payload = struct.pack(">IIBBBBB", width, height,
                          fields.get("depth", depth),
                          fields.get("ctype", ctype), comp, filt,
                          fields.get("interlace", lace))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + payload))
    return data[:16] + payload + crc + data[33:]


def _unsupported_file(kind, path):
    rgb = np.zeros((4, 5, 3), np.uint8)
    if kind == "16-bit":
        Image.fromarray(np.zeros((4, 5), np.uint16)).save(path)
    elif kind == "palette":
        Image.fromarray(rgb).convert("P").save(path)
    elif kind == "interlaced":
        with open(path, "wb") as f:
            f.write(_rewrite_ihdr(image_io.encode_png(rgb), interlace=1))
    elif kind == "transparency-key":
        Image.fromarray(rgb).save(path, transparency=(0, 0, 0))
    elif kind == "bad-crc":
        data = bytearray(image_io.encode_png(rgb))
        data[30] ^= 1
        with open(path, "wb") as f:
            f.write(bytes(data))


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced",
                                  "transparency-key", "bad-crc"])
def test_png_reader_refuses_what_it_cannot_read(kind, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    _unsupported_file(kind, path)
    with pytest.raises(image_io.UnsupportedImage, match=path):
        image_io.read_png(path)


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    """A JPEG opens through Pillow where it is installed, as Pillow reads
    it; without Pillow it raises and says to convert to PNG."""
    path = str(tmp_path / "im.jpg")
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)).save(
        path)
    np.testing.assert_array_equal(image_io.open_image(path),
                                  np.asarray(Image.open(path)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(image_io.UnsupportedImage, match="convert .* PNG"):
        image_io.open_image(path)


# (source width, height, target width, height): the loader's -r 2/4/8
# targets, the >1600 px auto-downscale (1700 -> 1600), a target width
# (-r 700 of 1000 x 37) and two sizes that enlarge
RESIZES = [(64, 48, 32, 24), (64, 48, 16, 12), (64, 48, 8, 6),
           (97, 61, 48, 30), (1700, 34, 1600, 32), (1000, 37, 700, 25),
           (33, 17, 70, 40), (50, 50, 50, 25)]


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("size", RESIZES, ids=lambda s: "%dx%d-%dx%d" % s)
def test_resize_matches_pillow(size, channels):
    """``Image.resize`` (BICUBIC) of RGB and RGBA (resized premultiplied):
    within 1/255 per channel; the share of values that differ is printed
    (the aim is 0)."""
    w, h, tw, th = size
    rng = np.random.default_rng(w + h + channels)
    image = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if channels == 4:
        alpha = image[..., 3]
        alpha[rng.random((h, w)) < 0.25] = 0
        alpha[rng.random((h, w)) < 0.25] = 255
    want = np.asarray(Image.fromarray(image, MODES[channels]).resize((tw, th)))
    got = image_io.resize(image, (tw, th))
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"resize {size} C={channels}: {np.mean(diff > 0):.6f} of values "
          f"differ from Pillow, max {diff.max()}")
    assert diff.max() <= 1


def test_resize_to_the_same_size_returns_the_image():
    image = np.zeros((5, 7, 3), np.uint8)
    assert image_io.resize(image, (7, 5)) is image


def _write_colmap_text(sparse):
    """The text twin of ``test_scene._write_colmap_binary``'s files."""
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n1 PINHOLE 64 48 60.0 60.0 32.0 24.0\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# images\n")
        for iid, name in [(1, "im0.png"), (2, "im1.png")]:
            f.write(f"{iid} 1 0 0 0 0 0 {4.0 + iid} 1 {name}\n")
            f.write("1.0 2.0 7\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i in range(3):
            f.write(f"{i} {i * 1.0} 0.5 -1.0 {10 * i} 20 30 0.5 0 0 0 0\n")


def _assert_same_records(a, b):
    assert a.keys() == b.keys()
    for key in a:
        for field, x, y in zip(a[key]._fields, a[key], b[key]):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=field)
            else:
                assert x == y, field


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_parsers_match_jax(fmt, tmp_path):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap_binary(sparse)
    if fmt == "text":
        _write_colmap_text(sparse)
        for name in ("cameras", "images", "points3D"):
            os.remove(os.path.join(sparse, f"{name}.bin"))
    _assert_same_records(tcolmap.read_intrinsics(sparse),
                         jcolmap.read_intrinsics(sparse))
    _assert_same_records(tcolmap.read_extrinsics(sparse),
                         jcolmap.read_extrinsics(sparse))
    for t, j in zip(tcolmap.read_points3d(sparse),
                    jcolmap.read_points3d(sparse)):
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype
    q = np.random.default_rng(2).normal(size=4)
    q /= np.linalg.norm(q)
    R = tcolmap.qvec2rotmat(q)
    np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
    np.testing.assert_array_equal(tcolmap.rotmat2qvec(R),
                                  jcolmap.rotmat2qvec(R))


@pytest.mark.parametrize("colors", ["float", "uint8"])
def test_point_cloud_io_matches_jax(colors, tmp_path):
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(50, 3))
    rgb = (rng.random((50, 3)) if colors == "float"
           else rng.integers(0, 256, (50, 3), dtype=np.uint8))
    paths = {name: str(tmp_path / f"{name}.ply") for name in ("t", "j")}
    tply.store_point_cloud(paths["t"], xyz, rgb)
    jply.store_point_cloud(paths["j"], xyz, rgb)
    with open(paths["t"], "rb") as a, open(paths["j"], "rb") as b:
        assert a.read() == b.read()
    for t, j in zip(tply.fetch_point_cloud(paths["t"]),
                    jply.fetch_point_cloud(paths["j"])):
        np.testing.assert_array_equal(t, j)


def test_native_library_matches_jax(tmp_path):
    """The port's loader reads the committed library (no build) and its
    kNN and points3D parse equal the JAX package's."""
    assert tnative.available() and jnative.available()
    pts = np.random.default_rng(6).normal(size=(2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(tnative.knn_mean_dist3(pts),
                                  jnative.knn_mean_dist3(pts))
    sparse = str(tmp_path)
    _write_colmap_binary(sparse)
    path = os.path.join(sparse, "points3D.bin")
    for t, j in zip(tnative.read_points3d_binary(path),
                    jnative.read_points3d_binary(path)):
        np.testing.assert_array_equal(t, j)


def _make_colmap_scene(root, model, n_views=6, size=40):
    """A COLMAP-layout scene as tests/test_cli.py builds one: orbit views,
    ``model`` cameras, random RGB and RGBA PNGs (Pillow) and a points3D.bin
    with tracks."""
    sparse = os.path.join(root, "sparse", "0")
    images = os.path.join(root, "images")
    os.makedirs(sparse)
    os.makedirs(images)
    rng = np.random.default_rng(8)
    w, h = size, size - 8
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        if model == "PINHOLE":
            f.write(struct.pack("<iiQQ", 1, 1, w, h))
            f.write(struct.pack("<dddd", 36.0, 34.0, w / 2, h / 2))
        else:
            f.write(struct.pack("<iiQQ", 1, 0, w, h))
            f.write(struct.pack("<ddd", 35.0, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            ang = 2 * np.pi * i / n_views
            fwd = -np.array([np.cos(ang), np.sin(ang), 0.0])
            right = np.cross([0.0, 0.0, 1.0], fwd)
            right /= np.linalg.norm(right)
            rc2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
            q = jcolmap.rotmat2qvec(rc2w.T)
            t = -rc2w.T @ (-fwd * 4.0)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *t))
            f.write(struct.pack("<i", 1))
            f.write(f"view{(i * 5) % n_views}.png\x00".encode())
            f.write(struct.pack("<Q", 0))
            channels = 4 if i % 2 else 3
            arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
            Image.fromarray(arr, MODES[channels]).save(
                os.path.join(images, f"view{(i * 5) % n_views}.png"))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 150))
        pts = rng.uniform(-1, 1, (150, 3))
        for i in range(150):
            f.write(struct.pack("<QdddBBBd", i, *pts[i],
                                *rng.integers(0, 256, 3), 0.5))
            track = int(rng.integers(0, 3))
            f.write(struct.pack("<Q", track) + b"\x00" * (8 * track))


def _make_scene(kind, root):
    if kind.startswith("colmap"):
        _make_colmap_scene(root, kind.split("-")[1])
    else:
        _make_blender_scene(root, n_frames=6, size=40)
        rng = np.random.default_rng(7)
        jply.store_point_cloud(os.path.join(root, "points3d.ply"),
                               rng.normal(size=(120, 3)), rng.random((120, 3)))


def _assert_same_cameras(tcams, jcams):
    assert [c.image_name for c in tcams] == [c.image_name for c in jcams]
    for t, j in zip(tcams, jcams):
        assert (t.uid, t.colmap_id, t.width, t.height) == \
            (j.uid, j.colmap_id, j.width, j.height)
        assert (t.FovX, t.FovY) == (j.FovX, j.FovY)
        for name in ("R", "T", "world_view_transform", "full_proj_transform",
                     "camera_center", "image"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind,resolution,white", [
    ("blender", -1, False), ("blender", 2, True), ("colmap-PINHOLE", -1,
                                                  False),
    ("colmap-SIMPLE_PINHOLE", 4, False)])
def test_scene_matches_jax(kind, resolution, white, tmp_path):
    """Both packages' ``Scene`` on the same files, ``random`` seeded the same
    before each: cameras and their order, GT images (float32, bit-equal),
    the extent, the initial model and the files written."""
    src = str(tmp_path / "scene")
    _make_scene(kind, src)
    kw = dict(resolution=resolution, white_background=white,
              eval_split=True, capacity=256)
    random.seed(3)
    jg = jgm.GaussianModel(sh_degree=2)
    js = JScene(src, str(tmp_path / "jax"), jg, **kw)
    random.seed(3)
    tg = tgm.GaussianModel(sh_degree=2, device="cpu")
    ts = TScene(src, str(tmp_path / "port"), tg, **kw)

    assert ts.cameras_extent == js.cameras_extent
    for get in ("get_train_cameras", "get_test_cameras",
                "get_video_cameras"):
        _assert_same_cameras(getattr(ts, get)(), getattr(js, get)())
    assert len(ts.get_train_cameras()) and len(ts.get_test_cameras())
    for name in ("cameras.json", "input.ply"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    assert tg.spatial_lr_scale == jg.spatial_lr_scale
    for name, t, j in zip(jgm.GaussianParams._fields, tg.params, jg.params):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    np.testing.assert_array_equal(tg.state.alive.numpy(),
                                  np.asarray(jg.state.alive))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cfg_args_interchange(writer, tmp_path):
    """``cfg_args``/``cfg_args.json`` written by one package are read back
    by the other's ``get_combined_args`` (the JAX ``render.py`` opens a
    model directory the port wrote)."""
    model = str(tmp_path)
    params = dict(sh_degree=2, source_path="/data/lego", model_path=model,
                  images="images_4", resolution=2, white_background=True,
                  eval=True)
    src, dst = (tconfig, jconfig) if writer == "port" else (jconfig, tconfig)
    src.save_cfg_args(model, src.ModelParams(**params))
    from argparse import ArgumentParser
    parser = ArgumentParser()
    dst.add_group(parser, dst.ModelParams, fill_none=True)
    dst.add_group(parser, dst.PipelineParams, fill_none=True)
    merged = dst.get_combined_args(parser, ["-m", model])
    for key, value in params.items():
        assert getattr(merged, key) == value, key
    with open(os.path.join(model, "cfg_args")) as f:
        assert dst.parse_legacy_cfg_args(f.read()) == json.load(
            open(os.path.join(model, "cfg_args.json")))


@pytest.mark.parametrize("channels", sorted(MODES))
def test_pil_to_array_matches_jax(channels):
    """``utils.general.pil_to_array`` of the pixels equals the JAX
    package's of the PIL image: (C, H, W) float32, bit for bit."""
    from neuralgaussiansplatting_tpu.utils.general import pil_to_array as jf
    from neuralgaussiansplatting_torch.utils.general import pil_to_array as tf
    image = _test_images(channels, seed=9)[1]
    pil = Image.fromarray(image[..., 0] if channels == 1 else image,
                          MODES[channels])
    for size in ((41, 23), (20, 11), (13, 30)):
        want = jf(pil, size)
        got = tf(image, size)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("silent", [False, True])
def test_safe_state_seeds_and_stamps_like_jax(silent, capsys):
    """Both packages' ``safe_state`` seed ``random`` and numpy alike (so
    ``Scene``'s shuffles agree), the port's also torch, and both stamp or
    drop stdout lines the same way."""
    from neuralgaussiansplatting_tpu.utils.general import safe_state as js
    from neuralgaussiansplatting_torch.utils.general import safe_state as ts
    draws = {}
    for name, safe_state in (("jax", js), ("port", ts)):
        stdout = sys.stdout
        try:
            safe_state(silent, seed=5)
            draws[name] = (random.random(), np.random.rand())
            print("line")
        finally:
            sys.stdout = stdout
    assert draws["port"] == draws["jax"]
    ts(silent, seed=5)
    sys.stdout = sys.stdout.inner
    first = torch.rand(3)
    torch.manual_seed(5)
    assert torch.equal(first, torch.rand(3))
    lines = capsys.readouterr().out.splitlines()
    if silent:
        assert lines == []
    else:
        assert len(lines) == 2 and all(
            line.startswith("line [") and line.endswith("]")
            for line in lines)
