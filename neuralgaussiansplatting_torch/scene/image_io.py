"""Image files for the scene layer, without Pillow.

The JAX package opens every dataset image with PIL
(``scene/dataset_readers.py:58-60,121-150``, ``scene/loader.py:18-24``).
Hosts without Pillow still train PNG datasets through this module:

- ``read_png``: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, all
  five row filters, decoded with numpy and ``zlib`` to the array that
  ``np.asarray(PIL.Image.open(path))`` gives (bit for bit);
- ``write_png``: the encoder (one IDAT chunk, one filter type for every
  row; Up by default, which decodes row by row);
- ``resize``: ``PIL.Image.resize(size)`` with its default BICUBIC filter on
  8-bit images, to the same bytes;
- ``open_image``: a PNG through ``read_png``; a JPEG (or any other format)
  through Pillow where it can be imported, else an error that says to
  convert the images to PNG.

Images are uint8 ``(H, W, C)`` arrays, C = 1 (L), 2 (LA), 3 (RGB) or
4 (RGBA).
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples); 3 (palette) is not read
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}
_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}

# Pillow's fixed-point resampling (libImaging/Resample.c): 32 - 8 - 2 bits
_PRECISION_BITS = 22


class UnsupportedImage(ValueError):
    """An image file this module cannot read; the message names the file and
    its format."""


# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------

def _chunks(path: str, data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(payload) != length or crc_at + 4 > len(data):
            raise UnsupportedImage(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + payload) != crc:
            raise UnsupportedImage(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise UnsupportedImage(f"{path}: PNG ends without an IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays (PNG spec 9.4)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftypes, data):
    """Rows of filter None, Sub or Up only: each row from the one above."""
    out = np.empty_like(data)
    prev = np.zeros_like(data[0])
    for y, f in enumerate(ftypes):
        if f == 0:
            out[y] = data[y]
        elif f == 1:
            # uint8 accumulation wraps modulo 256, as the filter does
            out[y] = np.cumsum(data[y], axis=0, dtype=np.uint8)
        else:
            out[y] = data[y] + prev
        prev = out[y]
    return out


def _skewed_view(a, height, width):
    """(height, width, C) view of a skewed (height + 1, height + width + 1,
    C) array: pixel (y, x) lies at [y + 1, x + y + 2]."""
    s0, s1, s2 = a.strides
    return np.lib.stride_tricks.as_strided(
        a[1:, 2:], shape=(height, width, a.shape[2]),
        strides=(s0 + s1, s1, s2), writeable=True)


def _unfilter_wavefront(ftypes, data):
    """Any mix of the five filters. Average and Paeth read the pixel to the
    left, so a row cannot be done at once; but pixel (y, x) needs only
    (y, x-1), (y-1, x) and (y-1, x-1), so every pixel with the same x + y
    is done in one vectorised step. The image is skewed so that each such
    anti-diagonal is one column of the array: H + W - 1 steps instead of
    H * W pixels."""
    h, w, c = data.shape
    cols = h + w + 1
    src = np.zeros((h + 1, cols, c), np.int16)
    _skewed_view(src, h, w)[...] = data
    out = np.zeros((h + 1, cols, c), np.int16)
    f = np.asarray(ftypes)[:, None]
    sub, up, avg, paeth = f == 1, f == 2, f == 3, f == 4
    # a pixel left of x = 0 (column x + y + 1 of its row) stays 0: its
    # filtered byte and all its neighbours are 0, and so is every predictor
    for s in range(2, h + w + 1):
        lo, hi = max(1, s - w), min(h, s - 1)
        a = out[lo:hi + 1, s - 1]
        b = out[lo - 1:hi, s - 1]
        cc = out[lo - 1:hi, s - 2]
        rows = slice(lo - 1, hi)
        pred = np.where(paeth[rows], _paeth(a, b, cc),
                        np.where(avg[rows], (a + b) >> 1,
                                 np.where(up[rows], b,
                                          np.where(sub[rows], a, 0))))
        out[lo:hi + 1, s] = (src[lo:hi + 1, s] + pred) & 255
    return _skewed_view(out, h, w).astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C); raises ``UnsupportedImage`` for any
    PNG that is not 8-bit L/LA/RGB/RGBA without interlace or a
    transparency key."""
    if not data.startswith(PNG_SIGNATURE):
        raise UnsupportedImage(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"tRNS":
            raise UnsupportedImage(
                f"{path}: PNG with a tRNS transparency chunk is not read")
    if header is None:
        raise UnsupportedImage(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise UnsupportedImage(
            f"{path}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} is not read (8-bit gray, gray+alpha, RGB "
            f"or RGBA without interlace only)")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + width * c
    if raw.size < height * stride:
        raise UnsupportedImage(f"{path}: PNG image data is truncated")
    raw = raw[:height * stride].reshape(height, stride)
    ftypes = raw[:, 0]
    if ftypes.size and ftypes.max() > 4:
        raise UnsupportedImage(f"{path}: unknown PNG row filter "
                               f"{int(ftypes.max())}")
    rows = raw[:, 1:].reshape(height, width, c)
    if np.isin(ftypes, (3, 4)).any():
        return _unfilter_wavefront(ftypes, rows)
    return _unfilter_rows(ftypes, rows)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


# ---------------------------------------------------------------------------
# PNG encoding
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(image: np.ndarray, filter_type: int = 2) -> bytes:
    """uint8 (H, W) or (H, W, C) -> PNG bytes, every row filtered with
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoder takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG encoder takes 1-4 channels, not {c}")
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    elif filter_type == 4:
        upleft = np.zeros_like(x)
        upleft[1:, 1:] = x[:-1, :-1]
        pred = _paeth(left, up, upleft)
    else:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    rows = ((x - pred) & 255).astype(np.uint8).reshape(h, w * c)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, filter_type: int = 2):
    with open(path, "wb") as f:
        f.write(encode_png(image, filter_type))


# ---------------------------------------------------------------------------
# Opening any dataset image
# ---------------------------------------------------------------------------

def open_image(path: str) -> np.ndarray:
    """The image at ``path`` as uint8 (H, W, C), as ``np.asarray`` of
    Pillow's ``Image.open`` gives it (a gray image gets C = 1)."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head == PNG_SIGNATURE:
        return read_png(path)
    kind = "JPEG" if head[:2] == b"\xff\xd8" else "non-PNG"
    try:
        from PIL import Image
    except ImportError:
        raise UnsupportedImage(
            f"{path}: a {kind} image needs Pillow, which is not installed; "
            f"convert the dataset's images to PNG on a host with Pillow") \
            from None
    with Image.open(path) as im:
        if im.mode not in _MODES.values():
            raise UnsupportedImage(f"{path}: image mode {im.mode} is not "
                                   f"read (L, LA, RGB or RGBA only)")
        arr = np.asarray(im)
    return arr[..., None] if arr.ndim == 2 else arr


def to_rgba(image: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGBA")`` of an L, LA, RGB or RGBA image."""
    c = image.shape[2]
    if c == 4:
        return image
    rgb = image[..., :1].repeat(3, axis=2) if c in (1, 2) else image[..., :3]
    alpha = (image[..., 1:2] if c == 2
             else np.full(image.shape[:2] + (1,), 255, np.uint8))
    return np.concatenate([rgb, alpha], axis=2)


# ---------------------------------------------------------------------------
# Pillow's BICUBIC resize
# ---------------------------------------------------------------------------

def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter, a = -0.5, support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int):
    """(first tap (out,), taps (out,), fixed-point weights (out, ksize)) of
    Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero; below 0 it is clamped anyway
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    k = np.arange(ksize)
    taps = k[None, :] < xmax[:, None]
    w = np.where(taps, _bicubic(
        ((k[None, :] + xmin[:, None]) - center[:, None] + 0.5)
        * (1.0 / filterscale)), 0.0)
    # Pillow sums the weights one by one in tap order; numpy's pairwise
    # sum can differ in the last bit, so add them in order
    ww = np.zeros((out_size, 1))
    for j in range(ksize):
        ww[:, 0] += w[:, j]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, xmax, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` (0 rows, 1
    columns) of a uint8 (H, W, C) image, clipped to uint8. The sums are
    int32, as Pillow's are (its weights keep them in range)."""
    in_size = img.shape[axis]
    xmin, xmax, kk = _coefficients(in_size, out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    src = img.astype(np.int32)
    for j in range(kk.shape[1]):
        weight = np.where(j < xmax, kk[:, j], 0).astype(np.int32)
        idx = np.minimum(xmin + j, in_size - 1)
        acc += np.take(src, idx, axis=axis) * weight.reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(image: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (LA -> La): colour times alpha / 255, Pillow's
    MULDIV255 rounding."""
    out = image.copy()
    alpha = image[..., -1:].astype(np.uint32)
    tmp = image[..., :-1].astype(np.uint32) * alpha + 128
    out[..., :-1] = ((tmp >> 8) + tmp) >> 8
    return out


def _unpremultiply(image: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (La -> LA): Pillow's rgba2rgbA, colour * 255 / alpha
    (integer division, clipped) where alpha is neither 0 nor 255."""
    out = image.copy()
    alpha = image[..., -1:].astype(np.int32)
    keep = (alpha == 0) | (alpha == 255)
    scaled = np.minimum(image[..., :-1].astype(np.int32) * 255
                        // np.where(keep, 1, alpha), 255)
    out[..., :-1] = np.where(keep, image[..., :-1], scaled)
    return out


def resize(image: np.ndarray, size) -> np.ndarray:
    """``PIL.Image.resize(size)`` (BICUBIC) of a uint8 (H, W, C) image;
    ``size`` is (width, height). An image with alpha is resized
    premultiplied, as Pillow does; the same size returns the image."""
    w_out, h_out = int(size[0]), int(size[1])
    h, w, c = image.shape
    if (w_out, h_out) == (w, h):
        return image
    if w_out <= 0 or h_out <= 0:
        raise ValueError(f"resize to {size}: sizes must be positive")
    alpha = c in (2, 4)
    img = _premultiply(image) if alpha else image
    if w_out != w:
        img = _resample_axis(img, w_out, 1)
    if h_out != h:
        img = _resample_axis(img, h_out, 0)
    return _unpremultiply(img) if alpha else img
