"""Image metrics and OpenCV live-monitoring windows (port of
``utils/image.py``, numpy and cv2 code copied unchanged).

``mse`` / ``psnr`` take numpy arrays (or anything ``np.asarray`` takes);
the window functions (``show_img``, ``show_img2``, ``show_img_grid``) are
no-ops that return False where there is no ``DISPLAY`` (unless
``NGS_FORCE_GUI`` is set), and cv2 is imported only when a window opens, so
a headless host needs no OpenCV.
"""

from __future__ import annotations

import numpy as np


def mse(a, b):
    return float(((np.asarray(a) - np.asarray(b)) ** 2).mean())


def psnr(a, b):
    m = mse(a, b)
    return float("inf") if m == 0 else 20.0 * np.log10(1.0 / np.sqrt(m))


def _to_bgr_u8(img):
    """Accept (3, H, W) or (H, W, 3) float [0,1] or uint8 -> BGR uint8."""
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]:
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2 or arr.shape[-1] == 1:
        arr = np.repeat(arr.reshape(*arr.shape[:2], 1), 3, axis=-1)
    return arr[..., ::-1].copy()  # RGB -> BGR


def _gui_available():
    import os
    if not os.environ.get("DISPLAY") and not os.environ.get(
            "NGS_FORCE_GUI"):
        return False
    try:
        import cv2  # noqa: F401
        return True
    except ImportError:
        return False


def show_img(img, title: str = "render", wait_ms: int = 1) -> bool:
    """Live single-image window (reference :27-63). Returns False headless."""
    if not _gui_available():
        return False
    import cv2
    cv2.imshow(title, _to_bgr_u8(img))
    cv2.waitKey(wait_ms)
    return True


def show_img2(img_a, img_b, title: str = "render vs gt",
              wait_ms: int = 1, labels=("render", "gt")) -> bool:
    """Side-by-side compare window (reference :66-146)."""
    if not _gui_available():
        return False
    import cv2
    a, b = _to_bgr_u8(img_a), _to_bgr_u8(img_b)
    h = max(a.shape[0], b.shape[0])
    def padto(x):
        return np.pad(x, ((0, h - x.shape[0]), (0, 0), (0, 0)))
    canvas = np.concatenate([padto(a), padto(b)], axis=1)
    cv2.putText(canvas, labels[0], (8, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1)
    cv2.putText(canvas, labels[1], (a.shape[1] + 8, 18),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
    cv2.imshow(title, canvas)
    cv2.waitKey(wait_ms)
    return True


def make_grid(images, cols: int | None = None, pad: int = 2) -> np.ndarray:
    """Tile images into one canvas (the compositing core of show_img_grid)."""
    imgs = [_to_bgr_u8(i) for i in images]
    n = len(imgs)
    if cols is None:
        cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    canvas = np.zeros((rows * (h + pad), cols * (w + pad), 3), np.uint8)
    for k, im in enumerate(imgs):
        r, c = divmod(k, cols)
        canvas[r * (h + pad):r * (h + pad) + im.shape[0],
               c * (w + pad):c * (w + pad) + im.shape[1]] = im
    return canvas


def show_img_grid(images, title: str = "grid", cols=None,
                  wait_ms: int = 1) -> bool:
    """Grid window (reference :148-239)."""
    if not _gui_available():
        return False
    import cv2
    cv2.imshow(title, make_grid(images, cols))
    cv2.waitKey(wait_ms)
    return True
