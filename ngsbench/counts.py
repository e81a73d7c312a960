"""Operations and bytes that a view's work needs, and the card's peaks.

Every count is of what these inputs need, from the reference's own
per-pixel counts (``reference.render.render(..., counts=True)``), never
from anything the program made: "fwd_pairs" are the (Gaussian, pixel)
pairs with alpha >= 1/255 up to and including the one that stops the pixel
(a pair outside a Gaussian's footprint needs no work), "blended" the pairs
that blend, which are also every pair the backward walks before a pixel's
last contributor, "instances" the (Gaussian, tile) pairs with a visited
pixel, "gaussians_needed" the Gaussians with such a pair, "drawn" those in
front of the camera, "pixels" the view's. A fused multiply-add counts as
two operations, exp, log, sqrt and a division as one each.

Per-pair operations, as a kernel computing the reference's rules must:

- forward, a visited pair (``FWD_PAIR_OPS`` = 16): the offset from the
  centre (2 subtractions), the power -0.5 (a dx^2 + c dy^2) - b dx dy
  (6 multiplications, 1 addition, 1 multiplication by -0.5, 1
  subtraction), exp, opacity x exp, the 0.99 clamp, the power > 0 and
  1/255 tests (2);
- forward, a blended pair, beyond that (``FWD_BLEND_OPS`` = 10): T (1 - alpha)
  (2), the 1e-4 test, alpha T, and three colour FMAs (6);
- backward, a walked pair (``BWD_PAIR_OPS`` = 60): the forward's 16
  recomputed; T recovered (1 - alpha, a division: 2); per channel the
  running colour behind it (an FMA and a multiply-add: 4) and its share of
  dL/dalpha (an FMA: 2), 18 for three; dL/dalpha times T (1); the colour
  gradient (3 multiplications, 3 additions into the Gaussian's sums: 6);
  dL/dG and dL/dopacity (2, 1 addition: 3); the power's gradient to the
  centre (4 multiplications, 2 FMAs: 8) and to the conic (3
  multiplications, 3 additions: 6).

The bytes of K1 and K2 are each input byte read once and each output byte
written once, over what these inputs need: a visited instance's packed
record (9 float32: centre, conic, opacity, colour), a pixel's outputs
(colour, final T, contributor count: 5 float32), each tile's start and
count (2 int32); K2 reads the records, K1's outputs and the image's
cotangent (colour and T: 4 float32 a pixel) and writes one 9-float32
gradient record per instance.

A whole step (``step_ops``) adds per drawn Gaussian the projection and
EWA covariance (``PROJECT_OPS``) and SH of degree 3 (``SH3_OPS``), twice
that again for their backward; per pixel and channel the L1 + SSIM loss
and its gradient (``LOSS_OPS``); per trainable element Adam
(``ADAM_OPS``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_OPS = 67e12          # op/s outside the tensor cores
PEAK_HBM_BYTES = 3.35e12       # bytes/s

FWD_PAIR_OPS = 16
FWD_BLEND_OPS = 10
BWD_PAIR_OPS = 60
RECORD_BYTES = 9 * 4
PIXEL_OUT_BYTES = 5 * 4
PIXEL_COT_BYTES = 4 * 4
TILE_BYTES = 2 * 4

# quaternion normalisation and rotation (40), the 3D covariance (45),
# view and projective transforms (2 x 21 + 3 divisions), the Jacobian and
# T = J W (24), the screen covariance and low-pass (38), determinant,
# conic and radius (16), the tile rect (14)
PROJECT_OPS = 222
# direction and its normalisation (11), the 16 basis functions (36), three
# channels of 16 FMAs (96), + 0.5 and the clamp (6)
SH3_OPS = 149
# per pixel and channel: L1 and its gradient (5); SSIM's five maps (3),
# two 11-tap separable blur passes of five maps (220), the SSIM map (20),
# the same backwards (3 + 220 + 30); the mean (1)
LOSS_OPS = 502
# per element: the masked gradient (1), two moments (6), two bias
# corrections (2), sqrt, + eps, the division, the rate and the update (5)
ADAM_OPS = 14


def k1_ops(c: dict) -> float:
    return c["fwd_pairs"] * FWD_PAIR_OPS + c["blended"] * FWD_BLEND_OPS


def k1_bytes(c: dict, tiles: int) -> float:
    return (c["instances"] * RECORD_BYTES + c["pixels"] * PIXEL_OUT_BYTES
            + tiles * TILE_BYTES)


def k2_ops(c: dict) -> float:
    return c["blended"] * BWD_PAIR_OPS


def k2_bytes(c: dict, tiles: int) -> float:
    return (2 * c["instances"] * RECORD_BYTES
            + c["pixels"] * (PIXEL_OUT_BYTES + PIXEL_COT_BYTES)
            + tiles * TILE_BYTES)


def least_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_least_s(c: dict, tiles: int) -> tuple[float, str]:
    return least_s(k1_ops(c), k1_bytes(c, tiles))


def k2_least_s(c: dict, tiles: int) -> tuple[float, str]:
    return least_s(k2_ops(c), k2_bytes(c, tiles))


def step_ops(c: dict, kind: str, trainable: int = 0) -> float:
    """Operations one render ("render") or training step ("train") needs,
    ``trainable`` the elements Adam updates."""
    per_gaussian = PROJECT_OPS + SH3_OPS
    ops = c["drawn"] * per_gaussian + k1_ops(c)
    if kind == "train":
        ops += (2 * c["drawn"] * per_gaussian + k2_ops(c)
                + 3 * c["pixels"] * LOSS_OPS + trainable * ADAM_OPS)
    return float(ops)
