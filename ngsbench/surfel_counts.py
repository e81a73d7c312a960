"""Operations and bytes that a 2D Gaussian Splatting training step needs
(``loops/surfel_train.py``), from the reference's counts of the same views
(``reference.surfel.render(..., counts=True)``: "fwd_pairs", "blended",
"instances", "drawn", "pixels", with ``counts.py``'s meanings) and the
shapes, never from anything the program made. A fused multiply-add counts
as two operations, exp, a division and a square root as one each.

Per-pair operations of the surfel blend, as a kernel computing the
reference's rules must (``ops/surfel_blend.py`` states them):

- forward, a visited pair (``FWD_PAIR_OPS`` = 45): k = x T_w - T_u and
  l = y T_w - T_v (6 multiplications, 6 subtractions: 12), c = k x l (6
  multiplications, 3 subtractions: 9), u and v (2 divisions), rho3d (2
  multiplications, 1 addition: 3), the offset from the centre (2), rho2d (2
  multiplications, 1 addition, 1 multiplication: 4), the min and its
  select (2), z (2 multiplications, 2 additions: 4), the power (1), the c.z
  and near tests (2), exp, opacity x exp, the 0.99 clamp and the 1/255
  test (4);
- forward, a blended pair beyond that (``FWD_BLEND_OPS`` = 34): T alpha
  and T - T alpha (2), the 1e-4 test (1), m = M (1 - near / z) (3), the
  distortion's term ((m m)(1 - T) + M2) - (2 m) M1 (7) times w and added
  (2), the depth, M1 and M2 sums (3 FMAs: 6, and m m w: 1), the median
  test (1), three colour and three normal FMAs (12);
- backward, a blended pair (``BWD_PAIR_OPS`` = 160): the forward's 45 and
  the T, m and weight of the blend (6) recomputed; the weight gradient g_w
  (colour and normal dots: 10, z g_depth: 2, the distortion's weight
  gradient: 7) (19); the prefix FMA (2); dalpha (5); the depth gradient
  (10) and the median's (2); the power's (2); on the intersection's side
  g_u, g_v (8), g_c (7), g_k and g_l (18), the transform's 9 rows (6
  negations and adds, 3 x 5: 21); the opacity's, colour's and normal's
  rows (2 + 6 + 6: 14).

The bytes of the blend kernels are each input byte read once and each
output byte written once over what these inputs need: a visited
instance's packed row (18 float32), a pixel's 14 outputs, each tile's
start and count (2 int32); the backward reads the rows, 13 of the
forward's outputs and 10 of the cotangent's channels a pixel and writes
one 18-float32 gradient row per instance.

The preprocess's surfel variant, per surfel of the model (each read once
and written once): forward 82 float32 (xyz 3, scales 2, rotation 4,
opacity 1, SH 48 in; centre 2, depth 1, radius 1, transform 9, normal 3,
rgb 3, the rects 4 and tiles 1 out), backward 133 (xyz, scales, rotation
and SH, and the gradients of the centre, transform, normal and rgb in:
74; the gradients of xyz, scales, rotation, SH and the offset out: 59).

A whole step (``step_ops``) adds per drawn surfel its projection
(``PROJECT_OPS`` = 216: the quaternion's normalisation and rotation (40),
the scaled tangents (6), the clip rows of the tangents and the centre and
the view depth (66), ndc2pix (18), the normal, its cosine and turn (24),
the box's centre and half-sizes and the radius (45), the tile rect (14),
the depth test and the rest (3)) and SH of degree 3 (``counts.SH3_OPS``),
twice that again for their backward; per pixel the regularisers
(``REG_OPS`` = 255: the normal's world turn (15), the expected depth (3),
the unprojection (21), the differences, cross product and normalisation
(25), the product with alpha and the dot (8), the means (3); the same
twice backwards) and per pixel and channel the L1 + SSIM loss
(``counts.LOSS_OPS``); per trainable element Adam (``counts.ADAM_OPS``).
"""

from __future__ import annotations

from ngsbench import counts

FWD_KERNEL = "surfel_blend_fwd_kernel"
BWD_KERNEL = "surfel_blend_bwd_kernel"
PP_FWD_KERNEL = "preprocess_surfel_fwd_kernel"
PP_BWD_KERNEL = "preprocess_surfel_bwd_kernel"

FWD_PAIR_OPS = 45
FWD_BLEND_OPS = 34
BWD_PAIR_OPS = 160
ROW_BYTES = 18 * 4
PIXEL_OUT_BYTES = 14 * 4
PIXEL_BWD_IN_BYTES = (13 + 10) * 4
TILE_BYTES = 2 * 4
PP_FWD_BYTES = 82 * 4
PP_BWD_BYTES = 133 * 4
PROJECT_OPS = 216
REG_OPS = 255


def fwd_ops(c: dict) -> float:
    return float(c["fwd_pairs"] * FWD_PAIR_OPS + c["blended"] * FWD_BLEND_OPS)


def fwd_bytes(c: dict, tiles: int) -> float:
    return float(c["instances"] * ROW_BYTES + c["pixels"] * PIXEL_OUT_BYTES
                 + tiles * TILE_BYTES)


def bwd_ops(c: dict) -> float:
    return float(c["blended"] * BWD_PAIR_OPS)


def bwd_bytes(c: dict, tiles: int) -> float:
    return float(2 * c["instances"] * ROW_BYTES
                 + c["pixels"] * PIXEL_BWD_IN_BYTES + tiles * TILE_BYTES)


def fwd_least_s(c: dict, tiles: int) -> tuple[float, str]:
    return counts.least_s(fwd_ops(c), fwd_bytes(c, tiles))


def bwd_least_s(c: dict, tiles: int) -> tuple[float, str]:
    return counts.least_s(bwd_ops(c), bwd_bytes(c, tiles))


def preprocess_least_s(surfels: int) -> float:
    """The least time of one forward and one backward launch over
    ``surfels`` rows: bytes."""
    return surfels * (PP_FWD_BYTES + PP_BWD_BYTES) / counts.PEAK_HBM_BYTES


def step_ops(c: dict, trainable: int) -> float:
    """The operations of one training step whose reference counts are
    ``c``, ``trainable`` the elements Adam updates."""
    per_surfel = PROJECT_OPS + counts.SH3_OPS
    ops = 3 * c["drawn"] * per_surfel + fwd_ops(c) + bwd_ops(c)
    ops += c["pixels"] * (REG_OPS + 3 * counts.LOSS_OPS)
    ops += trainable * counts.ADAM_OPS
    return float(ops)
