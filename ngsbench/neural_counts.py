"""Operations that a neural training step's decoders need, K3's bound, and
the card's TF32 peak.

The decoders' convolutions (``render2``: the UNet and the CNN of the
fork's ``utils/net_utils.py``) are counted from their shapes alone: a
convolution of ``cin`` to ``cout`` channels with a k x k kernel makes
2 cin cout k^2 operations per output pixel (a multiply-add as two), a
stride-2 transposed convolution the same per input pixel. A training step
runs each forward once and twice again backward, for the gradient of its
input and of its weight: every layer's input needs one, as the features
train through the feature map into the first layers. Biases, ReLUs,
pooling and the denoiser are left out: they are not the tensor cores'
work.

K3's bound (``k3_least_s``) counts from the reference's z-buffer
(``reference.neural.zbuffer``'s counts): per (point, tile) instance a
rect row and a depth read (6 x 4 bytes), per tile its start and count (2
x 4), per pixel the winner's id and depth written (2 x 4); per covered
(point, pixel) pair ``K3_PAIR_OPS`` 32-bit operations at the FP32 rate.
"""

from __future__ import annotations

from ngsbench import counts

# NVIDIA H100 SXM data sheet: dense TF32 tensor-core operations per second
PEAK_TF32_OPS = 494.7e12
K3_RECORD_BYTES = 6 * 4
K3_TILE_BYTES = 2 * 4
K3_PIXEL_BYTES = 2 * 4
# 3 compares, 1 and, 1 or (nearer, or as near with a lower id), 2 selects
K3_PAIR_OPS = 7
TILE_PIXELS = 32 * 32


def unet_layers(h: int, w: int, cin: int, base: int, levels: int,
                out: int = 3) -> list:
    """(cin, cout, k, pixels counted) of the UNet's convolutions, in
    order; a transposed convolution counts its input's pixels."""
    def pixels(level):
        return (h >> level) * (w >> level)

    layers = []
    for i in range(levels):
        width = base << i
        layers += [(cin, width, 3, pixels(i)), (width, width, 3, pixels(i))]
        cin = width
    for level in range(levels - 2, -1, -1):
        width = base << level
        layers += [(2 * width, width, 2, pixels(level + 1)),
                   (2 * width, width, 3, pixels(level)),
                   (width, width, 3, pixels(level))]
    return layers + [(base, out, 1, pixels(0))]


def cnn_layers(h: int, w: int, channels, k: int) -> list:
    return [(a, b, k, h * w) for a, b in zip(channels[:-1], channels[1:])]


def layers(cfg: dict, h: int, w: int) -> list:
    """The decoders' convolutions at the configuration's widths
    (``num_features``, ``unet_base_channels``, ``unet_levels``,
    ``cnn_channels``, ``cnn_kernel``) for an h x w view."""
    return (unet_layers(h, w, cfg["num_features"],
                        cfg["unet_base_channels"], cfg["unet_levels"])
            + cnn_layers(h, w, cfg["cnn_channels"], cfg["cnn_kernel"]))


def forward_ops(cfg: dict, h: int, w: int) -> float:
    """The UNet's and the CNN's convolution operations for one view."""
    return float(sum(2 * ci * co * k * k * p
                     for ci, co, k, p in layers(cfg, h, w)))


def step_ops(cfg: dict, h: int, w: int) -> float:
    """A training step's: the forward, the input's and the weight's
    gradients."""
    return 3 * forward_ops(cfg, h, w)


def k3_bytes(c: dict) -> float:
    return (c["instances"] * K3_RECORD_BYTES + c["tiles"] * K3_TILE_BYTES
            + c["tiles"] * TILE_PIXELS * K3_PIXEL_BYTES)


def k3_least_s(c: dict) -> tuple[float, str]:
    """(least seconds of one K3 launch, what bounds it)."""
    return counts.least_s(c["pairs"] * K3_PAIR_OPS, k3_bytes(c))
