"""Operations and bytes that a Scaffold-GS training step needs
(``loops/scaffold_train.py``), from the reference's counts of the same
views (``reference.scaffold.steps``), never from anything the program
made.

Operations, a fused multiply-add as two (``step_ops``):

- the MLPs, per visible anchor: each of the three
  ``Linear(in, hidden) -> ReLU -> Linear(hidden, out)`` as 2 in hidden +
  hidden (bias) + hidden (ReLU) + 2 hidden out + out (bias), their
  activations one operation an output (tanh, sigmoid), from the
  configuration's widths (``mlp_ops``); backward twice the forward (the
  input's and the weight's gradients);
- the generation, per candidate of a visible anchor (``GENERATE_OPS``):
  the position (3 FMAs: 6), the scale (3 sigmoids and 3 products: 6), the
  quaternion's normalisation (4 squares, 3 additions, a square root and 4
  divisions: 12) and the gate (2); its backward twice that;
- the prefilter, per anchor: the projection and EWA covariance
  (``counts.PROJECT_OPS``);
- per Gaussian drawn: the projection (``counts.PROJECT_OPS``) and its
  backward twice that, no SH (the colours come from the MLP);
- the blend: ``counts.k1_ops`` and ``counts.k2_ops`` of the reference's
  pair counts; the loss, ``counts.LOSS_OPS`` a pixel and channel; Adam,
  ``counts.ADAM_OPS`` a trainable element.

Bytes of the preprocess kernels (``preprocess_least_s``): one launch over
the anchors (the prefilter) and one forward and one backward over the
candidates of the visible anchors, each row's inputs read once and its
outputs written once: forward 23 floats (xyz, scale, rotation, opacity in;
means2d, depth, radius, conic, rect, tiles out; the precomputed colours
pass through), backward 25 (xyz, scale, rotation and the means2d and conic
gradients in; the xyz, scale and rotation gradients out).
"""

from __future__ import annotations

from ngsbench import counts

FWD_KERNEL = "preprocess_fwd_kernel"
BWD_KERNEL = "preprocess_bwd_kernel"
PP_FWD_BYTES = 23 * 4
PP_BWD_BYTES = 25 * 4
GENERATE_OPS = 26


def mlp_ops(cfg: dict) -> float:
    """The three MLPs' forward operations for one anchor."""
    f, k, h = cfg["feat_dim"], cfg["n_offsets"], cfg["mlp_hidden"]
    a, c = cfg["appearance_dim"], cfg["cov_dim"]
    ops = 0
    for cin, cout, act in ((f + 3, k, k), (f + 3, c * k, 0),
                           (f + 3 + a, 3 * k, 3 * k)):
        ops += 2 * cin * h + 2 * h + 2 * h * cout + cout + act
    return float(ops)


def step_ops(c: dict, cfg: dict, trainable: int) -> float:
    """The operations of one training step whose reference counts are
    ``c``, ``trainable`` the elements Adam updates."""
    k = cfg["n_offsets"]
    ops = 3 * c["visible_anchors"] * (mlp_ops(cfg) + k * GENERATE_OPS)
    ops += c["anchors"] * counts.PROJECT_OPS
    ops += 3 * c["drawn"] * counts.PROJECT_OPS
    ops += counts.k1_ops(c) + counts.k2_ops(c)
    ops += 3 * c["pixels"] * counts.LOSS_OPS + trainable * counts.ADAM_OPS
    return float(ops)


def preprocess_bytes(c: dict, n_offsets: int) -> float:
    """The bytes of a step's three preprocess launches."""
    candidates = c["visible_anchors"] * n_offsets
    return (c["anchors"] * PP_FWD_BYTES
            + candidates * (PP_FWD_BYTES + PP_BWD_BYTES))


def preprocess_least_s(c: dict, n_offsets: int) -> float:
    return preprocess_bytes(c, n_offsets) / counts.PEAK_HBM_BYTES
