"""Per-instance attribute packing for the blend kernels.

Named after the JAX package's ``ops/blend_pallas.py``, whose packing and
forward gather this is. The packed table has one column per Gaussian plus an
all-zero sentinel column at index N: padding instances carry ``gid == N``,
so they read zeros (opacity 0 => alpha 0) and every blend update they make
is a no-op. The per-Gaussian gradient reduction of ``pack_gather`` (its
backward) and the 16x16 kernels of that module (K4, K5) belong to later
slices of the port.
"""

from __future__ import annotations

import torch

# Packed row layout: 0:x 1:y 2:conic_A 3:conic_B 4:conic_C 5:opacity 6:r 7:g
# 8:b. (The TPU kernels pad these 9 rows to 16 sublanes; the CUDA kernel
# reads the 9 rows directly.)
PROWS = 9


def pack_instance_attrs_t(means2d, conic, opacity, rgb):
    """Per-Gaussian attrs -> (9, N + 1) float32 columns; the last column is
    the all-zero sentinel for padding instances."""
    packed = torch.stack([
        means2d[:, 0], means2d[:, 1],
        conic[:, 0], conic[:, 1], conic[:, 2],
        opacity,
        rgb[:, 0], rgb[:, 1], rgb[:, 2],
    ], dim=0).float()                                  # (9, N)
    return torch.cat([packed, packed.new_zeros((PROWS, 1))], dim=1)


def pack_gather(packed_all: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(9, N + 1) packed table -> (9, K) per-instance columns by ``gid``."""
    return packed_all[:, gid.long()].contiguous()
