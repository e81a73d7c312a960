"""Per-instance attribute packing for the blend kernels, and its gradient.

Named after the JAX package's ``ops/blend_pallas.py``, whose packing and
``pack_gather`` this is. The packed table has one column per Gaussian plus an
all-zero sentinel column at index N: padding instances carry ``gid == N``,
so they read zeros (opacity 0 => alpha 0) and every blend update they make
is a no-op. The 16x16 kernels of that module (K4, K5) belong to a later
slice of the port.

The gradient of ``pack_gather`` sums each Gaussian's per-slot gradient rows:
a stable sort of the slots by ``gid``, then a sum over each Gaussian's run of
slots in slot order. That is exact over the slots present, whether or not
binning dropped instances (what the JAX package's ``grad_reduce`` modes reach
through two sort variants and a scatter), and it repeats bit for bit: no
atomics. The JAX package's cumsum-difference reduction is a TPU layout
device and is not ported.
"""

from __future__ import annotations

import torch

# Packed row layout: 0:x 1:y 2:conic_A 3:conic_B 4:conic_C 5:opacity 6:r 7:g
# 8:b. (The TPU kernels pad these 9 rows to 16 sublanes; the CUDA kernels
# read and write the 9 rows directly.)
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


def sum_rows_by_id(rows: torch.Tensor, ids: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(K, C) rows -> (n, C) sums of the rows of each id in [0, n).

    Rows with ``id == n`` (padding) are left out. Each id's rows are added
    in row order: a stable sort by id, then one sum per id's run, so the
    result repeats bit for bit (no atomics).
    """
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    starts = torch.searchsorted(ids[order],
                                torch.arange(n + 1, device=ids.device))
    # n segments [starts[g], starts[g + 1]); the padding run after
    # starts[n] is not one of them. unsafe=True skips validation that would
    # sync the host; the offsets are monotone and within [0, K].
    return torch.segment_reduce(rows[order], "sum", offsets=starts, axis=0,
                                unsafe=True)


def reduce_by_gaussian(cot9: torch.Tensor, gid: torch.Tensor,
                       n: int) -> torch.Tensor:
    """(9, K) per-slot rows -> (9, n + 1) per-Gaussian sums.

    Slots with ``gid == n`` (padding) are left out, and column n (the
    sentinel) is zero. Each Gaussian's slots are added in slot order.
    """
    sums = sum_rows_by_id(cot9.t(), gid, n)            # (n, 9)
    return torch.cat([sums, sums.new_zeros((1, PROWS))]).t().contiguous()


class _PackGather(torch.autograd.Function):
    """Gather by ``gid`` forward; the per-Gaussian sum backward."""

    @staticmethod
    def forward(ctx, packed_all, gid):
        ctx.save_for_backward(gid)
        ctx.num_gaussians = packed_all.shape[1] - 1
        return packed_all[:, gid.long()].contiguous()

    @staticmethod
    def backward(ctx, cot):
        (gid,) = ctx.saved_tensors
        return reduce_by_gaussian(cot, gid, ctx.num_gaussians), None


def pack_gather(packed_all: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(9, N + 1) packed table -> (9, K) per-instance columns by ``gid``,
    differentiable with respect to ``packed_all``."""
    return _PackGather.apply(packed_all, gid)
