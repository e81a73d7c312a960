"""Init-time 3-nearest-neighbour mean squared distance (seeds Gaussian scales).

Host code, run once at model creation. As in the JAX package, the
repository's native library (``native.knn_mean_dist3``: exact, Morton-boxed,
multithreaded) comes first, so both packages seed the same scales; where it
cannot be loaded, an exact KD-tree query through scipy (a note is printed
once), and a chunked brute-force torch search where scipy is missing too.
"""

from __future__ import annotations

import numpy as np
import torch

from neuralgaussiansplatting_torch import native

_FALLBACK_NOTED = False


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N,) float32 mean squared distance to the 3 nearest
    neighbours (fewer when N <= 3)."""
    global _FALLBACK_NOTED
    points = np.asarray(points, dtype=np.float32)
    if len(points) < 2:
        return np.zeros(len(points), np.float32)
    if len(points) > 4:
        res = native.knn_mean_dist3(points)
        if res is not None:
            return res
        if not _FALLBACK_NOTED:
            _FALLBACK_NOTED = True
            print(f"kNN: native library {native.LIBRARY} not loadable; "
                  f"using scipy")
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        return _brute_force_3nn(points)
    tree = cKDTree(points)
    # the first neighbour of each point is itself, at distance 0; the query
    # runs on every host core
    d, _ = tree.query(points, k=min(4, len(points)), workers=-1)
    d2 = np.atleast_2d(d)[:, 1:] ** 2
    return d2.mean(axis=1).astype(np.float32)


def _brute_force_3nn(points: np.ndarray, chunk: int = 2048) -> np.ndarray:
    pts = torch.from_numpy(points).double()
    k = min(4, len(points))
    out = []
    for i in range(0, len(points), chunk):
        d2 = torch.cdist(pts[i:i + chunk], pts).square()
        top = torch.topk(d2, k, dim=1, largest=False).values
        out.append(top[:, 1:].mean(dim=1))
    return torch.cat(out).numpy().astype(np.float32)
