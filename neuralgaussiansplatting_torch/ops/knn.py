"""Init-time 3-nearest-neighbour mean squared distance (seeds Gaussian scales).

Host code, run once at model creation: an exact KD-tree query through scipy,
with a chunked brute-force torch fallback where scipy is missing. The JAX
package's native Morton-box library is not loaded here (see ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N,) float32 mean squared distance to the 3 nearest
    neighbours (fewer when N <= 3)."""
    points = np.asarray(points, dtype=np.float32)
    if len(points) < 2:
        return np.zeros(len(points), np.float32)
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
