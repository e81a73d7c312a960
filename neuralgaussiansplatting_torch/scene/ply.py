"""Minimal PLY I/O (binary little-endian + ascii read) with numpy.

The port's own copy of the reference-schema reader/writer, so Gaussian
checkpoints interchange with the JAX package and the upstream 3DGS code,
and of the input point-cloud pair ``fetch_point_cloud`` /
``store_point_cloud`` the dataset readers use.
"""

from __future__ import annotations

import os

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Read the ``vertex`` element of a PLY file into a structured array.

    Supports binary_little_endian and ascii, scalar properties only.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, np_type)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported")
                elements[-1][2].append((tokens[2], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        out = {}
        for name, count, props in elements:
            if fmt == "binary_little_endian":
                dtype = np.dtype([(p, "<" + t) for p, t in props])
                out[name] = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
            elif fmt == "ascii":
                dtype = np.dtype([(p, t) for p, t in props])
                rows = [tuple(f.readline().split()) for _ in range(count)]
                out[name] = np.array(
                    [tuple(float(v) for v in r) for r in rows], dtype=dtype)
            else:
                raise ValueError(f"unsupported PLY format {fmt}")
    if "vertex" not in out:
        raise ValueError(f"{path}: no vertex element")
    return out["vertex"]


def write_ply(path, names, columns, comment=None):
    """Write float32 columns as a binary_little_endian vertex element.

    ``columns`` is a (N, len(names)) array or list of (N,) arrays.
    """
    if isinstance(columns, (list, tuple)):
        columns = np.stack([np.asarray(c).reshape(-1) for c in columns], axis=1)
    columns = np.asarray(columns, dtype=np.float32)
    n = columns.shape[0]
    if columns.shape[1] != len(names):
        raise ValueError(f"{columns.shape[1]} columns for {len(names)} names")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        if comment:
            f.write(f"comment {comment}\n".encode())
        f.write(f"element vertex {n}\n".encode())
        for name in names:
            f.write(f"property float {name}\n".encode())
        f.write(b"end_header\n")
        rec = np.rec.fromarrays(columns.T, names=list(names),
                                formats=["<f4"] * len(names))
        f.write(rec.tobytes())


def fetch_point_cloud(path):
    """Read (points, colors, normals) with the reference's random fallbacks.

    Reference dataset_readers.py:108-130 (fork behavior): missing color
    properties -> random colors; missing normals -> random normals.
    """
    v = read_ply(path)
    names = v.dtype.names
    positions = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    n = positions.shape[0]
    if all(k in names for k in ("red", "green", "blue")):
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=1) / 255.0
    else:
        colors = np.random.rand(n, 3)
    if all(k in names for k in ("nx", "ny", "nz")):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
    else:
        normals = np.random.rand(n, 3)
    return positions, colors, normals


def store_point_cloud(path, xyz, rgb):
    """Write an input point cloud with uchar colors, reference storePly
    (dataset_readers.py:132-147)."""
    n = xyz.shape[0]
    normals = np.zeros_like(xyz, dtype=np.float32)
    dtype = np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ])
    rec = np.empty(n, dtype=dtype)
    for i, k in enumerate(("x", "y", "z")):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("nx", "ny", "nz")):
        rec[k] = normals[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = (np.clip(rgb[:, i], 0, 1) * 255).astype(np.uint8) if rgb.dtype.kind == "f" else rgb[:, i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, t in [("x", "float"), ("y", "float"), ("z", "float"),
                        ("nx", "float"), ("ny", "float"), ("nz", "float"),
                        ("red", "uchar"), ("green", "uchar"), ("blue", "uchar")]:
            f.write(f"property {t} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
