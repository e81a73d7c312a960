"""Config / flag system with reference-compatible CLI surface.

The port's own copy of the JAX package's ``config.py``: the same groups,
flags, defaults (but ``data_device``, "cuda" as in the reference) and the
same ``cfg_args`` / ``cfg_args.json`` files, so the JAX package's
``get_combined_args`` reads a model directory written by the port.

Behavioral parity target: reference arguments/__init__.py — the reflection
based ``ParamGroup`` (:19-45; leading ``_`` attr => one-letter shorthand,
types inferred from defaults), ``ModelParams`` (:47-62), ``PipelineParams``
(:64-69), ``OptimizationParams`` (:71-90), and ``get_combined_args`` (:92-112)
which merges CLI flags with the run's persisted ``cfg_args``.

Deliberate fix (documented in SURVEY §7.1): the reference persists cfg_args as
``repr(Namespace(...))`` and re-reads it with ``eval`` — an arbitrary-code
execution hazard. We write BOTH a structured ``cfg_args.json`` (authoritative)
and the legacy ``cfg_args`` text (for ecosystem compatibility), and re-read
the legacy format with a safe literal parser, never ``eval``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
from argparse import ArgumentParser, Namespace


@dataclasses.dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""      # shorthand -s
    model_path: str = ""       # shorthand -m
    images: str = "images"     # shorthand -i
    resolution: int = -1       # shorthand -r
    white_background: bool = False  # shorthand -w
    data_device: str = "cuda"  # the reference's default; accepted, unused
    eval: bool = False

    _shorthands = {"source_path": "s", "model_path": "m", "images": "i",
                   "resolution": "r", "white_background": "w"}


@dataclasses.dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    # the rasterizer's settings (``ops/rasterize.RasterizeSettings``):
    backend: str = "seq"           # "seq" | "pallas" | "xla" blend path
                                   # ("seq" = 32x32 tiles through K1/K2, the
                                   # default; other tile shapes take the
                                   # "pallas" route, K4/K5; "xla" is the
                                   # plain scan oracle)
    fast_sort: bool = False        # packed [tile|depth] single-int32 sort
                                   # key; nearly-coincident splats may swap
                                   # blend order. Off => reference-exact
                                   # ordering.
    capacity: int = 1 << 20        # instance buffer (monitored, re-bucketed)
    max_per_tile: int = 4096       # per-tile depth cap
    tight_culling: bool = True     # opacity-adaptive rects (image-exact;
                                   # only the n_contrib / demand monitors
                                   # shrink)
    expand: str = "auto"           # instance expansion: "scatter" | "dense" |
                                   # "auto" (= scatter)
    dense_cap: int = 16            # per-gaussian slot cap in dense mode
    precise_cull: bool = True      # exact per-instance coverage cull
    _shorthands: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    _shorthands: dict = dataclasses.field(default_factory=dict)


def add_group(parser: ArgumentParser, cls, fill_none: bool = False):
    """Register a dataclass's fields as flags (ParamGroup equivalent).

    ``fill_none`` mirrors the reference's ``sentinel`` mode used by render-
    time scripts: defaults become None so cfg_args values win the merge.
    """
    shorthands = getattr(cls, "_shorthands", {}) or {}
    if isinstance(shorthands, dataclasses.Field):
        shorthands = {}
    for f in dataclasses.fields(cls):
        if f.name.startswith("_"):
            continue
        default = None if fill_none else f.default
        names = [f"--{f.name}"]
        if f.name in shorthands:
            names.append(f"-{shorthands[f.name]}")
        if f.type in ("bool", bool):
            if f.default is True:
                # store_true can never switch a default-True flag off; give
                # such flags (rasterizer settings only: every reference flag
                # defaults False) a --no-* companion.
                import argparse
                parser.add_argument(*names,
                                    action=argparse.BooleanOptionalAction,
                                    default=default)
            else:
                parser.add_argument(*names, action="store_true",
                                    default=default)
        else:
            typ = {"int": int, "float": float, "str": str}.get(f.type, None)
            if typ is None:
                typ = f.type if callable(f.type) else str
            parser.add_argument(*names, type=typ, default=default)
    return cls


def extract(cls, args: Namespace):
    """Build a dataclass instance from parsed args (ParamGroup.extract)."""
    vals = {}
    for f in dataclasses.fields(cls):
        if f.name.startswith("_"):
            continue
        v = getattr(args, f.name, None)
        vals[f.name] = f.default if v is None else v
    obj = cls(**vals)
    if hasattr(obj, "source_path") and obj.source_path:
        obj.source_path = os.path.abspath(obj.source_path)
    return obj


def save_cfg_args(model_path: str, model_params: ModelParams):
    """Persist run configuration: structured json + legacy Namespace text."""
    os.makedirs(model_path, exist_ok=True)
    d = {f.name: getattr(model_params, f.name)
         for f in dataclasses.fields(model_params)
         if not f.name.startswith("_")}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(d, f, indent=2)
    legacy = "Namespace(" + ", ".join(
        f"{k}={v!r}" for k, v in sorted(d.items())) + ")"
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(legacy)


_TOKEN = re.compile(
    r"(\w+)\s*=\s*('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|True|False|None"
    r"|-?\d+\.?\d*(?:e-?\d+)?)")


def parse_legacy_cfg_args(text: str) -> dict:
    """Safe parser for ``Namespace(k=v, ...)`` strings (no eval)."""
    out = {}
    for key, raw in _TOKEN.findall(text):
        if raw in ("True", "False"):
            out[key] = raw == "True"
        elif raw == "None":
            out[key] = None
        elif raw[0] in "'\"":
            out[key] = raw[1:-1]
        else:
            out[key] = float(raw) if ("." in raw or "e" in raw) else int(raw)
    return out


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """CLI + persisted cfg merge (reference get_combined_args, :92-112)."""
    args_cmdline = parser.parse_args(argv if argv is not None else sys.argv[1:])
    merged = {}
    model_path = getattr(args_cmdline, "model_path", None)
    if model_path:
        jpath = os.path.join(model_path, "cfg_args.json")
        lpath = os.path.join(model_path, "cfg_args")
        if os.path.exists(jpath):
            with open(jpath) as f:
                merged.update(json.load(f))
            print(f"Config file found: {jpath}")
        elif os.path.exists(lpath):
            with open(lpath) as f:
                merged.update(parse_legacy_cfg_args(f.read()))
            print(f"Config file found: {lpath}")
        else:
            print("Config file not found at", lpath)
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
