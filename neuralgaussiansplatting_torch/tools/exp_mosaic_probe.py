"""Probes of the Hopper idioms the port's kernels are built from: kernel K7.

Port of ``tools/exp_mosaic_probe.py``, whose Pallas probes checked which
lowering idioms the TPU toolchain accepts for the blend kernels. Each probe
here is one ``__global__`` of ``csrc/mosaic_probe.cu`` computing the same
function of x (16, 128) float32 as its TPU probe, through the Hopper
counterpart of the idiom: warp-shuffle lane rotations (static and
data-dependent amounts), shared-memory transposes, and bulk copies
(``cp.async.bulk``) into dynamic shared memory completing on an
``mbarrier``. ``PROBES`` maps each of the JAX tool's ten launch names to
(kernel wrapper, plain PyTorch version); on a CUDA tensor the wrapper
launches the probe or raises, on a CPU tensor it runs the plain version.
``launches`` counts the probe launches.

``main`` runs every probe on arange(2048).reshape(16, 128), as the JAX tool
does, and prints ``PASS name: <first 4 values>`` when the probe built,
launched and equalled its plain version, else ``FAIL name: <why>``; it
exits non-zero if any probe failed.

    python -m neuralgaussiansplatting_torch.tools.exp_mosaic_probe
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import torch

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.ops import _build

SHAPE = (16, 128)

launches = 0      # K7 probe launches since the caller last set it to 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C signature of csrc/mosaic_probe.cu (the last pointer is the stream)
_ARGS = (_I, _I, _P, _P, _P)


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(()).expand(8, 128).clone()


def _floor_mod_lane(x: torch.Tensor) -> int:
    """int(x[0, 0]) (truncating) modulo 128, floored: the JAX probe's
    ``astype(int32) % 128``."""
    return int(x[0, 0].to(torch.int32)) % 128


def p1_roll_11_bcast_reference(x):
    return _bcast(torch.roll(x, 125, dims=1)[0, 0])


def p1b_dynroll_reference(x):
    return _bcast(torch.roll(x, 128 - _floor_mod_lane(x), dims=1)[0, 0])


def p2_twostep_reference(x):
    s = x.t().contiguous()                    # (128, 16)
    acc = x.new_zeros(())
    for i in range(4):
        acc = acc + s[i, 0]
    return _bcast(acc)


def p6_transpose_reference(x):
    return x.t().contiguous()


def p3_smem_reference(x, kb: int):
    buf = x.new_zeros(kb * 256)
    buf[:128] = x[0, :128]
    return _bcast(buf[5])


def p4_smem_loop_reference(x):
    acc = x.new_zeros(())
    for i in range(128):
        acc = acc + x[0, i]
    return _bcast(acc)


def p5_smem_2d_reference(x):
    smem = x[0:9].clone()
    acc = x.new_zeros(())
    for i in range(128):
        acc = acc + smem[0, i] * smem[1, i]
    return _bcast(acc)


# name -> (probe number in csrc/mosaic_probe.cu, parameter, output shape,
# plain version, the TPU probe it replaces as path:line from the repo root)
_SPECS = {
    "p1_roll_11_bcast": (0, 0, (8, 128), p1_roll_11_bcast_reference,
                         "tools/exp_mosaic_probe.py:44"),
    "p1b_dynroll": (1, 0, (8, 128), p1b_dynroll_reference,
                    "tools/exp_mosaic_probe.py:53"),
    "p2_twostep": (2, 0, (8, 128), p2_twostep_reference,
                   "tools/exp_mosaic_probe.py:62"),
    "p6_transpose": (3, 0, (128, 16), p6_transpose_reference,
                     "tools/exp_mosaic_probe.py:76"),
    **{f"p3_smem_{kb}kb": (4, kb, (8, 128),
                           functools.partial(p3_smem_reference, kb=kb),
                           "tools/exp_mosaic_probe.py:85")
       for kb in (2, 4, 8, 16)},
    "p4_smem_loop": (5, 0, (8, 128), p4_smem_loop_reference,
                     "tools/exp_mosaic_probe.py:101"),
    "p5_smem_2d": (6, 0, (8, 128), p5_smem_2d_reference,
                   "tools/exp_mosaic_probe.py:117"),
}
REPLACES = {name: spec[4] for name, spec in _SPECS.items()}


def probe(name: str, x: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` on x (16, 128) float32 at a 16-byte aligned address
    (the bulk-copy probes' source): its kernel on a CUDA tensor, its plain
    version on a CPU one."""
    global launches
    number, param, shape, plain, _ = _SPECS[name]
    if x.dtype != torch.float32 or tuple(x.shape) != SHAPE:
        raise ValueError(f"x must be {SHAPE} float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError(f"x must start at a 16-byte aligned address, got "
                         f"{x.data_ptr():#x}")
    if not _build.on_cuda("mosaic_probe", (x,)):
        return plain(x)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    _build.launch("mosaic_probe", _ARGS, x.device, number, param,
                  x.data_ptr(), out.data_ptr())
    launches += 1
    return out


PROBES = {name: (functools.partial(probe, name), spec[3])
          for name, spec in _SPECS.items()}


def run(name: str, x: torch.Tensor) -> bool:
    """Print PASS or FAIL for probe ``name`` on ``x``, as the JAX tool's
    ``run``; a probe passes when it launched and equalled its plain
    version."""
    kernel, plain = PROBES[name]
    try:
        out = kernel(x)
        want = plain(x)
        if not torch.equal(out, want):
            err = (out - want).abs().max().item()
            print(f"FAIL {name}: differs from its plain version (max |d| "
                  f"{err})", flush=True)
            return False
        print(f"PASS {name}: {out.cpu().numpy().ravel()[:4]}", flush=True)
        return True
    except Exception as e:  # a probe that does not build or launch FAILs
        msg = str(e).split("\n")[0][:180]
        print(f"FAIL {name}: {type(e).__name__}: {msg}", flush=True)
        return False


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    x = torch.arange(16 * 128, dtype=torch.float32,
                     device=resolve_device(args.device)).reshape(SHAPE)
    passed = [run(name, x) for name in PROBES]
    if not all(passed):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
