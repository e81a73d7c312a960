"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on first
use into ``_build/lib<name>-<hash>.so``, keyed on the hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.
Several sources build in parallel, one nvcc each. Nothing here runs at
import time. Each library exports ``<name>(..., stream)``, which launches
and returns ``cudaGetLastError()``, and ``<name>_error(code)``, its message;
``launch`` calls the first and raises with the second. A library may export
further entries of that form, which share its ``_error``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: keep every a*b+c rounded as two operations, as the JAX
# kernels and the plain PyTorch versions round it (see csrc/*.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from csrc/ at first use")


def _target(name: str) -> tuple[str, str]:
    """(source path, library path) of kernel ``name``."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names) -> dict[str, str]:
    """Compile every kernel of ``names`` that is not built yet, all nvcc
    processes at once. Returns {name: compiler output} (ptxas reports each
    kernel's registers and shared memory) for the ones compiled."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in names:
            src, so = _target(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, so)
        logs = {}
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, so)
            logs[name] = out
        return logs
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load(name: str) -> ctypes.CDLL:
    """Load the library of kernel ``name``, building it first if needed."""
    build([name])
    return ctypes.CDLL(_target(name)[1])


@functools.cache
def _entry(name: str, argtypes: tuple, library: str | None = None):
    """(launch function, error-message function) of entry ``name`` of
    ``library`` (by default kernel ``name``'s own)."""
    library = library or name
    lib = load(library)
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = getattr(lib, library + "_error")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream, as an int
    (without the ``torch.cuda.Stream`` object that ``current_stream``
    builds)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(name: str, argtypes: tuple, device: torch.device, *args,
           stream: int | None = None, library: str | None = None):
    """Launch kernel ``name`` (an entry of ``library``, by default its own)
    on ``device``'s current stream (or on ``stream``, a raw stream of that
    device); ``argtypes`` are the ctypes of ``args`` and a last
    ``c_void_p``, the stream. Switches the current device only when
    ``device`` is not it: a launch goes to the current device, and a stream
    of another device is refused there. Raises RuntimeError if the launch is
    refused."""
    fn, err = _entry(name, argtypes, library)
    if stream is None:
        stream = current_stream(device)
    if device.index == torch.cuda.current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, stream)
    if code:
        raise RuntimeError(f"{name} launch failed: {err(code).decode()}")


def on_cuda(name: str, tensors, grad_entry: str | None = None) -> bool:
    """Whether kernel ``name`` launches for ``tensors`` (True on CUDA) or its
    plain version runs (False on the CPU). Refuses what a kernel cannot
    take: tensors that require grad (a launch would drop their gradient;
    ``grad_entry`` names the differentiable entry, if there is one), another
    device, non-contiguous memory."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
        raise ValueError(f"{name} takes no tensors that require grad"
                         + (f"; differentiate through {grad_entry}"
                            if grad_entry else ""))
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True
