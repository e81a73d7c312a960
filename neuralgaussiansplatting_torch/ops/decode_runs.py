"""Run-length decode: per-run difference rows -> per-slot rows: kernel K6.

Port of ``tools/exp_decode_proto.py``'s ``decode_runs``, the prototype that
computes binning's ``_expand_runs`` contract from the row differences:
given run starts and ``diffs[r] = fields[r] - fields[r-1]`` (int32
wraparound, ``diffs[0] = fields[0]``), slot s of the output holds the sum of
the diffs of every run that starts at or before s, which telescopes to the
fields of the run that owns s (zeros before the first start).

``decode_runs`` is K6's wrapper: on a CUDA tensor it launches the kernel
(``csrc/decode_runs.cu``) or raises, never falling back; on a CPU tensor it
runs the plain PyTorch version ``decode_runs_reference``. ``launches``
counts the K6 launches.
"""

from __future__ import annotations

import ctypes

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning

# the TPU kernel this replaces, as path:line from the repo root
REPLACES = "tools/exp_decode_proto.py:36"
DOMAIN_MULTIPLE = 4096  # the JAX kernel's output block: domains are multiples
MAX_F = 128             # columns decoded at most (the JAX kernel's lane width)
LANES = 32              # the kernel pads each (slots, f) column by a warp
SMEM_BUDGET = 100 * 1024  # bytes of a block's (slots + 32, f) shared buffer

launches = 0            # K6 launches since the caller last set it to 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C signature of csrc/decode_runs.cu (the last pointer is the stream)
_ARGS = (_P, _P, _LL, _LL, _LL, _I, _I, _P, _P, _P)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 modulo 2^32 (two's complement wraparound)."""
    return (((x.long() + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def diffs_from_fields(fields: torch.Tensor) -> torch.Tensor:
    """(R, F) int32 rows -> (R, F) int32 row differences, diffs[0] =
    fields[0] and diffs[r] = fields[r] - fields[r-1] modulo 2^32."""
    wide = fields.long()
    return wrap_int32(torch.cat([wide[:1], wide[1:] - wide[:-1]]))


def slots_per_block(f: int) -> int:
    """Output slots one block of the kernel decodes: the largest power of
    two up to 4096 whose padded (slots + 32, f) uint32 buffer fits
    ``SMEM_BUDGET`` (4096 for f <= 6)."""
    slots = DOMAIN_MULTIPLE
    while f * (slots + LANES) * 4 > SMEM_BUDGET:
        slots //= 2
    return slots


def _check_inputs(starts, diffs, domain, f):
    if starts.dtype != torch.int32 or starts.ndim != 1:
        raise ValueError(f"starts must be (N,) int32, got "
                         f"{tuple(starts.shape)} {starts.dtype}")
    if starts.shape[0] >= 2 ** 31:
        raise ValueError(f"{starts.shape[0]} runs: at most 2^31 - 1")
    if not 1 <= f <= MAX_F:
        raise ValueError(f"f must lie in [1, {MAX_F}], got {f}")
    if diffs.dtype != torch.int32 or diffs.ndim != 2 \
            or diffs.shape[0] != starts.shape[0] or diffs.shape[1] < f:
        raise ValueError(f"diffs must be ({starts.shape[0]}, >= {f}) int32, "
                         f"got {tuple(diffs.shape)} {diffs.dtype}")
    if diffs.device != starts.device:
        raise ValueError(f"diffs is on {diffs.device}, starts on "
                         f"{starts.device}")
    if not isinstance(domain, int) or domain <= 0 \
            or domain % DOMAIN_MULTIPLE or domain >= 2 ** 31:
        raise ValueError(f"domain must be a positive multiple of "
                         f"{DOMAIN_MULTIPLE} below 2^31, got {domain!r}")


def decode_runs(starts: torch.Tensor, diffs: torch.Tensor, domain: int,
                f: int) -> torch.Tensor:
    """Per-slot rows of runs given by their starts and row differences.

    ``starts`` (N,) int32 is non-decreasing and >= 0 (a start may repeat,
    and may lie at or past ``domain``, which drops its run); ``diffs`` (N,
    >= f) int32 holds each run's row difference in its first ``f`` columns.
    ``domain`` is a positive multiple of 4096 (the JAX version returns
    ``domain // 4096 * 4096`` rows for any other; this one raises). Returns
    (domain, f) int32 with out[s] = sum of diffs[r, :f] over the runs with
    starts[r] <= s, modulo 2^32: ``binning._expand_runs(fields, starts,
    domain)`` when ``diffs = diffs_from_fields(fields)``. The order of the
    starts is a precondition, not checked (that would cost a host sync).
    """
    global launches
    _check_inputs(starts, diffs, domain, f)
    if not _build.on_cuda("decode_runs", (starts, diffs)):
        return decode_runs_reference(starts, diffs, domain, f)
    slots = slots_per_block(f)
    nb = domain // slots
    out = torch.empty((domain, f), dtype=torch.int32, device=starts.device)
    # block windows (nb + 1), block sums and their exclusive prefix (nb, f)
    scratch = torch.empty(nb + 1 + 2 * nb * f, dtype=torch.int32,
                          device=starts.device)
    _build.launch("decode_runs", _ARGS, starts.device, starts.data_ptr(),
                  diffs.data_ptr(), starts.shape[0], diffs.shape[1], domain,
                  f, slots, out.data_ptr(), scratch.data_ptr())
    launches += 1
    return out


def decode_runs_reference(starts: torch.Tensor, diffs: torch.Tensor,
                          domain: int, f: int) -> torch.Tensor:
    """Plain PyTorch version of K6 (``decode_runs``), on any device: the
    fields as the int64 running sum of the diffs reduced modulo 2^32, then
    the owner lookup and row gather of ``binning._expand_runs``. A start
    below 0 adds nothing, as in the kernel and the JAX version, whose first
    block begins at the first start >= 0."""
    _check_inputs(starts, diffs, domain, f)
    d = torch.where((starts >= 0)[None, :], diffs[:, :f].t().long(), 0)
    # running sums along rows of the (f, N) transpose: a scan down dim 0 of
    # (N, f) runs one serial thread per column on a GPU
    fields = wrap_int32(torch.cumsum(d, 1)).t()
    return binning._expand_runs(fields, starts, domain)
