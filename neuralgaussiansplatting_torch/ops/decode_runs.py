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

The kernel runs in one launch, a single-pass scan whose blocks publish
their column sums and prefixes in a status buffer. The wrapper keeps one
such buffer per (device, stream), zeroed once when it is made or grown,
and a sequence number per buffer that tags each call's words; so a call
allocates only its output, and calls on two streams never share a buffer.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning

# the TPU kernel this replaces, as path:line from the repo root
REPLACES = "tools/exp_decode_proto.py:36"
DOMAIN_MULTIPLE = 4096  # the JAX kernel's output block: domains are multiples
MAX_SLOTS = 2048        # output slots of one kernel block at most
MAX_F = 128             # columns decoded at most (the JAX kernel's lane width)
LANES = 32              # the kernel pads each (slots, f) column by a warp
SMEM_BUDGET = 100 * 1024  # bytes of a block's (slots + 32, f) shared buffer

SEQ_LIMIT = 2 ** 31     # a status buffer's sequence numbers stay below it

launches = 0            # K6 launches since the caller last set it to 0

_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint
# the C signature of csrc/decode_runs.cu (the last pointer is the stream)
_ARGS = (_P, _P, _LL, _LL, _LL, _I, _I, _P, _P, _U, _P)
# (device index, raw stream) -> [status buffer (int64), last sequence
# number]; the buffer is one ticket word then nb * f status words
_states: dict = {}


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 modulo 2^32 (two's complement wraparound)."""
    return (((x.long() + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


def diffs_from_fields(fields: torch.Tensor) -> torch.Tensor:
    """(R, F) int32 rows -> (R, F) int32 row differences, diffs[0] =
    fields[0] and diffs[r] = fields[r] - fields[r-1] modulo 2^32."""
    wide = fields.long()
    return wrap_int32(torch.cat([wide[:1], wide[1:] - wide[:-1]]))


@functools.cache
def slots_per_block(f: int) -> int:
    """Output slots one block of the kernel decodes: the largest power of
    two up to ``MAX_SLOTS`` whose padded (slots + 32, f) uint32 buffer fits
    ``SMEM_BUDGET`` (2048 for f <= 12). 2048 beat 4096 and 1024 on an H100
    (csrc/decode_runs.cu): at f = 6 four blocks share an SM."""
    slots = MAX_SLOTS
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


def _state(device: torch.device, stream: int, words: int):
    """(status buffer of at least ``words`` int64, sequence number) for one
    call on ``stream``: the stream's buffer, made anew (zeroed, on that
    stream) when missing, too small or out of sequence numbers."""
    state = _states.get((device.index, stream))
    if state is None or state[0].shape[0] < words \
            or state[1] >= SEQ_LIMIT - 1:
        state = [torch.zeros(words, dtype=torch.int64, device=device), 0]
        _states[(device.index, stream)] = state
    state[1] += 1
    return state[0], state[1]


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
    device = starts.device
    if device.type == "cpu":
        return decode_runs_reference(starts, diffs, domain, f)
    # int32 tensors never require grad, so on_cuda's grad check is moot
    if device.type != "cuda":
        raise ValueError(f"no decode_runs kernel for device {device}")
    if not (starts.is_contiguous() and diffs.is_contiguous()):
        raise ValueError("decode_runs takes contiguous tensors")
    slots = slots_per_block(f)
    stream = _build.current_stream(device)
    state, seq = _state(device, stream, 1 + domain // slots * f)
    out = torch.empty((domain, f), dtype=torch.int32, device=device)
    _build.launch("decode_runs", _ARGS, device, starts.data_ptr(),
                  diffs.data_ptr(), starts.shape[0], diffs.shape[1], domain,
                  f, slots, out.data_ptr(), state.data_ptr(), seq,
                  stream=stream)
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
