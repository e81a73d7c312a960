"""Run-length decode (K6) against the plain expansion and repeat_interleave.

Port of ``tools/exp_decode_proto.py``. Binning expands per-run int32
columns over the instance slots (``binning._expand_runs``); K6
(``ops/decode_runs.py``) computes the same table from the runs' starts and
row differences. For the tool's two workloads (f = 6 columns each):

- "800p": 100,000 runs over 655,360 slots (an 800x800 frame's instances);
- "garden": 5,000,000 runs over 8,388,608 slots (the garden regime's),
  many of them zero-length;

it checks K6, and ``torch.repeat_interleave`` of the rows by the run
lengths, against ``_expand_runs`` bit for bit, then times K6, the plain
expansion and ``repeat_interleave`` (lengths and rows made outside the
timed call) with ``chain``.

    python -m neuralgaussiansplatting_torch.tools.exp_decode_proto
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from neuralgaussiansplatting_torch import resolve_device
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import decode_runs as k6
from neuralgaussiansplatting_torch.tools.chain_bench import chain

WORKLOADS = {"800p": (100_000, 640 * 1024), "garden": (5_000_000, 1 << 23)}
F = 6
ITERS, REPS = 4, 2   # the JAX tool's chain settings


def make_case(n: int, domain: int, f: int, seed: int = 0, device="cuda"):
    """(starts (n,) int32, fields (n, f) int32) of ``n`` runs with Poisson
    lengths filling 95 % of ``domain``; the JAX tool's numpy draws, so the
    same arguments give the same arrays."""
    rng = np.random.default_rng(seed)
    lens = rng.poisson(max(domain // n - 1, 1) - 0.5, n).astype(np.int64)
    scale = (domain * 0.95) / max(lens.sum(), 1)
    lens = (lens * scale).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    fields = rng.integers(-2**30, 2**30, (n, f), dtype=np.int32)
    dev = resolve_device(device)
    return torch.from_numpy(starts).to(dev), torch.from_numpy(fields).to(dev)


def edge_case(domain: int = 8192, f: int = F, n: int = 200, seed: int = 5,
              device="cuda"):
    """(starts (n,) int32, fields (n, f) int32) that reach every corner of
    the contract: the first start above 0, repeated starts (zero-length
    runs, one group on a 4096-slot block boundary), starts at and past the
    domain, fields over the whole int32 range. ``domain`` >= 8192."""
    rng = np.random.default_rng(seed)
    fixed = [3, 100, 100, 100, 4095, 4096, 4096, 4096, domain - 1, domain,
             domain, domain + 1, domain + 4095, 2 ** 31 - 1]
    starts = np.sort(np.concatenate(
        [rng.integers(3, domain, n - len(fixed)), fixed])).astype(np.int32)
    fields = rng.integers(-2 ** 31, 2 ** 31, (n, f),
                          dtype=np.int64).astype(np.int32)
    fields[0, 0], fields[1, 0] = 2 ** 31 - 1, -2 ** 31
    dev = resolve_device(device)
    return torch.from_numpy(starts).to(dev), torch.from_numpy(fields).to(dev)


def repeat_inputs(starts: torch.Tensor, fields: torch.Tensor, domain: int):
    """(rows, lengths) with ``repeat_interleave(rows, lengths, dim=0)`` the
    (domain, f) table of ``_expand_runs``: a zero row for the slots before
    the first start, then each run's row for its length, starts clamped to
    the domain."""
    s = torch.clamp(starts.long(), 0, domain)
    bounds = torch.cat([s.new_zeros(1), s, s.new_full((1,), domain)])
    rows = torch.cat([fields.new_zeros((1, fields.shape[1])), fields])
    return rows, bounds[1:] - bounds[:-1]


def run_workload(name: str, n: int, domain: int, device="cuda") -> dict:
    """Check and time one workload; returns {"name", "correct", and the
    three ms per iteration when correct}."""
    f = F
    starts, fields = make_case(n, domain, f, device=device)
    diffs = k6.diffs_from_fields(fields)
    rows, lengths = repeat_inputs(starts, fields, domain)
    ref = binning._expand_runs(fields, starts, domain)
    got = k6.decode_runs(starts, diffs, domain, f)
    rep = torch.repeat_interleave(rows, lengths, dim=0, output_size=domain)
    ok = torch.equal(got, ref) and torch.equal(rep, ref)
    print(f"[{name}] correct={ok} (runs {n}, slots {domain}, f {f}; K6 and "
          "repeat_interleave vs the plain expansion)", flush=True)
    if not ok:
        bad = int(torch.argmax((got != ref).any(dim=1).int()))
        print(f"  first bad slot {bad}: K6 {got[bad].tolist()}, expansion "
              f"{ref[bad].tolist()}, repeat_interleave {rep[bad].tolist()}")
        return {"name": name, "correct": False}

    def timed(fn):
        def make_body():
            def body(acc, _eps):
                return acc + fn()[-1, 0].float() * 1e-30
            return body
        return chain(make_body, torch.zeros((), device=starts.device),
                     iters=ITERS, reps=REPS)

    t_plain = timed(lambda: binning._expand_runs(fields, starts, domain))
    t_k6 = timed(lambda: k6.decode_runs(starts, diffs, domain, f))
    t_rep = timed(lambda: torch.repeat_interleave(rows, lengths, dim=0,
                                                  output_size=domain))
    print(f"  plain expand {t_plain:8.3f} ms | K6 decode {t_k6:8.3f} ms | "
          f"repeat_interleave {t_rep:8.3f} ms (chained, per iteration)",
          flush=True)
    return {"name": name, "correct": True, "plain_ms": t_plain,
            "k6_ms": t_k6, "repeat_interleave_ms": t_rep}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    results = [run_workload(name, n, domain, device=args.device)
               for name, (n, domain) in WORKLOADS.items()]
    if not all(r["correct"] for r in results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
