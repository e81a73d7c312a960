"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m ngsbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Needs a CUDA card (and as many as the cell asks for); without one it
exits with code 2 and prints no result. It never falls back to the CPU.
The last line of standard output is the JSON result; progress and, last,
each number the check compared beside its limit go to standard error.
The program's kernels build once into the port's own directory inside the
checkout (``neuralgaussiansplatting_torch/_build/``, keyed on the sources'
hash).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(msg: str):
    t = time.perf_counter() - T_START
    print(f"[ngsbench {t:7.2f} s] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ngsbench import harness

    # one process with one host thread of CPU operations: the host's other
    # cores stay free for its launches
    torch.set_num_threads(1)

    cell = harness.resolve(harness.ROOT, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"cell {args.workload!r} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} imported, "
        f"{torch.cuda.get_device_name(device)}")
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             device, T_START, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"loaded modules of JAX or the JAX package: {bad}")
        return 3
    for line in harness.card_lines(device):
        log(line)
    log(f"memory peak {result['device']['memory_peak_bytes']} bytes")
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
