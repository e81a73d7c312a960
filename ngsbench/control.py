"""The control and the planted faults that set each check's upper reading,
judged against the cell's own limits (``limits/<cell>.json``): the
reference put in the program's place, computed in bfloat16 (the step
below the configuration's float32), and for training the reference with
half of each image left out of the loss (the mean over the rest), each
held against the float32 reference as a run holds the program. The cell's
loop (``loops/<loop>.py``, its ``control``) computes them at the cell's
own size on the inputs a run hands the program.

    python -m ngsbench.control --workload <cell> --seed <n> [--seed ...]

Prints one JSON line per seed: {"workload", "seed", <variant>: {number:
{"value", "limit"}}, "correct": {variant: bool}}. Exits 1 if any variant
on any seed comes out correct (the limits then fail to tell it from the
program), 2 without a card. The benchmark's own runs never run this;
``tests/test_ngsbench_control.py`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ngsbench import check, harness


def judged(cell: harness.Cell, seed: int, device) -> dict:
    """{variant: (correct, {number: {"value", "limit"}})} of one seed."""
    r = cell.loop.control(cell.config, cell.mix, seed, device)
    return {variant: check.judge(numbers, cell.limits)
            for variant, numbers in r.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = harness.resolve(harness.ROOT, args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    passed = []
    for seed in args.seed:
        r = judged(cell, seed, device)
        line = {"workload": args.workload, "seed": seed}
        line |= {v: checks for v, (_, checks) in r.items()}
        line["correct"] = {v: ok for v, (ok, _) in r.items()}
        print(json.dumps(line), flush=True)
        passed += [(seed, v) for v, (ok, _) in r.items() if ok]
        torch.cuda.empty_cache()
    if passed:
        print(f"control or fault came out correct: {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
