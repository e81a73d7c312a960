"""The control, the reference computed in bfloat16 in the program's place,
and the planted half-batch fault, at a small size on the CPU: each has to
come out not correct under the garden cells' limits, as it does on the
card at the cells' own sizes (``python -m ngsbench.control``)."""

import pytest
import torch

from ngsbench import control, harness
from ngsbench.tests import tiny


@pytest.mark.parametrize("kind", ["train", "render"])
def test_control_is_not_correct(tmp_path, kind):
    cell = harness.resolve(tiny.layout(tmp_path), f"tiny.{kind}")
    real = harness.resolve(harness.ROOT, f"garden840.{kind}")
    assert cell.limits == real.limits
    r = control.judged(cell, 424242424242, torch.device("cpu"))
    assert set(r) == ({"control", "half_batch"} if kind == "train"
                      else {"control"})
    for variant, (ok, checks) in r.items():
        assert not ok, (variant, checks)
