"""On the card (``python -m pytest ngsbench/tests -m cuda``): the tiny
cells through the whole harness, traced, on the program's CUDA kernels."""

import time

import pytest
import torch

from ngsbench import harness
from ngsbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "render"])
def test_tiny_cell_on_the_card(tmp_path, card, kind):
    root = tiny.layout(tmp_path)
    cell = harness.resolve(root, f"tiny.{kind}")
    r = harness.execute(cell, 987654321987, 0.5, True, card,
                        time.perf_counter(), lambda m: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {m["name"] for m, _ in cell.per_layer} == set(r["metrics"])
