"""Set-up shared by the benchmark's tests (``python -m pytest
ngsbench/tests``).

``tests/tiny.py`` writes a small copy of the benchmark whose two cells,
"tiny.train" and "tiny.render", are cut from ``garden840``, and maps each
cell a metric lists to the tiny cell of the same kind. Only
``garden840``'s cells map to them: a metric that lists none of those
(the metrics of ``neural800.train``) has no tiny cell to be read in, and
lists none. The fixture below applies that rule to every layout the
tests write; it belongs in ``tiny.layout`` itself, where it can move."""

from __future__ import annotations

import json

import pytest

from ngsbench.tests import tiny


def garden_cells_only(layout):
    """``layout`` with each listed metric's cells taken from
    ``garden840``'s alone."""
    def write(root):
        layout(root)
        real = json.loads((tiny.REAL / "BENCHMARK.json").read_text())
        bench = json.loads((root / "BENCHMARK.json").read_text())
        for group in ("end_to_end", "per_layer"):
            for m, r in zip(bench[group], real[group]):
                if "workloads" in r:
                    m["workloads"] = [f"tiny.{w.split('.')[1]}"
                                      for w in r["workloads"]
                                      if w.startswith("garden840.")][:1]
        (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
        return root
    return write


@pytest.fixture(autouse=True)
def tiny_layout_of_the_garden_cells(monkeypatch):
    monkeypatch.setattr(tiny, "layout", garden_cells_only(tiny.layout))
