"""The harness finds a cell's configuration, mix, loop, limits and
per-layer readers by name: a new one is files and entries, with no file
edited, and a new loop runs through the harness as the two that are there
do; a cell whose part is missing fails with that part's name."""

import json
import time

import pytest
import torch

from ngsbench import harness
from ngsbench.tests import tiny

# a loop that a later change could add as one file: it sums a seeded
# vector, and the reference sums it again in float64
SUM_LOOP = '''
import time

import torch

from ngsbench import program

KIND = "sum"
KERNELS = {}


class Loop:
    def __init__(self, mix, seed):
        g = torch.Generator().manual_seed(seed % (1 << 63))
        self.x = torch.rand(mix["size"], generator=g)
        self.sums = []
        self.facts = {"size": mix["size"]}

    def window(self, seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.sums.append(float(self.x.sum()))
        return program.Window(len(self.sums), time.perf_counter() - t0,
                              [], 0)

    def outcome(self, win):
        return win.ops, 0

    def end_to_end(self, win):
        return {"sums_per_s": win.ops / win.seconds}

    def steps(self, count, mark):
        for _ in range(count):
            with mark("ngsbench.sum"):
                self.sums.append(float(self.x.sum()))
        return list(range(count))

    def launches(self):
        return {}

    def release(self):
        pass

    def reference(self, steady, views):
        want = float(self.x.double().sum())
        return {"sum_gap": max(abs(s - want) for s in self.sums) / want}, []


def setup(cfg, mix, seed, device, log, traced):
    return Loop(mix, seed)


def control(cfg, mix, seed, device):
    return {"control": {"sum_gap": 1.0}}
'''


def add_loop(root):
    """Add the loop, a mix that names it, a metric and a cell as files and
    entries of the layout at ``root``."""
    pkg = root / "ngsbench"
    (pkg / "loops/sum.py").write_text(SUM_LOOP)
    (pkg / "traffic/sums.json").write_text(json.dumps(
        {"loop": "sum", "size": 4096, "trace_ops": 5}))
    (pkg / "metrics/sums_traced.py").write_text(
        "def read(t):\n    return float(t.ops) if t.kind == 'sum' else None\n")
    (pkg / "limits/tiny.sums.json").write_text(json.dumps(
        {"sum_gap": 1e-5}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.sums", "config": "tiny",
                               "traffic": "sums", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.sums"]})
    bench["per_layer"].append({"name": "sums_traced", "unit": "sums",
                               "better": "higher", "source": "device_trace",
                               "layer": "whole step", "moves": "sums_per_s",
                               "workloads": ["tiny.sums"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def add_cell(root, name="tiny.train_long", config="tiny2", mix="train_long",
             metric="steps_seen"):
    """Add a configuration, a mix, a metric and a cell as files and
    entries of the layout at ``root``."""
    pkg = root / "ngsbench"
    cfg = tiny.config()
    cfg["name"] = config
    (pkg / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    mix_doc = json.loads((pkg / "traffic/train.json").read_text())
    mix_doc["trace_ops"] = 20
    (pkg / "traffic" / f"{mix}.json").write_text(json.dumps(mix_doc))
    (pkg / "metrics" / f"{metric}.py").write_text(
        "def read(t):\n    return float(t.ops)\n")
    (pkg / "limits" / f"{name}.json").write_text(json.dumps(
        {"loss_gap": 1.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source": "x",
                             "file": f"ngsbench/configs/{config}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": mix, "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": f"{metric}.train", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "whole step",
                               "moves": "train_ms_per_iter",
                               "workloads": [name]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_ms_per_iter":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_cells_of_the_repository_resolve():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.resolve(harness.ROOT, w["name"])
        assert cell.loop.KIND == cell.mix["loop"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m, reader in cell.per_layer:
            assert callable(reader.read), m["name"]


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.layout(tmp_path)
    add_cell(root)
    cell = harness.resolve(root, "tiny.train_long")
    assert cell.config["name"] == "tiny2"
    assert cell.mix["trace_ops"] == 20
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "train_ms_per_iter"]
    readers = {m["name"]: r for m, r in cell.per_layer}
    assert list(readers) == ["steps_seen.train"]
    assert readers["steps_seen.train"].read(
        harness.TraceData("train", 7, 1.0, 0.5, 10, [], {})) == 7.0


@pytest.mark.parametrize("traced", [False, True])
def test_a_new_loop_runs_through_the_harness(tmp_path, traced):
    root = tiny.layout(tmp_path)
    add_loop(root)
    cell = harness.resolve(root, "tiny.sums")
    assert cell.loop.KIND == "sum"
    r = harness.execute(cell, 31415926535897, 0.05, traced,
                        torch.device("cpu"), time.perf_counter(),
                        lambda m: None)
    assert r["correct"] and r["attempted"] > 0, r
    assert r["checks"]["sum_gap"]["limit"] == 1e-5
    if traced:
        assert r["metrics"] == {"sums_traced": {"value": 5.0,
                                                "unit": "sums"}}
    else:
        assert set(r["metrics"]) == {"setup_s", "sums_per_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("missing, named", [
    ("config", "tiny2"), ("mix", "train_long"), ("metric", "steps_seen"),
    ("limits", "tiny.train_long"), ("loop", "train_loop")])
def test_a_missing_part_fails_with_its_name(tmp_path, missing, named):
    root = tiny.layout(tmp_path)
    add_cell(root)
    pkg = root / "ngsbench"
    if missing == "loop":
        mix = json.loads((pkg / "traffic/train_long.json").read_text())
        mix["loop"] = "train_loop"
        (pkg / "traffic/train_long.json").write_text(json.dumps(mix))
        with pytest.raises(harness.CellError, match=named):
            harness.resolve(root, "tiny.train_long")
        return
    path = {"config": pkg / "configs/tiny2.json",
            "mix": pkg / "traffic/train_long.json",
            "metric": pkg / "metrics/steps_seen.py",
            "limits": pkg / "limits/tiny.train_long.json"}[missing]
    path.unlink()
    with pytest.raises(harness.CellError, match=named):
        harness.resolve(root, "tiny.train_long")


def test_an_unknown_cell_or_configuration_fails_with_its_name(tmp_path):
    root = tiny.layout(tmp_path)
    with pytest.raises(harness.CellError, match="no_such.cell"):
        harness.resolve(root, "no_such.cell")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][0]["config"] = "gone"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(harness.CellError, match="gone"):
        harness.resolve(root, "tiny.train")
