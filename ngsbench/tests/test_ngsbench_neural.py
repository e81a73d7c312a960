"""The ``neural_train`` loop and what it adds, at a small size on the CPU
(``NGS_PLATFORM=cpu``: the port's K3 is its plain version): a cell of
``neural800.train``'s shape, cut to 32 x 32 and 1000 Gaussians at the
decoders' full widths, runs through the harness and is correct under
``neural800.train``'s own limits; the planted faults fail them (bfloat16
decoders, half of the rows left out of the loss, a state left unchanged)
and so do the control's variants; the configuration's widths decide the
decoders, and a program whose decoders have other shapes is refused; the
conv operations that ``neural_counts`` counts from the configuration's
widths equal ``FlopCounterMode``'s count of a forward and backward pass;
and the reference's two copies (``ngsbench/reference/neural.py``,
``tests/neural_reference.py``) give the same outputs."""

from __future__ import annotations

import copy
import importlib.util
import json
import time

import pytest
import torch

from ngsbench import control, harness, neural_counts
from ngsbench.reference import neural as ref
from ngsbench.tests import tiny

CELL = "tiny_neural.train"
REAL = "neural800.train"


def config() -> dict:
    cfg = json.loads((harness.ROOT / "ngsbench/configs/neural800.json")
                     .read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(name="tiny_neural", n_gaussians=1000, width=32, height=32)
    cfg["cameras"].update(views=8)
    return cfg


def layout(root, cfg=None):
    """``tiny.layout`` with a cell of ``neural800.train``'s shape, its
    limits the real cell's, its metrics those that list the real cell, its
    mix the real one with one warm-up step and two traced; ``cfg`` its
    configuration, ``config()`` by default."""
    tiny.layout(root)
    real = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pkg = root / "ngsbench"
    (pkg / "configs/tiny_neural.json").write_text(
        json.dumps(cfg or config()))
    (pkg / f"limits/{CELL}.json").write_text(
        (harness.ROOT / f"ngsbench/limits/{REAL}.json").read_text())
    mix = json.loads((pkg / "traffic/neural_train.json").read_text())
    mix.update(warmup_steps=1, trace_ops=2)
    (pkg / "traffic/tiny_neural_train.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_neural", "source": "x",
                             "file": "ngsbench/configs/tiny_neural.json",
                             "reduced": ["n_gaussians", "width", "height"],
                             "why": "a test's size"})
    bench["workloads"].append({"name": CELL, "config": "tiny_neural",
                               "traffic": "tiny_neural_train", "chips": 1,
                               "why": "a test's size"})
    listed = {m["name"] for m in real["end_to_end"] + real["per_layer"]
              if REAL in m.get("workloads", ())}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in listed:
            m["workloads"] = [w for w in m["workloads"]
                              if w.startswith("tiny.")] + [CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    torch.set_num_threads(2)
    return layout(tmp_path)


def run(root, traced=False, seed=2718281828459):
    c = harness.resolve(root, CELL)
    return harness.execute(c, seed, 0.2, traced, torch.device("cpu"),
                           time.perf_counter(), lambda m: None)


def test_the_cell_resolves_as_the_real_one():
    real = harness.resolve(harness.ROOT, REAL)
    assert real.loop.KIND == "neural_train" == real.mix["loop"]
    assert [m["name"] for m in real.end_to_end] == ["setup_s",
                                                    "train_ms_per_iter"]
    assert {m["name"] for m, _ in real.per_layer} == {
        "neural_step_mfu", "k3_roofline_pct.neural",
        "device_idle_pct.neural", "kernels_per_iter.neural"}
    assert set(real.limits) == {"grad_gap", "change_norm_gap",
                                "idxmap_mismatch"}


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(root, traced):
    r = run(root, traced)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 4     # 3 checked, 1 warm
    assert r["checks"]["idxmap_mismatch"]["value"] == 0.0
    if traced:
        # no device records on the CPU: K3's share has nothing to read
        assert set(r["metrics"]) == {"neural_step_mfu",
                                     "device_idle_pct.neural",
                                     "kernels_per_iter.neural"}
        assert r["metrics"]["neural_step_mfu"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"setup_s", "train_ms_per_iter"}


def _patch_step(monkeypatch, wrap):
    from neuralgaussiansplatting_torch.train import neural_loop
    real = neural_loop.neural_train_step
    monkeypatch.setattr(neural_loop, "neural_train_step",
                        lambda ts, *a, **kw: wrap(real, ts, *a, **kw))


def test_bfloat16_decoders_are_not_correct(root, monkeypatch):
    _patch_step(monkeypatch, lambda real, ts, *a, **kw: real(
        ts, *a, **(kw | {"dtype": torch.bfloat16})))
    r = run(root)
    assert not r["correct"], r["checks"]


def test_half_of_the_rows_left_out_is_not_correct(root, monkeypatch):
    from neuralgaussiansplatting_torch.train import neural_loop
    real = neural_loop.losses.photometric_loss

    def half(pred, gt, lam):
        rows = pred.shape[1] // 2
        return real(pred[:, :rows], gt[:, :rows], lam)

    monkeypatch.setattr(neural_loop.losses, "photometric_loss", half)
    r = run(root)
    assert not r["correct"], r["checks"]


def test_a_state_left_unchanged_is_not_correct(root, monkeypatch):
    from neuralgaussiansplatting_torch.train import neural_loop

    def unchanged(real, ts, *a, **kw):
        before = {k: v.detach().clone() for k, v in
                  neural_loop.decoder_leaves(ts.net_params).items()}
        new, metrics = real(ts, *a, **kw)
        for k, v in neural_loop.decoder_leaves(ts.net_params).items():
            with torch.no_grad():
                v.copy_(before[k])
        return ts, metrics

    _patch_step(monkeypatch, unchanged)
    r = run(root)
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_the_configuration_draws_the_decoders_the_steps_start_from(
        tmp_path, monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    from neuralgaussiansplatting_torch.train import neural_loop
    cell = harness.resolve(layout(tmp_path), CELL)
    started = {}
    real = neural_loop.neural_train_step

    def first(ts, *a, **kw):
        if not started:
            started.update({k: v.detach().clone() for k, v in
                            neural_loop.decoder_leaves(ts.net_params).items()})
        return real(ts, *a, **kw)

    monkeypatch.setattr(neural_loop, "neural_train_step", first)
    loop = cell.loop.setup(cell.config, cell.mix, 5, torch.device("cpu"),
                           lambda m: None, False)
    drawn = cell.loop.decoders(cell.config, 5, torch.device("cpu"))
    assert set(drawn) == set(ref.settings(cell.config)["shapes"])
    assert {k for k in started if k.startswith(("unet.", "cnn."))} == \
        set(drawn)
    for k, v in drawn.items():
        assert torch.equal(started[k], v), k
        assert torch.equal(loop.decoders[k], v), k
    assert all(float(v.abs().max()) > 0 for v in drawn.values())


def test_a_program_with_other_widths_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")
    cfg = config()
    cfg["unet_base_channels"] = 32
    cell = harness.resolve(layout(tmp_path, cfg), CELL)
    with pytest.raises(ValueError, match="unet.DoubleConv_0.Conv_0.weight"):
        cell.loop.setup(cell.config, cell.mix, 5, torch.device("cpu"),
                        lambda m: None, False)


def test_the_widths_and_numbers_come_from_the_configuration():
    cfg = config()
    s = ref.settings(cfg)
    assert (s["eps"], s["lr"], s["kernel"], s["levels"]) == (
        1e-15, 0.0025, 9, 3)
    assert s["shapes"]["cnn.Conv_1.weight"] == (81, 100, 5, 5)
    assert s["shapes"]["unet.ConvTranspose_0.weight"] == (256, 128, 2, 2)
    wide = cfg | {"unet_base_channels": 32, "unet_levels": 4,
                  "cnn_kernel": 3}
    shapes = ref.settings(wide)["shapes"]
    assert shapes["unet.DoubleConv_3.Conv_1.weight"] == (256, 256, 3, 3)
    assert shapes["unet.DoubleConv_6.Conv_0.weight"] == (32, 64, 3, 3)
    assert shapes["cnn.Conv_0.weight"] == (100, 64, 3, 3)
    with pytest.raises(ValueError):
        ref.settings(cfg | {"denoiser_kernel": 7})


def test_the_control_is_not_correct(root):
    cell = harness.resolve(root, CELL)
    r = control.judged(cell, 161803398874, torch.device("cpu"))
    assert set(r) == {"control", "zbuffer_bf16", "half_batch"}
    for variant, (ok, checks) in r.items():
        assert not ok, (variant, checks)
    assert r["zbuffer_bf16"][1]["idxmap_mismatch"]["value"] > \
        cell.limits["idxmap_mismatch"]


def test_conv_operations_match_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    loop = harness.loop_module(harness.ROOT, "neural_train")
    h, w = 16, 24
    for cfg in (config(), config() | {"unet_base_channels": 16,
                                      "unet_levels": 4, "cnn_kernel": 3}):
        dec = {k: v.requires_grad_() for k, v in
               loop.decoders(cfg, 1, "cpu").items()}
        x = torch.randn(1, 64, h, w, requires_grad=True)
        with FlopCounterMode(display=False) as fc:
            y = (ref.unet(x, dec, levels=cfg["unet_levels"]).sum()
                 + ref.cnn(x, dec).sum())
            y.backward()
        assert fc.get_total_flops() == neural_counts.step_ops(cfg, h, w)
    assert neural_counts.forward_ops(config(), 800, 800) == pytest.approx(
        1.0045e12, rel=1e-3)


def test_k3_bound_counts_bytes_of_the_reference_zbuffer():
    c = {"pairs": 10, "instances": 100, "tiles": 4, "pixels": 4096}
    least, by = neural_counts.k3_least_s(c)
    assert by == "bytes"
    assert least == pytest.approx((100 * 24 + 4 * 8 + 4 * 1024 * 8)
                                  / 3.35e12)


def test_the_two_reference_copies_give_the_same_outputs():
    spec = importlib.util.spec_from_file_location(
        "tests_neural_reference", harness.ROOT / "tests/neural_reference.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    from ngsbench import scene
    loop = harness.loop_module(harness.ROOT, "neural_train")
    cfg = config()
    cams = scene.cameras(cfg, "train")[:2]
    gts = scene.make_images(cfg, 5, 2, "cpu")
    xyz = scene.make_cloud(cfg, 5, "cpu")["xyz"]
    feats = loop.features(cfg, 5, "cpu")
    dec = loop.decoders(cfg, 5, "cpu")
    a = ref.steps(xyz, feats, dec, cams, gts, **ref.settings(cfg))
    b = other.steps(xyz, feats, dec, cams, gts, **other.settings(cfg))
    assert a["loss"] == b["loss"] and a["counts"] == b["counts"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for x, y in zip(a["idx"], b["idx"]):
        assert torch.equal(x, y)
