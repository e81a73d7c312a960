"""The port's stage timers (``tools.exp_{stage,bwd,neural,binning}_micro``)
against the JAX package's, on the CPU.

Each JAX tool's ``main`` runs in process on the seeded demo scene of 2000
Gaussians at 64x48 with its chained timer stubbed to 2 ms; the port's tool
runs on the same scene with ``NGS_PLATFORM=cpu`` and its timer stubbed the
same way (the stub runs each body once). The rows' ids and names are held
equal, every timed row prints the JAX tool's line to the character, and
the rows printed as ``no counterpart`` are exactly each tool's
``NO_COUNTERPART``. The binning timer's stages are held to
``bin_gaussians``, and its gradient sum to the JAX tool's reduce on its
seeded synthetic rows.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu import gaussian_renderer as jgr
from neuralgaussiansplatting_tpu.ops import binning as jbinning
from neuralgaussiansplatting_tpu.ops import blend_pallas as jbp
from neuralgaussiansplatting_tpu.ops import blend_seq as jblend_seq
from neuralgaussiansplatting_tpu.ops import preprocess as jpp
from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.tools import _micro
from neuralgaussiansplatting_torch.tools import exp_binning_micro as tbin
from neuralgaussiansplatting_torch.tools import exp_bwd_micro as tbwd
from neuralgaussiansplatting_torch.tools import exp_neural_micro as tneural
from neuralgaussiansplatting_torch.tools import exp_stage_micro as tstage

# the JAX tools set a compilation-cache directory in the environment when
# imported; keep the test process's environment as it was
_saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
import tools.chain_bench as jchain  # noqa: E402
from tools import exp_binning_micro as jbin  # noqa: E402
from tools import exp_bwd_micro as jbwd  # noqa: E402
from tools import exp_neural_micro as jneural  # noqa: E402
from tools import exp_stage_micro as jstage  # noqa: E402

if _saved is None:
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

torch.set_num_threads(2)

JAX_SCENE = __graft_entry__._demo_scene
N, W, H = 2000, 64, 48
ROW = re.compile(r"^  (?:\[(\d+)\] )?(.+?)\s+(?:[\d.]+ ms|no counterpart)")


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("NGS_PLATFORM", "cpu")


def jax_stubs(monkeypatch, *owners, n=N):
    """The JAX tools' scene at the small size and their timer at 2 ms."""
    def scene(**kw):
        return JAX_SCENE(**{**kw, "n": n, "w": W, "h": H})

    for owner in owners:
        monkeypatch.setattr(owner, "_demo_scene", scene, raising=False)
        monkeypatch.setattr(owner, "chain", lambda *a, **kw: 2.0,
                            raising=False)


def port_stubs(monkeypatch, tool):
    """The port tool's scene at the small size and its timer at 2 ms,
    each body run once."""
    def scene(**kw):
        return demo.demo_scene(**{**kw, "n": N, "w": W, "h": H})

    def chain(make_body, x0, iters=8, reps=3):
        make_body()(x0, 0.0)
        return 2.0

    monkeypatch.setattr(tool, "demo_scene", scene)
    monkeypatch.setattr(_micro, "chain", chain)
    if hasattr(tool, "chain"):
        monkeypatch.setattr(tool, "chain", chain)


def rows(text: str) -> list:
    """(line, id, name) of each row line printed."""
    out = []
    for line in text.splitlines():
        m = ROW.match(line)
        if m:
            out.append((line, m.group(1), m.group(2).rstrip(":")))
    return out


def check_rows(got_text, want_text, result, no_counterpart):
    got, want = rows(got_text), rows(want_text)
    assert [(i, n) for _, i, n in got] == [(i, n) for _, i, n in want]
    skipped = [n for line, _, n in got if "no counterpart: " in line]
    assert sorted(skipped) == sorted(no_counterpart)
    for (g, _, name), (w, _, _) in zip(got, want):
        if name not in no_counterpart:
            # a rate after the time is the scene's pixels over it
            assert g.split(" ms")[0] == w.split(" ms")[0]
    assert [r["name"] for r in result["rows"]] == [n for _, _, n in got]
    assert all((r["ms"] is None) == (r["name"] in no_counterpart)
               for r in result["rows"])
    assert result["timing"] == "chained eager, host clock"
    assert result["device"] == "cpu"


@pytest.mark.parametrize("seq", [False, True], ids=["pallas", "seq"])
def test_stage_micro_rows_match_jax(seq, monkeypatch, capsys, cpu_platform):
    jax_stubs(monkeypatch, jstage)
    monkeypatch.setattr("sys.argv", ["exp_stage_micro"]
                        + (["--seq"] if seq else []))
    jstage.main()
    want = capsys.readouterr().out
    port_stubs(monkeypatch, tstage)
    got = tstage.main(["--seq"] if seq else [])
    check_rows(capsys.readouterr().out, want, got, tstage.NO_COUNTERPART)
    assert len(got["rows"]) == 9


def test_stage_micro_settings_match_jax():
    """The tool's two settings are the JAX tool's (``grad_reduce`` aside,
    which the port has no counterpart of)."""
    import dataclasses
    from neuralgaussiansplatting_tpu.ops import rasterize as jrast
    want = {True: jrast.make_settings(
        "seq", capacity=640 * 1024, max_per_tile=4096, fast_sort=True,
        tight_culling=True, precise_cull=True, packed_capacity=512 * 1024),
        False: jrast.RasterizeSettings(
        capacity=1216 * 1024, max_per_tile=2048, chunk=128,
        backend="pallas", fast_sort=True, tight_culling=True,
        precise_cull=True, packed_capacity=1152 * 1024)}
    for seq, settings in want.items():
        fields = dataclasses.asdict(settings)
        fields.pop("grad_reduce")
        assert dataclasses.asdict(tstage.settings_for(seq)) == fields
    assert dataclasses.asdict(tbwd.SETTINGS) == {
        k: v for k, v in dataclasses.asdict(want[True]).items()
        if k != "grad_reduce"}


def test_bwd_micro_rows_match_jax(monkeypatch, capsys, cpu_platform):
    """Rows, and the header line (packed width, instances, aligned demand,
    drops) equal to the JAX tool's on the same binning."""
    jax_stubs(monkeypatch, jbwd)
    # the JAX tool calls its kernels outside interpret mode, which the CPU
    # does not lower; the rows never run here, so stand in zeros of the
    # kernels' output shapes
    monkeypatch.setattr(jblend_seq, "_fwd_call", lambda packed, ts, tc, **kw:
                        jnp.zeros((kw["num_tiles"], 5, 8, 128)))
    monkeypatch.setattr(jblend_seq, "_bwd_call", lambda packed, *a, **kw:
                        jnp.zeros_like(packed))
    # the tool preprocesses and bins eagerly: one compile each instead of
    # one per operation
    monkeypatch.setattr(jpp, "preprocess_gaussians", jax.jit(
        jpp.preprocess_gaussians,
        static_argnames=("sh_degree", "block_x", "block_y", "tight")))
    monkeypatch.setattr(jbinning, "bin_gaussians", jax.jit(
        jbinning.bin_gaussians, static_argnums=(1, 2, 3, 4, 5),
        static_argnames=("pack_keys", "packed_capacity", "precise_cull",
                         "block_x", "block_y", "width", "height")))
    monkeypatch.setattr("sys.argv", ["exp_bwd_micro"])
    jbwd.main()
    want = capsys.readouterr().out
    port_stubs(monkeypatch, tbwd)
    got = tbwd.main([])
    text = capsys.readouterr().out
    assert text.splitlines()[0] == want.splitlines()[0]
    check_rows(text, want, got, tbwd.NO_COUNTERPART)
    assert got["dropped"] == 0 and got["num_rendered"] > 0
    assert got["launches"] == {}


def test_neural_micro_rows_match_jax(monkeypatch, capsys, cpu_platform):
    jax_stubs(monkeypatch, jneural)
    # the stood-in timer never runs the decoders: skip the Flax init
    monkeypatch.setattr(jgr, "init_decoders", lambda key: {})
    monkeypatch.setattr("sys.argv", ["exp_neural_micro"])
    jneural.main()
    want = capsys.readouterr().out
    port_stubs(monkeypatch, tneural)
    got = tneural.main([])
    check_rows(capsys.readouterr().out, want, got, tneural.NO_COUNTERPART)
    assert len(got["rows"]) == 7


@pytest.mark.parametrize("variants", [False, True],
                         ids=["stages", "variants"])
def test_binning_micro_rows_match_jax(variants, monkeypatch, capsys,
                                      cpu_platform):
    # the JAX variants expand the tool's n = 100k Gaussians for real
    jax_stubs(monkeypatch, jbin, jchain, __graft_entry__,
              n=100_000 if variants else N)
    (jbin.expand_variants if variants else jbin.main)()
    want = capsys.readouterr().out
    port_stubs(monkeypatch, tbin)
    got = tbin.main(["variants"] if variants else [])
    text = capsys.readouterr().out
    names = [n for _, _, n in rows(text)]
    if variants:
        # the JAX tool's check line is not a timed row
        want_names = [n for _, _, n in rows(want)] + ["fdiv checksum match"]
        assert "fdiv checksum match: True" in want
        assert names == want_names
        assert "  fdiv checksum match: no counterpart: " in text
    else:
        check_rows(text, want, got, [n for n in tbin.NO_COUNTERPART
                                     if n.startswith("reduce")])
    assert [r["name"] for r in got["rows"]] == names
    assert sorted(r["name"] for r in got["rows"] if r["ms"] is None) == \
        sorted(n for n in tbin.NO_COUNTERPART if (n in names))


def test_binning_stages_are_bin_gaussians(cpu_platform):
    """The "full" stage is ``bin_gaussians``' run-length path with packed
    keys and no precise cull, field for field."""
    params, state, cam = demo.demo_scene(n=N, w=W, h=H, sh_degree=3,
                                         device="cpu")
    pre = tbin.preprocessed(params, state, cam)
    tiles = (W + 15) // 16, (H + 15) // 16
    got = tbin.binning_stages(pre, "full", *tiles)
    want = binning.bin_gaussians(
        pre, *tiles, tbin.CAPACITY, tbin.MAX_PER_TILE, tbin.ALIGN,
        pack_keys=True, packed_capacity=tbin.KCAP, precise_cull=False,
        block_x=16, block_y=16, width=W, height=H)
    for key in ("gid", "eid", "tile_start", "tile_count", "valid"):
        assert torch.equal(got[key], getattr(want, key)), key
    assert int(want.num_rendered) > 0 and int(want.dropped) == 0


def test_binning_reduce_matches_jax_on_the_synthetic_rows():
    """``reduce full`` computes the JAX tool's per-Gaussian sum on its
    seeded synthetic rows (the JAX side's cumulative-sum differences carry
    float32 rounding of the running prefix)."""
    n = 2000
    cot9, eid, gid = tbin.synthetic_rows(n, "cpu")
    got = blend.reduce_by_gaussian(cot9, gid, n)[:, :n]
    rng = np.random.default_rng(0)
    rng.normal(size=(9, tbin.KCAP))
    rng.permutation(tbin.KEPT)
    counts = rng.integers(0, 23, size=n).astype(np.int32)
    counts = (counts * (tbin.KEPT / counts.sum())).astype(np.int32)
    gstart = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    want = np.asarray(jbp._reduce_sorted(
        cot9.numpy(), eid.numpy(), gstart, counts))[:9, :n]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * scale)
