"""The port's idiom probes (K7's plain versions) vs the JAX tool's Pallas
probes, and the port's ``chain`` timer.

The JAX probes of ``tools/exp_mosaic_probe.py`` run in interpret mode on the
CPU: ``main`` runs with ``pl.pallas_call`` set to ``interpret=True`` and its
``run`` replaced by a recorder that keeps each probe's function, which is
then called on the tool's arange input and on two seeded random inputs.
Every probe output must be equal: the sums are taken in one order on both
sides. The kernels themselves are held against their plain versions on the
card in ``tests/test_torch_cuda.py``.
"""

import functools
import os
import time

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuralgaussiansplatting_torch.tools import chain_bench
from neuralgaussiansplatting_torch.tools import exp_mosaic_probe as tprobe

# the JAX tool sets a compilation-cache directory in the environment when
# imported; keep the test process's environment as it was
_saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
from tools import exp_mosaic_probe as jprobe  # noqa: E402

if _saved is None:
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

torch.set_num_threads(2)

NAMES = list(tprobe.PROBES)


def inputs():
    """The tool's arange input, and two seeded inputs with |x| < 2^20, the
    second with a negative x[0, 0] (p1b's floor mod)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-2.0 ** 20, 2.0 ** 20, (16, 128)).astype(np.float32)
    b = rng.uniform(-2.0 ** 20, 2.0 ** 20, (16, 128)).astype(np.float32)
    b[0, 0] = -300.75
    return [np.arange(16 * 128, dtype=np.float32).reshape(16, 128), a, b]


@pytest.fixture(scope="module")
def jax_outputs():
    recorded = {}

    def recorder(name, fn, *args):
        recorded[name] = fn
        return True

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(jprobe, "run", recorder)
        jprobe.main()
        return {name: [np.asarray(jax.jit(fn)(x)) for x in inputs()]
                for name, fn in recorded.items()}


def test_probe_names_are_the_jax_tools(jax_outputs):
    assert list(jax_outputs) == NAMES and len(NAMES) == 10


@pytest.mark.parametrize("name", NAMES)
def test_plain_probe_matches_jax_probe(name, jax_outputs):
    for x, want in zip(inputs(), jax_outputs[name]):
        got = tprobe.PROBES[name][1](torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_replaces_names_the_tpu_probe_kernel(name):
    path, line = tprobe.REPLACES[name].split(":")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, path)) as fh:
        source = fh.read().splitlines()[int(line) - 1]
    assert source.strip().startswith("def k") and "o_ref" in source


def _sequential(values):
    acc = np.float32(0)
    for v in values:
        acc = np.float32(acc + v)
    return acc


NUMPY = {
    "p1_roll_11_bcast": lambda x: np.full((8, 128), x[0, 3]),
    "p1b_dynroll": lambda x: np.full((8, 128), x[0, int(x[0, 0]) % 128]),
    "p2_twostep": lambda x: np.full((8, 128), _sequential(x[0, :4])),
    "p6_transpose": lambda x: x.T,
    **{f"p3_smem_{kb}kb": lambda x: np.full((8, 128), x[0, 5])
       for kb in (2, 4, 8, 16)},
    "p4_smem_loop": lambda x: np.full((8, 128), _sequential(x[0])),
    "p5_smem_2d": lambda x: np.full(
        (8, 128), _sequential(np.float32(x[0] * x[1]))),
}


@pytest.mark.parametrize("name", NAMES)
def test_plain_probe_matches_numpy_formula(name):
    for x in inputs():
        got = tprobe.PROBES[name][1](torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, NUMPY[name](x).astype(np.float32))


def test_probe_wrapper_on_cpu_runs_plain_version():
    x = torch.from_numpy(inputs()[1])
    before = tprobe.launches
    for name, (kernel, plain) in tprobe.PROBES.items():
        assert torch.equal(kernel(x), plain(x)), name
    assert tprobe.launches == before
    with pytest.raises(ValueError):
        tprobe.probe("p4_smem_loop", x.double())
    with pytest.raises(ValueError):
        tprobe.probe("p4_smem_loop", x[:8])
    # a contiguous view 4 bytes into an aligned buffer: a misaligned source
    # for the bulk copies
    flat = torch.zeros(16 * 128 + 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tprobe.probe("p3_smem_2kb", flat[1:].view(16, 128))


def test_probe_main_prints_ten_passes(capsys):
    tprobe.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [f"PASS {n}"
                                                     for n in NAMES]
    assert lines[0] == "PASS p1_roll_11_bcast: [3. 3. 3. 3.]"
    assert lines[-1] == "PASS p5_smem_2d: [1731264. 1731264. 1731264. 1731264.]"


@pytest.mark.parametrize("iters, reps", [(8, 3), (3, 1)])
def test_chain_times_the_body(iters, reps):
    """``chain`` on the CPU: each step takes the previous carry, the body
    runs (reps + 1) * (iters + 1) times, and a 2 ms step reads as about
    2 ms per iteration."""
    calls = []

    def make_body():
        def body(carry, eps):
            calls.append(eps)
            time.sleep(0.002)
            return {"x": carry["x"] + 1, "m": carry["m"]}
        return body

    carry = {"x": torch.zeros(3), "m": torch.nn.Linear(2, 2)}
    ms = chain_bench.chain(make_body, carry, iters=iters, reps=reps)
    assert len(calls) == (reps + 1) * (iters + 1)
    assert np.isfinite(ms) and 1.0 < ms < 50.0
    assert calls[1] == pytest.approx(1e-30) and calls[0] == 0.0


def test_chain_bench_knows_the_jax_configs():
    assert chain_bench.CONFIGS == (
        "classic_fb", "classic_fb_seq", "classic_fwd_seq",
        "classic_fwd1080_seq", "classic_fwd1080", "neural_fb",
        "neural_fb_bf16")
    with pytest.raises(ValueError, match="unknown config"):
        chain_bench.run("classic_fb_tpu", device="cpu")
