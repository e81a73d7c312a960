"""The port's run-length decode (K6's plain version), ``_expand_runs`` and
the decode tool vs the JAX package's, on the same numpy inputs.

The JAX ``decode_runs`` (``tools/exp_decode_proto.py``) runs its Pallas
kernel in interpret mode on the CPU, as that tool does there. Every output
is int32 and must agree bit for bit. The kernel itself is held against its
plain version on the card in ``tests/test_torch_cuda.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import binning as jbin
from neuralgaussiansplatting_torch.ops import binning as tbin
from neuralgaussiansplatting_torch.ops import decode_runs as k6
from neuralgaussiansplatting_torch.tools import exp_decode_proto as tdec

# the JAX tool sets a compilation-cache directory in the environment when
# imported; keep the test process's environment as it was
_saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
from tools import exp_decode_proto as jdec  # noqa: E402

if _saved is None:
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

torch.set_num_threads(2)

DOMAIN = 8192   # two of the JAX kernel's 4096-slot blocks
F = 6


def edge_case():
    """The tool's edge case as numpy int32: the first start above 0,
    repeated starts (one group on the block boundary), starts at and past
    the domain, fields over the whole int32 range."""
    starts, fields = tdec.edge_case(DOMAIN, F, device="cpu")
    return starts.numpy(), fields.numpy()


def tool_case(n=250, domain=DOMAIN, f=F):
    starts, fields = tdec.make_case(n, domain, f, device="cpu")
    return starts.numpy(), fields.numpy()


CASES = {"make_case": tool_case, "edge": edge_case,
         "zero_length_runs": lambda: tool_case(n=6000)}


def jax_diffs(fields):
    """The JAX tool's 128-lane diffs of ``fields``."""
    f = jnp.asarray(fields)
    d = jnp.concatenate([f[:1], f[1:] - f[:-1]], axis=0)
    return jnp.zeros((f.shape[0], 128), jnp.int32).at[:, :f.shape[1]].set(d)


@pytest.mark.parametrize("case", list(CASES))
def test_expand_runs_matches_jax(case):
    starts, fields = CASES[case]()
    want = np.asarray(jbin._expand_runs(jnp.asarray(fields),
                                        jnp.asarray(starts), DOMAIN))
    got = tbin._expand_runs(torch.from_numpy(fields),
                            torch.from_numpy(starts), DOMAIN).numpy()
    assert got.dtype == np.int32 and got.shape == (DOMAIN, F)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["make_case", "edge"])
def test_decode_runs_matches_jax_kernel(case):
    """K6's plain version (the wrapper on CPU tensors) vs the JAX Pallas
    kernel in interpret mode, and vs ``_expand_runs`` of the fields."""
    starts, fields = CASES[case]()
    want = np.asarray(jdec.decode_runs(jnp.asarray(starts),
                                       jax_diffs(fields), DOMAIN, F))[:, :F]
    diffs = k6.diffs_from_fields(torch.from_numpy(fields))
    before = k6.launches
    got = k6.decode_runs(torch.from_numpy(starts), diffs, DOMAIN, F)
    assert k6.launches == before    # a CPU tensor takes the plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tbin._expand_runs(torch.from_numpy(fields),
                                       torch.from_numpy(starts),
                                       DOMAIN).numpy())


def test_edge_case_reaches_every_corner():
    starts, fields = edge_case()
    assert starts[0] > 0 and (np.diff(starts) >= 0).all()
    assert (np.diff(starts) == 0).sum() >= 5 and (starts >= DOMAIN).sum() >= 4
    assert fields.max() == 2 ** 31 - 1 and fields.min() == -2 ** 31


def test_diffs_from_fields_wraps_as_int32():
    _, fields = edge_case()
    got = k6.diffs_from_fields(torch.from_numpy(fields)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_diffs(fields))[:, :F])
    # a wider diffs table: only the first f columns are read
    wide = torch.cat([torch.from_numpy(got),
                      torch.full((got.shape[0], 3), 7, dtype=torch.int32)], 1)
    starts = torch.from_numpy(edge_case()[0])
    np.testing.assert_array_equal(
        k6.decode_runs(starts, wide, DOMAIN, F).numpy(),
        k6.decode_runs(starts, wide[:, :F].contiguous(), DOMAIN, F).numpy())


@pytest.mark.parametrize("n, domain", [(250, 8192), (6000, 8192),
                                       (100, 40960)])
def test_make_case_matches_jax(n, domain):
    js, jf = jdec.make_case(n, domain, F)
    ts, tf = tdec.make_case(n, domain, F, device="cpu")
    assert ts.dtype == torch.int32 and tf.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("case", list(CASES))
def test_repeat_interleave_formulation_matches_expansion(case):
    starts, fields = (torch.from_numpy(a) for a in CASES[case]())
    rows, lengths = tdec.repeat_inputs(starts, fields, DOMAIN)
    got = torch.repeat_interleave(rows, lengths, dim=0, output_size=DOMAIN)
    assert torch.equal(got, tbin._expand_runs(fields, starts, DOMAIN))


def test_negative_start_adds_nothing():
    """A start below 0 is dropped, as in the kernel and the JAX version
    (whose first block begins at the first start >= 0)."""
    starts = torch.tensor([-3, 0, 10], dtype=torch.int32)
    diffs = torch.tensor([[5], [1], [2]], dtype=torch.int32)
    got = k6.decode_runs(starts, diffs, 4096, 1)
    assert got[:10, 0].eq(1).all() and got[10:, 0].eq(3).all()


@pytest.mark.parametrize("domain", [6000, 0, -4096, 4096.0, 2 ** 31])
def test_domain_not_a_multiple_of_4096_raises(domain):
    starts, fields = (torch.from_numpy(a) for a in tool_case())
    with pytest.raises(ValueError, match="multiple of 4096"):
        k6.decode_runs(starts, k6.diffs_from_fields(fields), domain, F)


def test_decode_runs_validates_inputs():
    starts, fields = (torch.from_numpy(a) for a in tool_case())
    diffs = k6.diffs_from_fields(fields)
    for bad in ((starts.long(), diffs, DOMAIN, F),
                (starts, diffs.float(), DOMAIN, F),
                (starts, diffs[:-1], DOMAIN, F),
                (starts, diffs, DOMAIN, F + 1),
                (starts, diffs, DOMAIN, 0),
                (starts, diffs.reshape(-1), DOMAIN, F)):
        with pytest.raises(ValueError):
            k6.decode_runs(*bad)


def test_replaces_names_the_tpu_kernel():
    path, line = k6.REPLACES.split(":")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, path)) as fh:
        source = fh.read().splitlines()[int(line) - 1]
    assert source.startswith("def _decode_kernel(")


def test_slots_per_block_fits_the_shared_budget():
    assert k6.slots_per_block(6) == k6.MAX_SLOTS == 2048
    for f in (1, 6, 7, 13, 64, 128):
        slots = k6.slots_per_block(f)
        assert 4096 % slots == 0 and slots >= 32
        assert f * (slots + 32) * 4 <= k6.SMEM_BUDGET
        assert slots == k6.MAX_SLOTS \
            or f * (2 * slots + 32) * 4 > k6.SMEM_BUDGET


def test_decode_tool_main_on_cpu(capsys):
    """The tool's 800p workload, as its ``main`` runs it, on the CPU (the
    wrapper takes the plain version there): correct, with three finite
    timings."""
    result = tdec.run_workload("800p", *tdec.WORKLOADS["800p"], device="cpu")
    assert result["correct"]
    for key in ("plain_ms", "k6_ms", "repeat_interleave_ms"):
        assert np.isfinite(result[key])
    assert "[800p] correct=True" in capsys.readouterr().out


def test_status_buffer_per_stream_and_sequence():
    """The wrapper's status buffers (``_state``): one per (device, stream),
    zeroed when made, each call the next sequence number; made anew when a
    call needs more words or the sequence numbers run out."""
    dev = torch.device("cpu")
    saved = dict(k6._states)
    k6._states.clear()
    try:
        buf, seq = k6._state(dev, 11, 10)
        assert buf.dtype == torch.int64 and buf.shape[0] >= 10
        assert not buf.any() and seq == 1
        again, seq = k6._state(dev, 11, 10)
        assert again is buf and seq == 2
        other, seq = k6._state(dev, 12, 10)
        assert other is not buf and seq == 1
        grown, seq = k6._state(dev, 11, 100)
        assert grown is not buf and grown.shape[0] >= 100 and seq == 1
        k6._states[(dev.index, 11)][1] = k6.SEQ_LIMIT - 1
        fresh, seq = k6._state(dev, 11, 10)
        assert fresh is not grown and not fresh.any() and seq == 1
        for _ in range(3):
            _, seq = k6._state(dev, 11, 10)
        assert seq == 4 < k6.SEQ_LIMIT
    finally:
        k6._states.clear()
        k6._states.update(saved)
