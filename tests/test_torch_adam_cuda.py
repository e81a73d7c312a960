"""The Adam kernel (``csrc/adam_update.cu``) on the card, against the plain
version (``Adam.update_reference``) on the card: bit for bit.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_adam_cuda.py

The groups cover the Gaussian leaves' row widths (1, 3, 4, 45, 64) at a
row count whose element counts are not multiples of 4, a leaf without a
gradient, a dead-slot mask whose dead rows hold NaN gradients, the
scheduled xyz rate, a view at an odd offset (the kernel's scalar path),
groups of fewer than 32 elements, and 41 groups in one call, which the
update splits into two launches.
"""

import numpy as np
import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.train import loop
from neuralgaussiansplatting_torch.train import optim

ROWS = 10_003  # 3 x ROWS, 45 x ROWS, ... are not multiples of 4
SHAPES = {"xyz": (ROWS, 3), "features_dc": (ROWS, 1, 3),
          "features_rest": (ROWS, 15, 3), "features": (ROWS, 64),
          "scaling": (ROWS, 3), "rotation": (ROWS, 4), "opacity": (ROWS, 1)}


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


def _randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _assert_bits(got, want):
    (pg, sg), (pw, sw) = got, want
    pg, pw = optim._leaves(pg), optim._leaves(pw)
    assert pg.keys() == pw.keys()
    for name in pg:
        assert torch.equal(pg[name], pw[name]), f"{name}: parameters"
    assert sg.keys() == sw.keys()
    for name in sg:
        assert sg[name].count == sw[name].count, name
        assert torch.equal(sg[name].mu, sw[name].mu), f"{name}: mu"
        assert torch.equal(sg[name].nu, sw[name].nu), f"{name}: nu"


@pytest.mark.cuda
def test_gaussian_groups_with_the_dead_slot_mask_are_the_plain_version():
    """The seven Gaussian groups (the classic step's optimizer), three
    steps: the dead rows' NaN gradients are selected away, ``features``
    has no gradient, xyz follows its schedule; one launch a step."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(11)
    tx = optim.make_optimizer(optim.OptimizationParams(), 2.5)
    params = {k: _randn(s, gen) for k, s in SHAPES.items()}
    alive = torch.rand(ROWS, generator=gen, device="cuda") > 0.2
    state = tx.init(params)
    rates = set()
    for _ in range(3):
        grads = {k: torch.where(alive.reshape((ROWS,) + (1,) * (len(s) - 1)),
                                _randn(s, gen, 1e-3), float("nan"))
                 for k, s in SHAPES.items()}
        grads["features"] = None
        optim.launches = 0
        got = tx.update(grads, state, params, alive=alive)
        assert optim.launches == 1
        want = tx.update_reference(grads, state, params, alive=alive)
        _assert_bits(got, want)
        for name, group in got[1].items():
            assert torch.isfinite(group.mu).all(), name
        rates.add(tx.lrs["xyz"](state["xyz"].count))
        params, state = got
    assert len(rates) == 3


@pytest.mark.cuda
def test_41_groups_in_one_call_take_two_launches_and_are_the_plain_version():
    """41 groups, as the neural step's decoders are many: sizes from 1 to
    ~600k elements (most not multiples of 4, several under 32), one view at
    an odd offset, one without a gradient; three steps, two launches
    each."""
    _need_gpu()
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(12)
    sizes = [1, 3, 7, 12, 31, 33, 64, 4097] + [
        int(x) for x in rng.integers(1, 600_000, 33)]
    names = [f"g{i:02d}" for i in range(len(sizes))]
    assert len(names) == 41 > optim.MAX_GROUPS
    tx = optim.Adam(lrs={k: 10.0 ** -rng.uniform(1, 4) for k in names})
    params = {k: _randn((n,), gen) for k, n in zip(names, sizes)}
    odd = torch.empty(sizes[-1] + 1, device="cuda")[1:]
    odd.copy_(params[names[-1]])
    params[names[-1]] = odd
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    state = tx.init(params)
    for _ in range(3):
        grads = {k: _randn(p.shape, gen, 1e-2) for k, p in params.items()}
        grads[names[5]] = None
        optim.launches = 0
        got = tx.update(grads, state, params)
        assert optim.launches == 2
        _assert_bits(got, tx.update_reference(grads, state, params))
        params, state = got


@pytest.mark.cuda
def test_train_step_launches_one_adam_kernel_and_matches_the_plain_step(
        monkeypatch):
    """One ``train_step`` on the card with the kernel, and with ``update``
    routed to the plain version: the same bits, one Adam launch."""
    _need_gpu()
    settings = rast.make_settings("seq", capacity=1 << 20, max_per_tile=4096,
                                  tight_culling=True)
    params, state, cam = demo.demo_scene(n=20_000, w=256, h=256,
                                         sh_degree=3)
    bg = torch.zeros(3, device="cuda")
    with torch.no_grad():
        gt = render(cam, params, state.alive, 3, bg, settings)["render"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = params._replace(opacity=params.opacity + _randn(
        params.opacity.shape, gen))
    tx = optim.make_optimizer(optim.OptimizationParams(), 1.0)
    kw = dict(tx=tx, sh_degree=3, settings=settings, lambda_dssim=0.2)
    ts = loop.TrainState(params, state, tx.init(params), 0)
    optim.launches = 0
    got, _ = loop.train_step(loop.TrainState(*ts), cam, gt, bg, **kw)
    assert optim.launches == 1
    monkeypatch.setattr(optim.Adam, "update", optim.Adam.update_reference)
    want, _ = loop.train_step(loop.TrainState(*ts), cam, gt, bg, **kw)
    assert optim.launches == 1
    _assert_bits((got.params, got.opt_state), (want.params, want.opt_state))
