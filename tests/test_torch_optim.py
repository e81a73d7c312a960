"""PyTorch port vs the JAX package: losses, Adam and density control.

Same numpy inputs into both packages. Losses agree to 1e-6. The port's
per-group Adam is fed the very gradients optax is fed, for three steps, and
agrees to 1e-6 relative (host-side float32 scalars against XLA's; the
schedule's exp/log may round one ulp apart). Densification gets the split
noise JAX draws from its key (``jax.random.split`` then
``jax.random.normal``, as the JAX ``densify_and_prune`` does), so both sides
sample the same points; the RNGs themselves are not matched.

On the CPU ``Adam.update`` is its plain version, ``update_reference``, bit
for bit; its ``alive`` mask is the ``torch.where`` the training step used
to apply itself, and a ``None`` gradient reads as zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from neuralgaussiansplatting_tpu.models import gaussians as jgm
from neuralgaussiansplatting_tpu.ops import transforms as jtr
from neuralgaussiansplatting_tpu.train import densify as jdens
from neuralgaussiansplatting_tpu.train import optim as joptim
from neuralgaussiansplatting_tpu.utils import losses as jlosses
from neuralgaussiansplatting_torch.gaussian_renderer import render as trender
from neuralgaussiansplatting_torch.models import gaussians as tgm
from neuralgaussiansplatting_torch.ops import rasterize as trast
from neuralgaussiansplatting_torch.train import densify as tdens
from neuralgaussiansplatting_torch.train import loop as tloop
from neuralgaussiansplatting_torch.train import optim as toptim
from neuralgaussiansplatting_torch.utils import general as tgeneral
from neuralgaussiansplatting_torch.utils import losses as tlosses

from torch_parity import (jax_opt_groups, port_camera, port_model, to_torch,
                          train_step_inputs)

torch.set_num_threads(2)

CAP = 96


def _images(seed=0, shape=(3, 64, 48)):
    rng = np.random.default_rng(seed)
    pred = rng.random(shape, dtype=np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "mse", "psnr",
                                  "ssim", "photometric_loss"])
def test_losses_match_jax(name):
    pred, gt = _images()
    want = jax.jit(getattr(jlosses, name))(jnp.asarray(pred), jnp.asarray(gt))
    got = getattr(tlosses, name)(to_torch(pred), to_torch(gt))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6,
                               rtol=1e-6 if name == "psnr" else 0)


def test_photometric_loss_gradient_matches_jax():
    pred, gt = _images(seed=1, shape=(3, 40, 56))
    want = jax.jit(jax.grad(lambda p: jlosses.photometric_loss(
        p, jnp.asarray(gt), 0.2)))(jnp.asarray(pred))
    p = to_torch(pred).requires_grad_()
    tlosses.photometric_loss(p, to_torch(gt), 0.2).backward()
    want = np.asarray(want)
    np.testing.assert_allclose(p.grad.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_ssim_blur_backward_is_the_blur_of_the_cotangent():
    """The blur's hand-written backward vs autograd through its two
    convolutions; the cuDNN flags it sets are restored after both."""
    rng = np.random.default_rng(5)
    maps = to_torch(rng.random((5, 37, 29), dtype=np.float32))
    cot = to_torch(rng.normal(size=(5, 37, 29)).astype(np.float32))
    window = tlosses._gaussian_window_1d(11, 1.5, maps.device)
    cudnn = torch.backends.cudnn
    flags = cudnn.allow_tf32, cudnn.deterministic
    grads = []
    for blur in (tlosses._Blur.apply, tlosses._blur_passes):
        x = maps.clone().requires_grad_()
        (got,) = torch.autograd.grad(blur(x, window), x, cot)
        grads.append(got)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-6)
    assert (cudnn.allow_tf32, cudnn.deterministic) == flags


def test_ssim_of_an_image_with_itself_is_one():
    pred, _ = _images(seed=2)
    np.testing.assert_allclose(
        tlosses.ssim(to_torch(pred), to_torch(pred)).item(), 1.0, atol=1e-6)


def test_schedule_and_general_utils_match_jax():
    sched_j = joptim.expon_lr_schedule(1.6e-4, 1.6e-6, lr_delay_steps=100,
                                       lr_delay_mult=0.01, max_steps=30_000)
    sched_t = tgeneral.get_expon_lr_func(1.6e-4, 1.6e-6, lr_delay_steps=100,
                                         lr_delay_mult=0.01,
                                         max_steps=30_000)
    for step in (0, 1, 50, 99, 100, 1000, 29_999, 30_000, 40_000):
        np.testing.assert_allclose(sched_t(step), float(sched_j(step)),
                                   rtol=1e-6, err_msg=str(step))
    rng = np.random.default_rng(3)
    q = rng.normal(size=(10, 4)).astype(np.float32)
    s = rng.uniform(0.1, 2.0, (10, 3)).astype(np.float32)
    np.testing.assert_allclose(tgeneral.build_rotation(to_torch(q)).numpy(),
                               np.asarray(jtr.quat_to_rotmat(q)), atol=1e-6)
    np.testing.assert_allclose(
        tgeneral.build_scaling_rotation(to_torch(s), to_torch(q)).numpy(),
        np.asarray(jtr.build_scaling_rotation(s, q)), atol=1e-6)
    x = rng.uniform(0.01, 0.99, 20).astype(np.float32)
    np.testing.assert_allclose(tgeneral.inverse_sigmoid(to_torch(x)).numpy(),
                               np.asarray(jtr.inverse_sigmoid(x)), atol=1e-6)


def _models(n=60, capacity=CAP, seed=0):
    """The JAX demo cloud with random SH, scales and opacities, and the same
    tensors in the port (CPU)."""
    params, state, _ = __graft_entry__._demo_scene(n=n, w=32, h=32, seed=seed,
                                                   capacity=capacity,
                                                   sh_degree=2)
    rng = np.random.default_rng(seed + 10)
    params = params._replace(
        features_rest=jnp.asarray(rng.normal(
            0, 0.2, params.features_rest.shape).astype(np.float32)),
        scaling=jnp.asarray(rng.uniform(
            -9.0, -2.0, params.scaling.shape).astype(np.float32)),
        opacity=jnp.asarray(rng.normal(
            -2.0, 2.0, params.opacity.shape).astype(np.float32)))
    jp = jgm.GaussianParams(*map(np.asarray, params))
    js = jgm.GaussianState(*map(np.asarray, state))
    tp, ts = tgm.params_from_numpy(jp, js, device="cpu")
    return (params, state), (tp, ts)


def _random_grads(params, rng):
    return jgm.GaussianParams(*(rng.normal(size=np.shape(a)).astype(
        np.float32) for a in params))


def _assert_close(got, want, name):
    """1e-6 relative, or 1e-6 of the leaf's largest magnitude where the
    moment updates cancel (XLA may contract them into FMAs)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=name)


def _assert_state_close(t_state, j_state):
    for field, (mu, nu, count) in jax_opt_groups(j_state).items():
        got = t_state[field]
        assert got.count == count, field
        _assert_close(got.mu, mu, field)
        _assert_close(got.nu, nu, field)


def test_adam_matches_optax_over_three_steps():
    (jp, _), (tp, _) = _models()
    spatial = 2.5
    opt = joptim.OptimizationParams()
    jtx = joptim.make_optimizer(opt, spatial)
    ttx = toptim.make_optimizer(opt, spatial)
    j_state, t_state = jtx.init(jp), ttx.init(tp)
    update = jax.jit(jtx.update)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = _random_grads(jp, rng)
        updates, j_state = update(grads, j_state, jp)
        jp = optax.apply_updates(jp, updates)
        t_grads = tgm.GaussianParams(*map(to_torch, grads))
        # the step itself: the update applied to zeros
        steps, _ = ttx.update(t_grads, t_state,
                              tgm.GaussianParams(*map(torch.zeros_like, tp)))
        tp, t_state = ttx.update(t_grads, t_state, tp)
        for name, a, b in zip(jgm.GaussianParams._fields, updates, steps):
            _assert_close(b, a, name)
        for name, a, b in zip(jgm.GaussianParams._fields, jp, tp):
            _assert_close(b, a, name)
        _assert_state_close(t_state, j_state)
    # normals are frozen, features get no gradient in the classic path but
    # take their Adam step here like every other group
    np.testing.assert_array_equal(tp.normals.numpy(),
                                  np.asarray(jp.normals))

    # a state carried over from JAX continues in the port as in optax
    carried = tgm.opt_state_from_numpy(jax_opt_groups(j_state), device="cpu")
    grads = _random_grads(jp, rng)
    updates, j_state = update(grads, j_state, jp)
    jp = optax.apply_updates(jp, updates)
    tp, t_state = ttx.update(tgm.GaussianParams(*map(to_torch, grads)),
                             carried, tp)
    for name, a, b in zip(jgm.GaussianParams._fields, jp, tp):
        _assert_close(b, a, name)


def _stepped_states(jp, tp, rng):
    """Both optimizer states after one identical Adam step (non-zero
    moments for the density-control tests)."""
    jtx = joptim.make_optimizer(joptim.OptimizationParams(), 1.0)
    grads = _random_grads(jp, rng)
    _, j_state = jtx.update(grads, jtx.init(jp), jp)
    return j_state, tgm.opt_state_from_numpy(jax_opt_groups(j_state),
                                             device="cpu")


@pytest.mark.parametrize("use_size_prune", [False, True])
def test_densify_and_prune_matches_jax(use_size_prune):
    (jp, js), (tp, ts) = _models(n=60)
    rng = np.random.default_rng(7)
    accum = rng.uniform(0, 4e-4, CAP).astype(np.float32)
    denom = rng.integers(0, 3, CAP).astype(np.float32)
    js = js._replace(xyz_gradient_accum=jnp.asarray(accum),
                     denom=jnp.asarray(denom))
    ts = ts._replace(xyz_gradient_accum=to_torch(accum),
                     denom=to_torch(denom))
    j_opt, t_opt = _stepped_states(jp, tp, rng)
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)
    shape = jp.scaling.shape
    noise = (to_torch(jax.random.normal(k1, shape)),
             to_torch(jax.random.normal(k2, shape)))
    extent = 0.8
    args = (2e-4, 0.005, extent, use_size_prune, 0.01)
    want = jax.jit(jdens.densify_and_prune, static_argnums=(7,))(
        jp, js, j_opt, key, *args)
    got = tdens.densify_and_prune(tp, ts, t_opt, None, *args, noise=noise)

    j_params, j_state, j_opt2, j_report = want
    t_params, t_state, t_opt2, t_report = got
    for name, a, b in zip(jgm.GaussianParams._fields, j_params, t_params):
        _assert_close(b, a, name)
    for name, a, b in zip(jgm.GaussianState._fields, j_state, t_state):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for name, a, b in zip(j_report._fields, j_report, t_report):
        assert int(a) == int(b), name
    assert int(t_report.num_cloned) > 0 and int(t_report.num_split) > 0
    assert int(t_report.num_pruned) > 0
    _assert_state_close(t_opt2, j_opt2)


def test_densify_draws_from_the_generator_and_skips_past_capacity():
    """Without injected noise the split samples come from the generator
    (the same generator state gives the same result); with no free slot
    left, the surplus is skipped and the demand still reported."""
    (_, _), (tp, ts) = _models(n=CAP - 2, seed=4)
    ts = ts._replace(xyz_gradient_accum=torch.ones(CAP),
                     denom=torch.ones(CAP))
    opt = toptim.make_optimizer(toptim.OptimizationParams(), 1.0).init(tp)
    outs = [tdens.densify_and_prune(tp, ts, opt,
                                    torch.Generator().manual_seed(3), 0.5,
                                    0.0, 1.0, False, 0.01)
            for _ in range(2)]
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    report = outs[0][3]
    assert int(report.demand) == CAP - 2
    assert int(report.num_alive) == CAP
    assert int(report.num_cloned) + int(report.num_split) == 2


def test_reset_opacity_and_zero_moment_rows_match_jax():
    (jp, _), (tp, _) = _models(n=40, seed=2)
    j_opt, t_opt = _stepped_states(jp, tp, np.random.default_rng(9))
    j_params, j_opt2 = jax.jit(jdens.reset_opacity)(jp, j_opt)
    t_params, t_opt2 = tdens.reset_opacity(tp, t_opt)
    np.testing.assert_allclose(t_params.opacity.numpy(),
                               np.asarray(j_params.opacity), rtol=1e-6,
                               atol=1e-6)
    assert (torch.sigmoid(t_params.opacity) <= 0.01 + 1e-6).all()
    _assert_state_close(t_opt2, j_opt2)
    assert not t_opt2["opacity"].mu.any() and t_opt["opacity"].mu.any()

    written = np.zeros(CAP, bool)
    written[[1, 5, 50, 90]] = True
    j_fixed = jdens.zero_moment_rows(j_opt, jnp.asarray(written), CAP)
    t_fixed = tdens.zero_moment_rows(t_opt, torch.from_numpy(written))
    _assert_state_close(t_fixed, j_fixed)
    assert not t_fixed["xyz"].nu[torch.from_numpy(written)].any()


def test_densification_stats_match_jax():
    rng = np.random.default_rng(12)
    (_, js), (_, ts) = _models(n=50)
    radii = rng.integers(0, 4, CAP).astype(np.int32)
    g2d = rng.normal(size=(CAP, 2)).astype(np.float32)
    want = jdens.add_densification_stats(js, jnp.asarray(radii),
                                         jnp.asarray(g2d))
    want = jdens.add_densification_stats(want, jnp.asarray(radii[::-1]),
                                         jnp.asarray(g2d))
    got = tdens.add_densification_stats(ts, to_torch(radii), to_torch(g2d))
    got = tdens.add_densification_stats(got, to_torch(radii[::-1]),
                                        to_torch(g2d))
    for name, a, b in zip(jgm.GaussianState._fields, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   err_msg=name)


def _bits(x, y, name):
    """Equal bit for bit, NaN where NaN."""
    torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                               msg=name)


def _equal_updates(a, b):
    (pa, sa), (pb, sb) = a, b
    for name, x, y in zip(pa._fields, pa, pb):
        _bits(x, y, name)
    assert sa.keys() == sb.keys()
    for name in sa:
        assert sa[name].count == sb[name].count, name
        _bits(sa[name].mu, sb[name].mu, name)
        _bits(sa[name].nu, sb[name].nu, name)


def test_update_on_the_cpu_is_the_plain_version():
    (jp, _), (tp, _) = _models(seed=3)
    ttx = toptim.make_optimizer(toptim.OptimizationParams(), 2.5)
    rng = np.random.default_rng(21)
    state = ttx.init(tp)
    toptim.launches = 0
    for _ in range(3):
        grads = tgm.GaussianParams(*map(to_torch, _random_grads(jp, rng)))
        got = ttx.update(grads, state, tp)
        want = ttx.update_reference(grads, state, tp)
        _equal_updates(got, want)
        tp, state = got
    assert toptim.launches == 0


def test_update_alive_is_the_select_then_the_update():
    """``update(..., alive=m)`` is ``torch.where(m, g, 0)`` on every
    gradient, then the update: dead rows' NaN gradients never reach the
    moments. A ``None`` gradient is a gradient of zeros, mask or not."""
    (jp, _), (tp, ts) = _models(seed=4)
    ttx = toptim.make_optimizer(toptim.OptimizationParams(), 1.0)
    rng = np.random.default_rng(22)
    alive = ts.alive.clone()
    alive[[0, 7]] = False
    assert (~alive).sum() > 2
    state = ttx.init(tp)
    for _ in range(2):
        grads = tgm.GaussianParams(*map(to_torch, _random_grads(jp, rng)))
        grads = grads._replace(**{f: torch.where(
            alive.reshape((CAP,) + (1,) * (g.ndim - 1)), g, float("nan"))
            for f, g in zip(grads._fields, grads)})
        selected = grads._replace(**{f: torch.where(
            alive.reshape((CAP,) + (1,) * (g.ndim - 1)), g, 0.0)
            for f, g in zip(grads._fields, grads)})
        got = ttx.update(grads, state, tp, alive=alive)
        _equal_updates(got, ttx.update_reference(selected, state, tp))
        for name, group in got[1].items():
            assert torch.isfinite(group.mu).all(), name
        # no features gradient: zeros, with the mask or without
        no_feat = ttx.update(grads._replace(features=None), state, tp,
                             alive=alive)
        _equal_updates(no_feat, ttx.update_reference(
            selected._replace(features=torch.zeros_like(tp.features)),
            state, tp))
        tp, state = got


def _step_before_the_mask_moved(ts, cam, gt, bg, *, tx, settings):
    """``train_step``'s optimizer stage as it was before Adam took the
    dead-slot mask: zeros for a leaf without a gradient, ``torch.where``
    over every gradient, then the plain update."""
    params = ts.params
    n = params.xyz.shape[0]
    leaves = {f: getattr(params, f).detach().requires_grad_()
              for f in tloop.TRAINABLE}
    offset = params.xyz.new_zeros((n, 2), requires_grad=True)
    out = trender(cam, params._replace(**leaves), ts.gstate.alive, 3, bg,
                  settings, means2d_offset=offset)
    loss = tlosses.photometric_loss(out["render"], gt, 0.2)
    inputs = list(leaves.values()) + [offset]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    goff = grads.pop()
    alive = ts.gstate.alive
    grads = {f: torch.where(alive.reshape((n,) + (1,) * (g.ndim - 1)), g,
                            0.0) for f, g in zip(leaves, grads)}
    new_params, opt_state = tx.update_reference(params._replace(**grads),
                                                ts.opt_state, params)
    gstate = tdens.add_densification_stats(ts.gstate, out["radii"], goff)
    return tloop.TrainState(new_params, gstate, opt_state, ts.step + 1), loss


def test_train_step_on_the_cpu_is_unchanged_by_the_fused_select():
    """Two ``train_step``s (a NaN centre in a dead slot) against the stage
    as it was: parameters, moments, statistics and loss bit for bit."""
    settings = trast.make_settings(
        "seq", capacity=1 << 13, max_per_tile=1024, fast_sort=True,
        tight_culling=True, precise_cull=True)
    params, state, cam, gt, bg = train_step_inputs(300, 320, settings)
    tp, gs = port_model(params, state)
    tp = tp._replace(xyz=tp.xyz.clone())
    tp.xyz[319] = float("nan")
    ttx = toptim.make_optimizer(toptim.OptimizationParams(), 1.5)
    cam, gt, bg = port_camera(cam), to_torch(gt), to_torch(bg)
    new = old = tloop.TrainState(tp, gs, ttx.init(tp), 0)
    for _ in range(2):
        new, metrics = tloop.train_step(new, cam, gt, bg, tx=ttx,
                                        sh_degree=3, settings=settings,
                                        lambda_dssim=0.2)
        old, loss = _step_before_the_mask_moved(old, cam, gt, bg, tx=ttx,
                                                settings=settings)
        assert torch.equal(metrics["loss"], loss.detach())
        _equal_updates((new.params, new.opt_state),
                       (old.params, old.opt_state))
        for name, x, y in zip(new.gstate._fields, new.gstate, old.gstate):
            _bits(x, y, name)
