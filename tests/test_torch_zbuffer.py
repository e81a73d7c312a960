"""The port's z-buffer (K3's plain version, the tiled idxmap and the
per-pixel sort oracle) vs the JAX package's, on the same numpy inputs.

K3's plain version runs here (CPU tensors); the JAX kernel runs in Pallas
interpret mode, as ``tests/test_zbuffer.py`` runs it. Winner ids must agree
exactly and depths to rtol 1e-7: both sides take a min over the same float32
depths. The kernel itself is held against its plain version on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralgaussiansplatting_tpu.ops import idxmap as jidx
from neuralgaussiansplatting_tpu.ops import zbuffer_pallas as jz
from neuralgaussiansplatting_torch.ops import idxmap as tidx
from neuralgaussiansplatting_torch.ops import zbuffer_pallas as tz

import k3_cases
from scenes import make_camera, random_gaussians
from torch_parity import port_camera, to_torch

torch.set_num_threads(2)

jax_tiled = jax.jit(jz.compute_idxmap_tiled, static_argnames=("capacity",))
jax_oracle = jax.jit(jidx.compute_idxmap, static_argnames=("capacity",))


def _both_tiled(means, cam, capacity, alive=None):
    j = jax_tiled(jnp.asarray(means), cam, capacity=capacity,
                  alive=None if alive is None else jnp.asarray(alive))
    t = tz.compute_idxmap_tiled(to_torch(means), port_camera(cam), capacity,
                                None if alive is None else to_torch(alive))
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("w,h", [(64, 64), (96, 48)])
def test_tiled_idxmap_matches_jax(w, h):
    means = random_gaussians(600, seed=5)[0]
    (jidx_, jdepth, jdemand), (tidx_, tdepth, tdemand) = _both_tiled(
        means, make_camera(w, h), 1 << 14)
    np.testing.assert_array_equal(tidx_, jidx_)
    np.testing.assert_allclose(tdepth, jdepth, rtol=1e-7)
    assert int(tdemand) == int(jdemand) <= 1 << 14
    assert tidx_.dtype == np.int32 and (tidx_ >= 0).mean() > 0.05


def test_tiled_idxmap_alive_mask_matches_jax():
    means = random_gaussians(300, seed=7)[0]
    alive = np.arange(300) % 3 != 0
    (jidx_, _, _), (tidx_, _, _) = _both_tiled(means, make_camera(64, 64),
                                               1 << 14, alive)
    np.testing.assert_array_equal(tidx_, jidx_)
    assert not (~alive)[tidx_[tidx_ >= 0]].any()


def test_starved_capacity_flags_itself_as_jax_does():
    """Capacity 256 truncates the instances and drops tiles: the demand
    exceeds the capacity, and the truncated result is JAX's too."""
    means = random_gaussians(500, seed=3)[0]
    (jidx_, _, jdemand), (tidx_, _, tdemand) = _both_tiled(
        means, make_camera(64, 64), 256)
    assert int(tdemand) == int(jdemand) > 256
    np.testing.assert_array_equal(tidx_, jidx_)


@pytest.mark.parametrize("capacity", [1 << 16, 2048])
def test_oracle_matches_jax(capacity):
    """The per-pixel sort oracle, at a roomy capacity and at one that
    truncates the expansion (the highest ids' instances drop)."""
    means = random_gaussians(600, seed=5)[0]
    cam = make_camera(64, 64)
    jidx_, jdepth, jnum = jax_oracle(jnp.asarray(means), cam,
                                     capacity=capacity)
    tidx_, tdepth, tnum = tidx.compute_idxmap(to_torch(means),
                                              port_camera(cam), capacity)
    np.testing.assert_array_equal(tidx_.numpy(), np.asarray(jidx_))
    np.testing.assert_allclose(tdepth.numpy(), np.asarray(jdepth), rtol=1e-7)
    assert int(tnum) == int(jnum)
    assert (int(tnum) > capacity) == (capacity == 2048)


def test_tiled_matches_oracle_on_the_port():
    means = random_gaussians(600, seed=9)[0]
    cam = port_camera(make_camera(96, 48))
    tiled = tz.compute_idxmap_tiled(to_torch(means), cam, 1 << 14)[0]
    oracle = tidx.compute_idxmap(to_torch(means), cam, 1 << 16)[0]
    assert torch.equal(tiled, oracle)


def _port_k3_inputs(w=160, h=48, n=600, seed=5, spread=0.5):
    """The rect table and bins that ``compute_idxmap_tiled`` hands K3 for a
    cloud of ``spread`` half-width, which leaves the edge tiles empty."""
    return tz.zbuf_inputs(to_torch(random_gaussians(
        n, seed=seed, spread=spread)[0]), port_camera(make_camera(w, h)),
        1 << 14)[0]


def test_k3_plain_version_matches_jax_kernel():
    """K3's plain version vs the Pallas kernel (interpret mode) on the same
    instances, ids and depths at every pixel of every tile, including the
    empty tiles, tiles of several 128-instance batches, the partial last
    batch of each tile and the crop of a 160x48 frame (tiles_y = 2 for 48
    rows)."""
    rects, depth, tile_start, tile_count, tiles_x = _port_k3_inputs()
    assert (tile_count == 0).any() and (tile_count > 256).any()
    assert (tile_count % 128 != 0).any()
    k = rects.shape[1]
    packed = np.zeros((jz.ROWS, k), np.float32)
    packed[:4] = rects[:4].numpy()
    packed[4] = depth.numpy()
    packed[5] = rects[4].numpy()
    raw = jz._zbuf_call(jnp.asarray(packed), jnp.asarray(tile_start.numpy()),
                        jnp.asarray(tile_count.numpy()),
                        num_tiles=tile_start.shape[0], ch=jz.CHUNK,
                        tiles_x=tiles_x, interpret=True)
    raw = np.asarray(raw).reshape(-1, 2, tz.PIX)
    gid, dmin = tz.zbuf_tiles_reference(rects, depth, tile_start, tile_count,
                                        tiles_x)
    np.testing.assert_array_equal(gid.numpy(), raw[:, 0].astype(np.int32))
    np.testing.assert_array_equal(dmin.numpy(), raw[:, 1])
    assert (gid >= 0).any() and (gid < 0).any()


def test_k3_plain_version_matches_jax_kernel_on_shuffled_tiles():
    """The instances of every tile in a random order: the Pallas kernel
    (interpret mode) and K3's plain version still agree at every pixel, and
    both give what they give in binning's order (ids equal, depths
    bit-equal): the contract is an argmin, whatever the order."""
    args = _port_k3_inputs()
    shuffled = k3_cases.shuffle_tiles(args)
    rects, depth, tile_start, tile_count, tiles_x = shuffled
    assert not torch.equal(rects, args[0])
    packed = np.zeros((jz.ROWS, rects.shape[1]), np.float32)
    packed[:4] = rects[:4].numpy()
    packed[4] = depth.numpy()
    packed[5] = rects[4].numpy()
    raw = jz._zbuf_call(jnp.asarray(packed), jnp.asarray(tile_start.numpy()),
                        jnp.asarray(tile_count.numpy()),
                        num_tiles=tile_start.shape[0], ch=jz.CHUNK,
                        tiles_x=tiles_x, interpret=True)
    raw = np.asarray(raw).reshape(-1, 2, tz.PIX)
    gid, dmin = tz.zbuf_tiles_reference(*shuffled)
    np.testing.assert_array_equal(gid.numpy(), raw[:, 0].astype(np.int32))
    np.testing.assert_array_equal(dmin.numpy(), raw[:, 1])
    want = tz.zbuf_tiles_reference(*args)
    assert torch.equal(gid, want[0])
    assert torch.equal(dmin.view(torch.int32), want[1].view(torch.int32))


def _edge_floats():
    """float32 values at every edge K3's keys must order: both zeros, both
    infinities, the denormal and normal limits, values around BIG and 1,
    and 2000 random bit patterns (NaNs dropped)."""
    f = np.float32
    tiny = np.finfo(f).tiny
    edges = [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, tiny, -tiny,
             np.nextafter(tiny, f(0)), -np.nextafter(tiny, f(0)), 1.0, -1.0,
             np.nextafter(f(1), f(2)), np.nextafter(f(1), f(0)), 0.2,
             tz.BIG, -tz.BIG, np.nextafter(f(tz.BIG), f(0)),
             np.nextafter(f(tz.BIG), f(np.inf)), np.finfo(f).max,
             -np.finfo(f).max]
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 2000,
                                             dtype=np.uint64)
    rand = bits.astype(np.uint32).view(f)
    values = np.concatenate([np.array(edges, f), rand[~np.isnan(rand)]])
    return torch.from_numpy(values)


def test_depth_key_orders_as_floats_compare():
    """K3's key encoding (the PyTorch twin of the kernel's ``depth_key``)
    against plain float comparison on every pair of edge values: a < b iff
    key(a) < key(b), a == b iff the keys are equal (so -0.0 and +0.0 share
    one), and ``key_depth`` gives each value's bits back, +0.0 for -0.0."""
    x = _edge_floats()
    key = tz.depth_key(x)
    assert key.dtype == torch.int64
    assert int(key.min()) >= 0 and int(key.max()) < 2 ** 32
    assert torch.equal(key[:, None] < key[None, :], x[:, None] < x[None, :])
    assert torch.equal(key[:, None] == key[None, :],
                       x[:, None] == x[None, :])
    back = tz.key_depth(key)
    zero = x == 0
    assert torch.equal(back[~zero].view(torch.int32),
                       x[~zero].view(torch.int32))
    assert (back[zero].view(torch.int32) == 0).all()
    # the miss key (all ones, above every depth key) and the zero key
    assert int(key.max()) < 2 ** 32 - 1
    assert int(tz.depth_key(torch.tensor([-0.0, 0.0])).unique()) == 2 ** 31 - 1


@pytest.mark.parametrize("case", list(k3_cases.CASES))
def test_k3_scatter_matches_plain_version(case):
    """The kernel's algorithm in PyTorch (``k3_cases.zbuf_tiles_scatter``:
    covered pairs, minimum key per pixel, the -0.0 walk) against K3's plain
    version, on the adversarial tile sets with each tile's instances
    shuffled; the plain version gives the same in both orders. Ids equal,
    depths bit-equal."""
    make = k3_cases.CASES[case]
    args, shuffled = make(), make(seed=7)
    want = tz.zbuf_tiles_reference(*args)
    for got in (tz.zbuf_tiles_reference(*shuffled),
                k3_cases.zbuf_tiles_scatter(*shuffled)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
    assert (want[0] >= 0).any()


def test_int32_ids_lift_the_2_pow_24_limit():
    """Two instances at equal depth on one pixel with ids 2^25 + 1 and
    2^25 + 2, past the JAX kernel's 2^24 limit; both round to the float32
    2^25. An id carried in a float32 lane cannot tell them apart and
    returns 2^25, neither id; the int32 ids keep the lower one."""
    lo, hi = (1 << 25) + 1, (1 << 25) + 2
    assert np.float32(lo) == np.float32(hi) == np.float32(1 << 25)
    rects = torch.tensor([[0, 0], [0, 0], [1, 1], [1, 1], [hi, lo]],
                         dtype=torch.int32)
    depth = torch.tensor([2.0, 2.0])
    i32 = torch.int32
    gid, dmin = tz.zbuf_tiles(rects, depth, torch.tensor([0], dtype=i32),
                              torch.tensor([2], dtype=i32), 1)
    assert gid[0, 0].item() == lo and dmin[0, 0].item() == 2.0
    assert (gid[0, 1:] == -1).all() and (dmin[0, 1:] == 0).all()
    # the JAX kernel's f32 lane, on the same two instances
    packed = np.zeros((jz.ROWS, 128), np.float32)
    packed[2:4, :2] = 1.0
    packed[4, :2] = 2.0
    packed[5, :2] = [hi, lo]
    raw = np.asarray(jz._zbuf_call(
        jnp.asarray(packed), jnp.zeros(1, jnp.int32),
        jnp.full(1, 2, jnp.int32), num_tiles=1, ch=jz.CHUNK, tiles_x=1,
        interpret=True))
    assert int(raw[0, 0, 0, 0]) == 1 << 25


def test_zbuf_tiles_checks_its_inputs_and_counts_no_cpu_launch():
    rects, depth, tile_start, tile_count, tiles_x = _port_k3_inputs(64, 64)
    before = tz.launches
    tz.zbuf_tiles(rects, depth, tile_start, tile_count, tiles_x)
    assert tz.launches == before        # CPU tensors: the plain version
    with pytest.raises(ValueError):
        tz.zbuf_tiles(rects.float(), depth, tile_start, tile_count, tiles_x)
    with pytest.raises(ValueError):
        tz.zbuf_tiles(rects, depth[:-1], tile_start, tile_count, tiles_x)
    with pytest.raises(ValueError):
        tz.zbuf_tiles(rects, depth, tile_start, tile_count, 3)
    with pytest.raises(ValueError):
        tz.zbuf_tiles(rects, depth.requires_grad_(), tile_start, tile_count,
                      tiles_x)
