"""The port's CUDA kernels on the card, against their plain versions.

This file imports no JAX, so on a GPU host without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The ``cuda`` tests skip where no CUDA device is present (a CUDA kernel has
no CPU mode); the rest check the build recipe on any host.
"""

import os

import pytest
import torch

from neuralgaussiansplatting_torch import demo
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import _build
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend_pallas
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast

torch.set_num_threads(2)

SETTINGS = rast.make_settings("seq", capacity=1 << 18, max_per_tile=4096,
                              fast_sort=True, tight_culling=True,
                              precise_cull=True)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on an NVIDIA GPU")


def test_build_targets_hopper_and_keys_on_source():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" in _build.NVCC_FLAGS
    src, lib = _build._target("blend_seq_fwd")
    assert os.path.exists(src)
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert lib == _build._target("blend_seq_fwd")[1]


@pytest.mark.cuda
def test_k1_matches_plain_version_on_gpu():
    """K1 vs its plain version on the same card and inputs. Built with
    --fmad=false, so only expf may round differently; the gate is the JAX
    seq kernel's (atol 5e-5, n_contrib equal on >= 99.9 %)."""
    _need_gpu()
    params, state, cam = demo.demo_scene(n=20_000, w=256, h=256,
                                         sh_degree=3)
    tiles_x, tiles_y = SETTINGS.tiles_for(cam.width, cam.height)
    pre = pp.preprocess_gaussians(
        params.xyz, gm.get_scaling(params), gm.get_rotation(params),
        gm.get_opacity(params, state.alive), gm.get_features(params), 3,
        cam, 32, 32, tight=True)
    inst = binning.bin_gaussians(pre, tiles_x, tiles_y, SETTINGS.capacity,
                                 SETTINGS.max_per_tile, 128, pack_keys=True,
                                 precise_cull=True, block_x=32, block_y=32,
                                 width=256, height=256)
    packed = blend_pallas.pack_gather(blend_pallas.pack_instance_attrs_t(
        pre.means2d, pre.conic, pre.opacity, pre.rgb), inst.gid)
    before = blend_seq.launches
    got = blend_seq.blend_seq_fwd(packed, inst.tile_start, inst.tile_count,
                                  tiles_x)
    torch.cuda.synchronize()
    assert blend_seq.launches == before + 1
    want = blend_seq.blend_tiles_seq_reference(
        packed, inst.tile_start, inst.tile_count, tiles_x)
    assert (got[:, :4] - want[:, :4]).abs().max().item() <= 5e-5
    assert (got[:, 4] == want[:, 4]).float().mean().item() >= 0.999
    off = blend_seq.blend_seq_fwd(packed, inst.tile_start, inst.tile_count,
                                  tiles_x, track_contrib=False)
    assert torch.equal(off[:, :4], got[:, :4]) and not off[:, 4].any()


@pytest.mark.cuda
def test_render_on_gpu_matches_cpu_render():
    """The whole forward path on the card (K1) vs the same path on the CPU
    (K1's plain version): same monitors, images within 1e-4."""
    _need_gpu()
    params, state, _ = demo.demo_scene(n=3000, w=96, h=80, sh_degree=3,
                                       device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = params._replace(
        features_rest=0.2 * torch.randn(params.features_rest.shape,
                                        generator=gen),
        opacity=1.5 * torch.randn(params.opacity.shape, generator=gen))
    outs = {}
    for dev in ("cpu", "cuda"):
        cam = demo.demo_camera(96, 80, 0.4, device=dev)
        before = blend_seq.launches
        outs[dev] = render(cam, gm.GaussianParams(*(a.to(dev) for a in params)),
                           state.alive.to(dev), 3,
                           torch.tensor([0.2, 0.1, 0.3], device=dev), SETTINGS)
        assert blend_seq.launches == before + (dev == "cuda")
    cpu, gpu = outs["cpu"], outs["cuda"]
    assert (gpu["render"].cpu() - cpu["render"]).abs().max().item() <= 1e-4
    for key in ("num_rendered", "max_per_tile", "aligned_demand", "dropped",
                "culled"):
        assert int(gpu[key]) == int(cpu[key]), key
