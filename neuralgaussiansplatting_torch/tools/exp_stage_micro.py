"""Chained micro-timings of individual pipeline stages at the 800^2 bench
configuration (the demo cloud of 100k Gaussians, SH degree 3).

Port of ``tools/exp_stage_micro.py``: the same rows, ids, names and
settings. Each row is one stage chained alone, its outputs consumed by a
full-array sum:

  [0] preprocess only            ``preprocess_gaussians``
  [1] preprocess+binning         + ``bin_gaussians``
  [2] preprocess+binning+pack    + ``pack_instance_attrs_t`` and the gid
                                 gather
  [3] full fwd                   ``render``
  [4] fwd+bwd sort               render, L1+SSIM, backward; the port's
                                 per-Gaussian sum (``reduce_by_gaussian``)
                                 is its only reduction, the counterpart of
                                 the JAX "sort" reduce
  [5] fwd+bwd scatter            no counterpart (``NO_COUNTERPART``)
  [6] fwd+bwd sort L1-only       lambda_dssim 0
  [7] fwd+bwd sort SH0           SH degree 0
  [8] fwd+bwd sort precolor      gradients of precomputed colours only

Settings: by default ``backend="pallas"`` at the settings' default 32x32
tiles (K4 forward, K5 backward; capacity 1216Ki, packed 1152Ki, 2048 per
tile); ``--seq`` the seq path (K1, K2; capacity 640Ki, packed 512Ki, 4096
per tile); both with fast sort, tight and precise cull.

Timing: ``tools.chain_bench.chain``, 8 steps, best of 2. The JAX tool
chains inside one jit; here the steps run eagerly, so each figure is host
clock with the host's dispatch included (chained eager, host clock).

    python -m neuralgaussiansplatting_torch.tools.exp_stage_micro \\
        [--seq] [row ids]

``main(argv)`` returns the rows with "timing", "launches" and "device".
Runs on the CUDA device, or on the CPU when ``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

from argparse import ArgumentParser

import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.gaussian_renderer import render
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.tools import _harness, _micro
from neuralgaussiansplatting_torch.tools.chain_bench import descend
from neuralgaussiansplatting_torch.utils import losses

W = H = 800
N = 100_000
SEQ = rast.make_settings(
    "seq", capacity=640 * 1024, max_per_tile=4096, fast_sort=True,
    tight_culling=True, precise_cull=True, packed_capacity=512 * 1024)
PALLAS = rast.RasterizeSettings(
    capacity=1216 * 1024, max_per_tile=2048, chunk=128, backend="pallas",
    fast_sort=True, tight_culling=True, precise_cull=True,
    packed_capacity=1152 * 1024)
ITERS, REPS = 8, 2
NAME_WIDTH = 28
NO_COUNTERPART = {
    "fwd+bwd scatter": "the XLA scatter-add gradient reduction is a TPU "
                       "variant; the port reduces per Gaussian one way "
                       "(blend.reduce_by_gaussian)",
}


def settings_for(seq: bool) -> rast.RasterizeSettings:
    """The tool's settings: ``SEQ`` under ``--seq``, else ``PALLAS``."""
    return SEQ if seq else PALLAS


def rows_for(params, state, cam, settings) -> list:
    """The tool's rows, (name, make_body, carry), on the cloud
    ``(params, state)`` seen by ``cam``."""
    alive = state.alive
    dev = params.xyz.device
    bx, by = settings.block_x, settings.block_y
    w, h = cam.width, cam.height
    tiles_x, tiles_y = settings.tiles_for(w, h)
    bg = torch.zeros(3, device=dev)
    gt = torch.zeros((3, h, w), device=dev)

    def inputs(p, s):
        return (p.xyz + s, gm.get_scaling(p), gm.get_rotation(p),
                gm.get_opacity(p, alive), gm.get_features(p))

    def preprocessed(p, s):
        return pp.preprocess_gaussians(*inputs(p, s), 3, cam, bx, by,
                                       tight=True)

    def run_pre(p, s):
        return _micro.sums(*preprocessed(p, s))

    def make_prebin(with_pack):
        def run(p, s):
            pre = preprocessed(p, s)
            inst = binning.bin_gaussians(
                pre, tiles_x, tiles_y, settings.capacity,
                settings.max_per_tile, settings.chunk, pack_keys=True,
                packed_capacity=settings.packed_capacity,
                precise_cull=settings.precise_cull, block_x=bx, block_y=by,
                width=w, height=h)
            acc = _micro.sums(inst.gid, inst.tile_start, inst.tile_count,
                              inst.eid) + inst.num_rendered
            if with_pack:
                packed_all = blend.pack_instance_attrs_t(
                    pre.means2d, pre.conic, pre.opacity, pre.rgb)
                acc = acc + _micro.sums(packed_all[:, inst.gid.long()])
            return acc
        return run

    def run_fwd(p, s):
        out = render(cam, p._replace(xyz=p.xyz + s), alive, 3, bg, settings)
        return _micro.sums(out["render"], out["final_t"])

    def make_loss_row(stage):
        def make():
            def body(carry, s):
                p, acc = carry
                with torch.no_grad():
                    return p, acc + stage(p, s)
            return body
        return make

    def make_grad(sh_degree=3, lam=0.2):
        def make():
            def body(carry, s):
                p, acc = carry
                leaves = [a.detach().requires_grad_() for a in p]
                out = render(cam, gm.GaussianParams(*leaves), alive,
                             sh_degree, bg, settings)
                loss = losses.photometric_loss(out["render"], gt + s, lam)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                return descend(p, grads), acc
            return body
        return make

    def make_grad_precolor():
        """Backward with SH and the activations out of the graph: only a
        precomputed colour bundle is differentiated (the difference against
        [4] is the preprocess/SH backward)."""
        m3, sc, ro, op, shs = inputs(params, 0.0)

        def make():
            def body(carry, s):
                col, acc = carry
                col = col.detach().requires_grad_()
                out = rast.rasterize(m3, sc, ro, op, shs, 0, cam, bg,
                                     settings, colors_precomp=col)
                loss = losses.photometric_loss(out.color, gt + s, 0.2)
                (g,) = torch.autograd.grad(loss, [col])
                return (col - 1e-30 * g).detach(), acc
            return body
        return make

    z = torch.zeros((), device=dev)
    x0 = (params, z)
    return [
        ("preprocess only", make_loss_row(run_pre), x0),
        ("preprocess+binning", make_loss_row(make_prebin(False)), x0),
        ("preprocess+binning+pack", make_loss_row(make_prebin(True)), x0),
        ("full fwd", make_loss_row(run_fwd), x0),
        ("fwd+bwd sort", make_grad(), x0),
        ("fwd+bwd scatter", None, x0),
        ("fwd+bwd sort L1-only", make_grad(lam=0.0), x0),
        ("fwd+bwd sort SH0", make_grad(sh_degree=0), x0),
        ("fwd+bwd sort precolor", make_grad_precolor(),
         (torch.zeros((params.xyz.shape[0], 3), device=dev), z)),
    ]


def run(params, state, cam, seq: bool = False, selection=()) -> dict:
    """Chain and print the selected rows (every row when ``selection`` is
    empty); returns them with "timing", "launches" and "device"."""
    before = _harness.launch_counts()
    rows = rows_for(params, state, cam, settings_for(seq))
    done = _micro.run_rows(rows, NO_COUNTERPART, NAME_WIDTH, selection,
                           iters=ITERS, reps=REPS)
    return _micro.result(done, before, params.xyz.device)


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*")
    ap.add_argument("--seq", action="store_true")
    args = ap.parse_args(argv)
    params, state, cam = demo_scene(n=N, w=W, h=H, sh_degree=3,
                                    device=platform_device())
    return run(params, state, cam, args.seq, args.rows)


if __name__ == "__main__":
    main()
