"""The classic backward's parts, each chained alone, at the 800^2 bench
configuration (the demo cloud of 100k Gaussians, SH degree 3, the seq path
at capacity 640Ki, packed 512Ki, 4096 per tile, fast sort, tight and
precise cull).

Port of ``tools/exp_bwd_micro.py``: the same rows, ids and names, on one
binning of one view (K1 once for the forward it differentiates):

  [0] seq bwd kernel          K2 (``blend_seq.blend_seq_bwd``) alone
  [1] reduce sorted           the per-Gaussian sum of the 9 gradient rows
                              (``blend.reduce_by_gaussian``)
  [2] reduce sorted dropped   no counterpart
  [3] reduce scatter          no counterpart
  [4] pack gather fwd         packed_all[:, gid]
  [5] preprocess vjp          the backward of ``preprocess_gaussians``
                              (SH, covariance, activations) from constant
                              cotangents of means2d, conic, opacity, rgb
  [6] preprocess fwd          ``preprocess_gaussians``
  [7] epilogue                no counterpart

``NO_COUNTERPART`` gives each missing row's reason. A header line gives
the packed width K, the instances, the aligned demand and the drops.

Timing: ``tools.chain_bench.chain``, 8 steps, best of 2. The JAX tool
chains inside one jit; here the steps run eagerly, so each figure is host
clock with the host's dispatch included (chained eager, host clock).

    python -m neuralgaussiansplatting_torch.tools.exp_bwd_micro [row ids]

``main(argv)`` returns the rows with the header's numbers, "timing",
"launches" and "device". Runs on the CUDA device, or on the CPU when
``NGS_PLATFORM=cpu``.
"""

from __future__ import annotations

from argparse import ArgumentParser

import torch

from neuralgaussiansplatting_torch import platform_device
from neuralgaussiansplatting_torch.demo import demo_scene
from neuralgaussiansplatting_torch.models import gaussians as gm
from neuralgaussiansplatting_torch.ops import binning
from neuralgaussiansplatting_torch.ops import blend
from neuralgaussiansplatting_torch.ops import blend_seq
from neuralgaussiansplatting_torch.ops import preprocess as pp
from neuralgaussiansplatting_torch.ops import rasterize as rast
from neuralgaussiansplatting_torch.tools import _harness, _micro

W = H = 800
N = 100_000
SETTINGS = rast.make_settings(
    "seq", capacity=640 * 1024, max_per_tile=4096, fast_sort=True,
    tight_culling=True, precise_cull=True, packed_capacity=512 * 1024)
ITERS, REPS = 8, 2
NAME_WIDTH = 24
NO_COUNTERPART = {
    "reduce sorted dropped": "the drop-tolerant variant of the JAX "
                             "cumsum-difference reduce; the port's "
                             "per-Gaussian sum is exact with drops too",
    "reduce scatter": "the XLA scatter-add reduction is a TPU variant; the "
                      "port reduces per Gaussian one way",
    "epilogue": "K2 writes the 9 gradient rows itself; the port has no "
                "moment-to-gradient epilogue",
}


def rows_for(params, state, cam, settings=SETTINGS):
    """(header numbers, rows): the binning and blend inputs of one view,
    and the tool's rows as (name, make_body, carry)."""
    dev = params.xyz.device
    bx, by = settings.block_x, settings.block_y
    tiles_x, tiles_y = settings.tiles_for(cam.width, cam.height)
    m3 = params.xyz
    sc = gm.get_scaling(params)
    ro = gm.get_rotation(params)
    op = gm.get_opacity(params, state.alive)
    shs = gm.get_features(params)
    n = m3.shape[0]
    with torch.no_grad():
        pre = pp.preprocess_gaussians(m3, sc, ro, op, shs, 3, cam, bx, by,
                                      tight=True)
        inst = binning.bin_gaussians(
            pre, tiles_x, tiles_y, settings.capacity, settings.max_per_tile,
            settings.chunk, pack_keys=True,
            packed_capacity=settings.packed_capacity, precise_cull=True,
            block_x=bx, block_y=by, width=cam.width, height=cam.height)
        packed_all = blend.pack_instance_attrs_t(
            pre.means2d, pre.conic, pre.opacity, pre.rgb)
        gid = inst.gid.long()
        packed = packed_all[:, gid].contiguous()
        raw = blend_seq.blend_seq_fwd(packed, inst.tile_start,
                                      inst.tile_count, tiles_x)
        cot = torch.ones_like(raw) * 0.1
        cot9 = blend_seq.blend_seq_bwd(packed, inst.tile_start,
                                       inst.tile_count, raw, cot, tiles_x)
    header = {"K": packed.shape[1], "num_rendered": int(inst.num_rendered),
              "aligned": int(inst.aligned_demand),
              "dropped": int(inst.dropped)}

    def row(fn):
        def make():
            def body(carry, s):
                c, acc = carry
                with torch.no_grad():
                    return c + s * 1e-30, acc + fn(c).sum()
            return body
        return make

    def bwd_kernel(c):
        return blend_seq.blend_seq_bwd(packed, inst.tile_start,
                                       inst.tile_count, raw, c.contiguous(),
                                       tiles_x)

    def row_pre_vjp():
        cots = (torch.full((n, 2), 1e-3, device=dev),
                torch.full((n, 3), 1e-3, device=dev),
                torch.full((n,), 1e-3, device=dev),
                torch.full((n, 3), 1e-3, device=dev))

        def body(carry, s):
            x, acc = carry
            x = x.detach().requires_grad_()
            pr = pp.preprocess_gaussians(x, sc, ro, op, shs, 3, cam, bx, by,
                                         tight=True)
            outs = (pr.means2d, pr.conic, pr.opacity, pr.rgb)
            pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
            (gx,) = torch.autograd.grad([o for o, _ in pairs], [x],
                                        [c for _, c in pairs])
            with torch.no_grad():
                return x + s * 1e-30 + gx * 1e-30, acc + gx.sum()
        return body

    def row_pre_fwd():
        def body(carry, s):
            x, acc = carry
            with torch.no_grad():
                pr = pp.preprocess_gaussians(x + s, sc, ro, op, shs, 3, cam,
                                             bx, by, tight=True)
                return x, (acc + pr.means2d.sum() + pr.rgb.sum()
                           + pr.conic.sum())
        return body

    z = torch.zeros((), device=dev)
    rows = [
        ("seq bwd kernel", row(bwd_kernel), (cot, z)),
        ("reduce sorted",
         row(lambda c: blend.reduce_by_gaussian(c, inst.gid, n)),
         (cot9, z)),
        ("reduce sorted dropped", None, (cot9, z)),
        ("reduce scatter", None, (cot9, z)),
        ("pack gather fwd", row(lambda pa: pa[:, gid]), (packed_all, z)),
        ("preprocess vjp", row_pre_vjp, (m3, z)),
        ("preprocess fwd", row_pre_fwd, (m3, z)),
        ("epilogue", None, (cot9, z)),
    ]
    return header, rows


def run(params, state, cam, selection=()) -> dict:
    """Print the header and chain and print the selected rows (every row
    when ``selection`` is empty); returns them with the header's numbers,
    "timing", "launches" and "device"."""
    before = _harness.launch_counts()
    header, rows = rows_for(params, state, cam)
    print(f"K(packed)={header['K']} num_rendered={header['num_rendered']} "
          f"aligned={header['aligned']} dropped={header['dropped']}",
          flush=True)
    done = _micro.run_rows(rows, NO_COUNTERPART, NAME_WIDTH, selection,
                           iters=ITERS, reps=REPS)
    return _micro.result(done, before, params.xyz.device, **header)


def main(argv=None) -> dict:
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="*")
    args = ap.parse_args(argv)
    params, state, cam = demo_scene(n=N, w=W, h=H, sh_degree=3,
                                    device=platform_device())
    return run(params, state, cam, args.rows)


if __name__ == "__main__":
    main()
