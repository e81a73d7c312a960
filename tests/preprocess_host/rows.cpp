// The preprocess kernels' per-Gaussian functions (forward_row, backward_row
// of csrc/preprocess_common.cuh) over n rows on the host, one Gaussian after
// another, for test_torch_preprocess_route.py. Built with g++
// -ffp-contract=off, as nvcc --fmad=false builds the kernels.
#include "preprocess_common.cuh"

using namespace preprocess;

namespace {

Settings settings(long long n, const float* f, const int* i) {
  // f: focal_x, focal_y, limit_x, limit_y, scale_modifier; i: width, height,
  // tiles_x, tiles_y, block_x, block_y, tight
  const float bx = static_cast<float>(i[4]), by = static_cast<float>(i[5]);
  return Settings{n, f[0], f[1], f[2], f[3],
                  static_cast<float>(i[0]), static_cast<float>(i[1]),
                  static_cast<float>(i[0] * 0.5),
                  static_cast<float>(i[1] * 0.5), i[2], i[3], bx, by,
                  1.f / bx, 1.f / by, f[4], i[6]};
}

float4 row4(const float* p, long long i) {
  return make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
}

template <int DEG>
void fwd(const float* means, const float* scales, const float* rots,
         const float* opac, const float* shs, long long stride,
         const float* cam, const float* off, const Settings& s, float* m2,
         float* depth, int* rad, float* conic, float* rgb, int* lo, int* hi,
         int* tiles) {
  for (long long i = 0; i < s.n; ++i) {
    RowOut o;
    const float2 of = off ? make_float2(off[2 * i], off[2 * i + 1])
                          : make_float2(0.f, 0.f);
    forward_row<DEG>(means + 3 * i, scales + 3 * i, row4(rots, i), opac[i],
                     off ? &of : nullptr, shs + stride * i, cam, s, o);
    m2[2 * i] = o.means2d.x;
    m2[2 * i + 1] = o.means2d.y;
    depth[i] = o.depth;
    rad[i] = o.radius;
    lo[2 * i] = o.lo.x;
    lo[2 * i + 1] = o.lo.y;
    hi[2 * i] = o.hi.x;
    hi[2 * i + 1] = o.hi.y;
    tiles[i] = o.tiles;
    for (int k = 0; k < 3; ++k) {
      conic[3 * i + k] = o.conic[k];
      if (DEG >= 0) rgb[3 * i + k] = o.rgb[k];
    }
  }
}

template <int DEG>
void bwd(const float* means, const float* scales, const float* rots,
         const float* shs, long long stride, const float* cam,
         const Settings& s, const float* gm, const float* gc, const float* gr,
         float* g_means, float* g_scales, float* g_rots, float* g_shs,
         float* g_off) {
  // kColors (precomputed colours) reads and writes no SH row
  constexpr int NC = DEG < 0 ? 1 : 3 * (DEG + 1) * (DEG + 1);
  for (long long i = 0; i < s.n; ++i) {
    float sh[NC];
    if (DEG >= 0) {
      for (int k = 0; k < NC; ++k) sh[k] = shs[stride * i + k];
    }
    RowGrad g;
    backward_row<DEG>(means + 3 * i, scales + 3 * i, row4(rots, i), sh,
                      make_float2(gm[2 * i], gm[2 * i + 1]), gc + 3 * i,
                      gr + 3 * i, cam, s, g);
    for (int k = 0; k < 3; ++k) {
      g_means[3 * i + k] = g.mean[k];
      g_scales[3 * i + k] = g.scale[k];
    }
    for (int k = 0; k < 4; ++k) g_rots[4 * i + k] = g.rot[k];
    for (long long k = 0; DEG >= 0 && k < stride; ++k) {
      g_shs[stride * i + k] = k < NC ? sh[k] : 0.f;
    }
    if (g_off) {
      g_off[2 * i] = g.offset.x;
      g_off[2 * i + 1] = g.offset.y;
    }
  }
}

}  // namespace

extern "C" {

// cam: view (16), full_proj (16), campos (3); off and g_off may be null;
// deg -1 (kColors) reads no shs and writes no rgb or g_shs.
void host_fwd(int deg, long long n, const float* f, const int* i,
              const float* means, const float* scales, const float* rots,
              const float* opac, const float* shs, long long stride,
              const float* cam, const float* off, float* m2, float* depth,
              int* rad, float* conic, float* rgb, int* lo, int* hi,
              int* tiles) {
  const Settings s = settings(n, f, i);
  switch (deg) {
    case 0: fwd<0>(means, scales, rots, opac, shs, stride, cam, off, s, m2,
                   depth, rad, conic, rgb, lo, hi, tiles); break;
    case 1: fwd<1>(means, scales, rots, opac, shs, stride, cam, off, s, m2,
                   depth, rad, conic, rgb, lo, hi, tiles); break;
    case 2: fwd<2>(means, scales, rots, opac, shs, stride, cam, off, s, m2,
                   depth, rad, conic, rgb, lo, hi, tiles); break;
    case kColors: fwd<kColors>(means, scales, rots, opac, shs, stride, cam,
                               off, s, m2, depth, rad, conic, rgb, lo, hi,
                               tiles); break;
    default: fwd<3>(means, scales, rots, opac, shs, stride, cam, off, s, m2,
                    depth, rad, conic, rgb, lo, hi, tiles); break;
  }
}

void host_bwd(int deg, long long n, const float* f, const int* i,
              const float* means, const float* scales, const float* rots,
              const float* shs, long long stride, const float* cam,
              const float* gm, const float* gc, const float* gr,
              float* g_means, float* g_scales, float* g_rots, float* g_shs,
              float* g_off) {
  const Settings s = settings(n, f, i);
  switch (deg) {
    case 0: bwd<0>(means, scales, rots, shs, stride, cam, s, gm, gc, gr,
                   g_means, g_scales, g_rots, g_shs, g_off); break;
    case 1: bwd<1>(means, scales, rots, shs, stride, cam, s, gm, gc, gr,
                   g_means, g_scales, g_rots, g_shs, g_off); break;
    case 2: bwd<2>(means, scales, rots, shs, stride, cam, s, gm, gc, gr,
                   g_means, g_scales, g_rots, g_shs, g_off); break;
    case kColors: bwd<kColors>(means, scales, rots, shs, stride, cam, s, gm,
                               gc, gr, g_means, g_scales, g_rots, g_shs,
                               g_off); break;
    default: bwd<3>(means, scales, rots, shs, stride, cam, s, gm, gc, gr,
                    g_means, g_scales, g_rots, g_shs, g_off); break;
  }
}

}  // extern "C"
