// Backward of the surfel blend (surfel_blend_fwd.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel. Given the forward's packed table, its output `raw`
// and the cotangent of that output, it writes for every instance slot of
// every tile the 18 gradient rows of the packed table: the box centre's 2,
// the transform's 9, the opacity's, rgb's 3 and the normal's 3. Per tile it
// re-walks the forward chain front to back (the same arithmetic, so T,
// blended and done repeat the forward's) and takes dL/dalpha from running
// prefixes, as K2 does (ops/surfel_blend.py states the formulas; its plain
// version surfel_blend_bwd_reference keeps this operation order):
//
//   g_w    = rgb . g_rgb + n . g_n + z g_depth
//            + g_dist ((m^2 A + M2) - 2 m M1)         (A, M1, M2: totals)
//   prefix = prefix + w g_w
//   dalpha = T g_w - (tot - prefix) / (1 - a)
//   g_z    = w g_depth + g_dist 2 w (m A - M1) dm/dz  (+ g_median at the
//                                                      median's pair)
//
// then back through alpha = op exp(-rho / 2) (unclamped, as K2 and 2DGS's
// rasterizer take it) to rho and z: on the intersection's side through
// (u, v) = (c.x, c.y) / c.z and c = k x l to the transform's rows, on the
// low-pass side to the centre and T_w.z. Pairs that are not blended add
// exactly zero. The walk stops at the tile's deepest contributor; slots
// past it are left as the caller's zeros. Built with --fmad=false and the
// precise expf.
//
// What bounds it on an H100: arithmetic, as the function needs it: per
// pair before the pixel's own n_contrib, the forward's intersection
// (~40 operations) inside the surfel's box, an expf where the power is at or
// above the cutoff, and ~110 more per blended pair for the gradient terms,
// against 72 bytes of attributes and 72 of gradient rows per slot and 112
// bytes of raw and cotangent per pixel (ngsbench/surfel_counts.py). Design:
//
// - One 512-thread CTA per tile, 2 pixels a thread (a vertical pair), each
//   warp a compact 8x8 patch, so that its lanes mostly blend or skip
//   together; 16 warps keep the 2 pixels' state (20 floats each) in
//   registers.
// - Each pixel stops at its own n_contrib and on done; each warp at the
//   deepest contributor of its 64 pixels, writing zeros for the rest of
//   the batch.
// - The forward's alpha-floor skip and per-warp box test (a warp whose
//   patch misses a surfel's box writes its zero partials at once).
// - Per surfel a warp that blended anything sums its 18 rows by two of
//   blend_common.cuh's fixed reduce-scatters (warp_rows) and stores them
//   into the CTA's [16 warps][18 rows][32 slots] partials; after the batch
//   one thread per (row, slot) adds the 16 warps in order. No atomics: the
//   output repeats bit for bit.

#include <cuda_runtime.h>

#include "surfel_blend_common.cuh"

namespace {

using namespace surfel;

constexpr int kBThreads = 512;
constexpr int kBWarps = kBThreads / 32;
constexpr int kSBatch = 32;  // surfels staged per batch
constexpr int kPer = 2;      // pixels per thread: (x, y) and (x, y + 1)

__global__ void __launch_bounds__(kBThreads, 1)
surfel_blend_bwd_kernel(const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const float* __restrict__ packed, long long k,
                        const float* __restrict__ raw,
                        const float* __restrict__ cot, int tiles_x,
                        float* __restrict__ grad) {
  __shared__ SurfelStaged batch[kSBatch];
  // +1: the lane groups' stores fall in distinct banks
  __shared__ float part[kBWarps][kSRows][kSBatch + 1];
  __shared__ int warp_max[kBWarps];

  const int t = blockIdx.x;
  const long long start = tile_start[t];
  const int count = tile_count[t];
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* res = raw + static_cast<long long>(t) * kChannels * kPix;
  const float* ct = cot + static_cast<long long>(t) * kChannels * kPix;

  // the tile's stop: its deepest contributor over all 1024 pixels
  int deepest = 0;
  for (int p = threadIdx.x; p < kPix; p += kBThreads)
    deepest = max(deepest, static_cast<int>(res[4 * kPix + p]));
  deepest = __reduce_max_sync(kFull, deepest);
  if (lane == 0) warp_max[warp] = deepest;
  __syncthreads();
  deepest = 0;
#pragma unroll
  for (int w = 0; w < kBWarps; ++w) deepest = max(deepest, warp_max[w]);
  const int limit = min(count, deepest);

  // 16 warps: 8x8 patches, 4 across and 4 down; lane l owns pixels
  // (l % 8, 2 (l / 8)) and the one below it
  const int wx = (warp & 3) * 8;
  const int wy = (warp >> 2) * 8;
  const int cx = wx + (lane & 7);
  const int cy = wy + (lane >> 3) * 2;
  const float x0 = static_cast<float>(tx * kTile + cx);
  const float y0 = static_cast<float>(ty * kTile + cy);
  float trans[kPer], prefix[kPer], tot[kPer];
  float gr[kPer][3], gn[kPer][3], gd[kPer], gdist[kPer], gmed[kPer];
  float at[kPer], m1t[kPer], m2t[kPer], medi[kPer];
  int stop[kPer];
  bool done[kPer];
  int warp_stop = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = (cy + q) * kTile + cx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gr[q][c] = ct[c * kPix + p];
      gn[q][c] = ct[(5 + c) * kPix + p];
    }
    gd[q] = ct[8 * kPix + p];
    gdist[q] = ct[11 * kPix + p];
    gmed[q] = ct[12 * kPix + p];
    at[q] = 1.f - res[3 * kPix + p];
    m1t[q] = res[9 * kPix + p];
    m2t[q] = res[10 * kPix + p];
    medi[q] = res[13 * kPix + p];
    const float* r = res + p;
    const float s = ((((r[0] * gr[q][0] + r[kPix] * gr[q][1]) +
                       r[2 * kPix] * gr[q][2]) +
                      r[3 * kPix] * ct[3 * kPix + p]) +
                     ((r[5 * kPix] * gn[q][0] + r[6 * kPix] * gn[q][1]) +
                      r[7 * kPix] * gn[q][2])) +
                    r[8 * kPix] * gd[q];
    tot[q] = s + gdist[q] * ((at[q] * m2t[q] + m2t[q] * at[q]) -
                             (2.f * m1t[q]) * m1t[q]);
    stop[q] = min(limit, static_cast<int>(res[4 * kPix + p]));
    warp_stop = max(warp_stop, stop[q]);
    trans[q] = 1.f;
    prefix[q] = 0.f;
    done[q] = false;
  }
  warp_stop = __reduce_max_sync(kFull, warp_stop);
  const float wx0 = static_cast<float>(tx * kTile + wx);
  const float wy0 = static_cast<float>(ty * kTile + wy);
  const float wx1 = wx0 + 7.f;
  const float wy1 = wy0 + 7.f;

  for (int base = 0; base < limit; base += kSBatch) {
    const int nb = min(kSBatch, limit - base);
    __syncthreads();  // the previous batch's buffers are consumed
    stage_surfels(batch, packed, k, start + base, nb);
    __syncthreads();

    // this warp's slots past its deepest contributor hold zeros
    const int nw = max(0, min(nb, warp_stop - base));
    for (int idx = lane; idx < (nb - nw) * kSRows; idx += 32)
      part[warp][idx % kSRows][nw + idx / kSRows] = 0.f;
    for (int j = 0; j < nw; ++j) {
      if (surfel_missed(batch, j, wx0, wx1, wy0, wy1)) {  // adds zero
        if ((lane & 3) == 0) {
          part[warp][lane >> 2][j] = 0.f;
          part[warp][9 + (lane >> 2)][j] = 0.f;
        }
        if (lane == 0) {
          part[warp][8][j] = 0.f;
          part[warp][17][j] = 0.f;
        }
        continue;
      }
      const SurfelStaged in = load_surfel(batch, j);
      const int idx = base + j;
      Pair pr[kPer];
      bool need[kPer];
      bool any_need = false;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        pr[q] = pair_of(in, x0, y0 + static_cast<float>(q));
        need[q] = !done[q] && idx < stop[q] && pr[q].c2 != 0.f &&
                  pr[q].z >= kNear && !(pr[q].power < in.cut);
        any_need |= need[q];
      }
      float acc[kSRows];
#pragma unroll
      for (int r = 0; r < kSRows; ++r) acc[r] = 0.f;
      bool any = false;
      if (__any_sync(kFull, any_need)) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const Pair& p = pr[q];
          const float px = x0;
          const float py = y0 + static_cast<float>(q);
          const float gexp = expf(p.power);
          const float opg = in.op * gexp;
          const float alpha = fminf(kAlphaMax, opg);
          const float a = (need[q] && p.power <= 0.f && alpha >= kAlphaMin)
                              ? alpha : 0.f;
          const float ta = trans[q] * a;
          const float t_new = trans[q] - ta;
          const bool blended = a > 0.f && t_new >= kStopT;
          done[q] = done[q] || (a > 0.f && t_new < kStopT);
          if (blended) {
            const float w = ta;
            const float zb = p.z;
            const float m = kMScale * (1.f - kNear * (1.f / zb));
            const float gw =
                ((((in.r * gr[q][0] + in.g * gr[q][1]) + in.b * gr[q][2]) +
                  ((in.n0 * gn[q][0] + in.n1 * gn[q][1]) +
                   in.n2 * gn[q][2])) +
                 zb * gd[q]) +
                gdist[q] * ((((m * m) * at[q]) + m2t[q]) -
                            (2.f * m) * m1t[q]);
            prefix[q] = prefix[q] + w * gw;
            const float dalpha =
                trans[q] * gw - (tot[q] - prefix[q]) / (1.f - a);
            float gz = w * gd[q] +
                       (gdist[q] * ((2.f * w) * (m * at[q] - m1t[q]))) *
                           (kDMScale * (1.f / (zb * zb)));
            if (medi[q] == static_cast<float>(idx + 1)) gz = gz + gmed[q];
            const float grho = -0.5f * (opg * dalpha);
            if (p.on3d) {
              const float gu = grho * (2.f * p.u) + gz * in.tw0;
              const float gv = grho * (2.f * p.v) + gz * in.tw1;
              const float gc0 = gu / p.c2;
              const float gc1 = gv / p.c2;
              const float gc2 = -(gu * p.u + gv * p.v) / p.c2;
              const float* kk = p.k;
              const float* ll = p.l;
              const float gk0 = ll[1] * gc2 - ll[2] * gc1;
              const float gk1 = ll[2] * gc0 - ll[0] * gc2;
              const float gk2 = ll[0] * gc1 - ll[1] * gc0;
              const float gl0 = gc1 * kk[2] - gc2 * kk[1];
              const float gl1 = gc2 * kk[0] - gc0 * kk[2];
              const float gl2 = gc0 * kk[1] - gc1 * kk[0];
              acc[2] = acc[2] + -gk0;
              acc[3] = acc[3] + -gk1;
              acc[4] = acc[4] + -gk2;
              acc[5] = acc[5] + -gl0;
              acc[6] = acc[6] + -gl1;
              acc[7] = acc[7] + -gl2;
              acc[8] = acc[8] + ((px * gk0 + py * gl0) + gz * p.u);
              acc[9] = acc[9] + ((px * gk1 + py * gl1) + gz * p.v);
              acc[10] = acc[10] + ((px * gk2 + py * gl2) + gz);
            } else {
              acc[0] = acc[0] + grho * (4.f * p.dx);
              acc[1] = acc[1] + grho * (4.f * p.dy);
              acc[10] = acc[10] + gz;
            }
            acc[11] = acc[11] + gexp * dalpha;
            acc[12] = acc[12] + w * gr[q][0];
            acc[13] = acc[13] + w * gr[q][1];
            acc[14] = acc[14] + w * gr[q][2];
            acc[15] = acc[15] + w * gn[q][0];
            acc[16] = acc[16] + w * gn[q][1];
            acc[17] = acc[17] + w * gn[q][2];
            trans[q] = t_new;
            any = true;
          }
        }
      }
      float s0 = 0.f, r8 = 0.f, s1 = 0.f, r17 = 0.f;
      if (__any_sync(kFull, any)) {
        const float(&lo)[kRows] = *reinterpret_cast<float(*)[kRows]>(acc);
        const float(&hi)[kRows] =
            *reinterpret_cast<float(*)[kRows]>(acc + kRows);
        s0 = warp_rows(lo, lane, r8);
        s1 = warp_rows(hi, lane, r17);
      }
      if ((lane & 3) == 0) {
        part[warp][lane >> 2][j] = s0;
        part[warp][9 + (lane >> 2)][j] = s1;
      }
      if (lane == 0) {
        part[warp][8][j] = r8;
        part[warp][17][j] = r17;
      }
    }
    __syncthreads();

    // the CTA's sum of its 16 warps, in order
    for (int idx = threadIdx.x; idx < kSRows * nb; idx += kBThreads) {
      const int row = idx / nb;
      const int j = idx % nb;
      float s = part[0][row][j];
#pragma unroll
      for (int w = 1; w < kBWarps; ++w) s = s + part[w][row][j];
      grad[row * k + start + base + j] = s;
    }
  }
}

}  // namespace

extern "C" {

// tile_start, tile_count: (num_tiles,) int32; packed: (18, k) float32
// row-major; raw, cot: (num_tiles, 14, 1024) float32 (cot's rows 4, 9, 10
// and 13 are not read); grad: (18, k) float32, zero-filled by the caller
// (slots past each tile's stop are not written). Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int surfel_blend_bwd(const void* tile_start, const void* tile_count,
                     const void* packed, long long k, const void* raw,
                     const void* cot, int num_tiles, int tiles_x, void* grad,
                     void* stream) {
  if (num_tiles <= 0) return 0;
  surfel_blend_bwd_kernel<<<num_tiles, kBThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(packed), k, static_cast<const float*>(raw),
      static_cast<const float*>(cot), tiles_x, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

const char* surfel_blend_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
