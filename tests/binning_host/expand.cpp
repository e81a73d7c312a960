// The binning expansion's per-Gaussian functions (csrc/binning_common.cuh:
// in_domain, gaussian, walk, the keys) over n Gaussians on the host, one
// after another, for test_torch_binning_route.py. Built with g++
// -ffp-contract=off, as nvcc --fmad=false builds the kernels, against the
// stand-in <cuda_runtime.h> of tests/preprocess_host.
#include <cstring>

#include "binning_common.cuh"

using namespace binning_kernels;

extern "C" {

// The expansion of csrc/binning.cu's `binning` entry, taking the arguments
// of that entry it reads or writes, in their order: stats[0..2], live,
// gcount, gstart and the keys and gids of the kept instances are written
// (keys 8 B each when wide != 0, else 4 B).
int host_binning_expand(const int* tiles, const int* rect_min,
                        const int* rect_max, const float* depths,
                        const float* conic, const float* opacity,
                        const float* means2d, long long n, int tiles_x,
                        int block_x, int block_y, int width, int height,
                        long long capacity, int dense, int dense_cap,
                        int cull, int wide, int tile_shift, long long* stats,
                        int* live, void* keys, int* gid_of, int* gcount,
                        int* gstart) {
  const Settings s{n,      capacity, tiles_x, block_x,   block_y,   width,
                   height, dense,    dense_cap, cull, tile_shift};
  long long start = 0, kept_total = 0, trunc = 0;
  for (long long g = 0; g < n; ++g) {
    const int t = tiles[g];
    const int count = in_domain(t, start, s);
    const Gaussian q =
        gaussian(g, rect_min, rect_max, conic, opacity, means2d, s);
    uint32_t bits;
    std::memcpy(&bits, &depths[g], sizeof bits);
    const long long at = kept_total;
    const int kept = walk(q, count, s, [&](int j, int tile) {
      if (wide) {
        static_cast<unsigned long long*>(keys)[at + j] =
            sort_key<unsigned long long>(tile, bits, tile_shift);
      } else {
        static_cast<uint32_t*>(keys)[at + j] =
            sort_key<uint32_t>(tile, bits, tile_shift);
      }
      gid_of[at + j] = static_cast<int>(g);
    });
    gstart[g] = static_cast<int>(at);
    gcount[g] = kept;
    kept_total += kept;
    start += t;
    trunc += max(t - dense_cap, 0);
  }
  stats[0] = start;
  stats[1] = dense ? trunc : (start > capacity ? start - capacity : 0);
  stats[2] = kept_total;
  *live = static_cast<int>(kept_total);
  return 0;
}

}  // extern "C"
