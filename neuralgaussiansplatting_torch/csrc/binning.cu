// The binning kernels, for Hopper (sm_90a): one library of two entries.
//
// `binning` bins one call on one stream: the expansion (binning_expand.cuh,
// 3 launches), a stable radix sort of the kept (key, eid) pairs over the
// key's live bits (binning_sort.cuh, 3 launches a pass of 8 bits) and the
// ranges and re-pack (binning_pack.cuh, 3 launches): 24 launches for the
// exact key at 41 x 27 tiles, 18 for the packed one. `radix_sort` is the
// sort alone, for its tests and its timing. Every count that sizes work past
// the expansion is a device value (`live`, `stats`), so nothing waits for
// the host.
//
// stats, 4 int64 passed between the launches: [0] num_rendered (the raw
// demand), [1] the instances truncated (past `capacity`, or past dense_cap)
// and [2] the kept instances, which the expansion writes, and [3] the packed
// slots in use, which the ranges write.

#include <cuda_runtime.h>

#include <cstdint>

#include "binning_common.cuh"
#include "binning_expand.cuh"
#include "binning_pack.cuh"
#include "binning_sort.cuh"

namespace {

using binning_kernels::Settings;
namespace ex = binning_kernels::expansion;
namespace pk = binning_kernels::pack;
namespace rx = binning_kernels::radix;

constexpr long long kInt32Max = 0x7fffffff;

int passes_for(int bits) { return (bits + rx::kBits - 1) / rx::kBits; }

unsigned grid_for(long long items, int per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

// The whole chain on `st`, with keys of type Key.
template <class Key>
void bin(const Settings& s, const ex::Inputs& in, int num_tiles, int bits,
         long long packed_capacity, int max_per_tile, int align,
         long long domain, long long* parts, long long* stats, int* live,
         Key* keys_a, Key* keys_b, int* vals_a, int* vals_b, int* counts,
         int* totals, int* gid_of, int* tile_lo, int* gcount, int* gstart,
         int* tile_start, int* tile_count, int* gid, bool* valid, int* eid,
         int* monitors, cudaStream_t st) {
  const unsigned blocks = grid_for(s.n, ex::kGaussians);
  long long* raw_part = parts;
  long long* trunc_part = parts + blocks;
  long long* kept_part = parts + 2 * static_cast<long long>(blocks);
  ex::raw_parts_kernel<<<blocks, ex::kThreads, 0, st>>>(in.tiles, s, raw_part,
                                                        trunc_part);
  ex::count_kernel<<<blocks, ex::kThreads, 0, st>>>(
      in, s, raw_part, trunc_part, gcount, kept_part, stats);
  ex::write_kernel<Key><<<blocks, ex::kThreads, 0, st>>>(
      in, s, raw_part, kept_part, gcount, gstart, keys_a, gid_of, stats,
      live);

  const int passes = passes_for(bits);
  rx::sort_pairs(keys_a, keys_b, vals_a, vals_b, counts, totals, live,
                 grid_for(domain, rx::kTile), passes, st);
  const bool in_a = passes % 2 == 0;
  const Key* keys = in_a ? keys_a : keys_b;
  const int* sorted_eid = in_a ? vals_a : vals_b;

  pk::bounds_kernel<<<num_tiles / pk::kThreads + 1, pk::kThreads, 0, st>>>(
      keys, live, s.tile_shift, num_tiles, tile_lo);
  pk::ranges_kernel<<<1, pk::kRangeThreads, 0, st>>>(
      tile_lo, num_tiles, packed_capacity, max_per_tile, align, stats,
      tile_start, tile_count, monitors);
  pk::pack_kernel<<<grid_for(packed_capacity, pk::kThreads), pk::kThreads, 0,
                    st>>>(sorted_eid, gid_of, tile_start, tile_count, tile_lo,
                          stats, num_tiles, packed_capacity,
                          static_cast<int>(s.n), static_cast<int>(domain),
                          gid, valid, eid);
}

}  // namespace

extern "C" {

// Bins n >= 1 Gaussians (inputs as ops/binning.py's wrapper checks them;
// conic, opacity and means2d are read only when cull != 0) into `domain`
// expansion slots (`capacity`, or n * dense_cap when dense != 0) and
// packed_capacity packed slots, with the sort key of ops/binning.py's
// key_layout: `bits` wide, the tile at `tile_shift`, 8 B when wide != 0,
// else 4 B. Scratch: parts (3 * ceil(n / per_block) int64), stats (4
// int64), live (1 int32), keys_a and keys_b (domain keys), vals_a, vals_b
// and gid_of (domain int32), counts (256 * ceil(domain / tile) int32),
// totals (256 int32), tile_lo (tiles_x * tiles_y + 1 int32). Outputs:
// gcount, gstart (n int32), tile_start, tile_count (tiles_x * tiles_y int32),
// gid, valid, eid (packed_capacity each) and monitors (5 int32:
// num_rendered, max_tile_load, aligned_demand, dropped, culled). Launches on
// `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue when per_block or tile is not this build's, or a
// size lies outside int32.
int binning(const int* tiles, const int* rect_min, const int* rect_max,
            const float* depths, const float* conic, const float* opacity,
            const float* means2d, long long n, int tiles_x, int tiles_y,
            int block_x, int block_y, int width, int height,
            long long capacity, int dense, int dense_cap, int cull, int wide,
            int tile_shift, int bits, long long packed_capacity,
            int max_per_tile, int align, long long domain, int per_block,
            int tile, long long* parts, long long* stats, int* live,
            void* keys_a, void* keys_b, int* vals_a, int* vals_b,
            int* counts, int* totals, int* gid_of, int* tile_lo,
            int* gcount, int* gstart, int* tile_start, int* tile_count,
            int* gid, bool* valid, int* eid, int* monitors, void* stream) {
  const long long num_tiles = static_cast<long long>(tiles_x) * tiles_y;
  if (per_block != ex::kGaussians || tile != rx::kTile || n < 1 ||
      n >= kInt32Max || tiles_x < 1 || tiles_y < 1 ||
      num_tiles >= kInt32Max || domain < 1 || domain > kInt32Max ||
      packed_capacity < 1 || packed_capacity > kInt32Max || align < 1 ||
      tile_shift < 0 || tile_shift > 31 || bits > (wide ? 64 : 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Settings s{n,     capacity, tiles_x,   block_x, block_y, width,
                   height, dense,    dense_cap, cull,    tile_shift};
  const ex::Inputs in{tiles, rect_min, rect_max, depths,
                      conic, opacity,  means2d};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(num_tiles);
  if (wide) {
    bin(s, in, t, bits, packed_capacity, max_per_tile, align, domain, parts,
        stats, live, static_cast<unsigned long long*>(keys_a),
        static_cast<unsigned long long*>(keys_b), vals_a, vals_b, counts,
        totals, gid_of, tile_lo, gcount, gstart, tile_start, tile_count, gid,
        valid, eid, monitors, st);
  } else {
    bin(s, in, t, bits, packed_capacity, max_per_tile, align, domain, parts,
        stats, live, static_cast<uint32_t*>(keys_a),
        static_cast<uint32_t*>(keys_b), vals_a, vals_b, counts, totals,
        gid_of, tile_lo, gcount, gstart, tile_start, tile_count, gid, valid,
        eid, monitors, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sorts the first *live of `domain` (key, eid) pairs by the low `bits` bits
// of their keys (8 B each when wide != 0, else 4 B), stably, as `binning`
// does, in `passes` passes (ceil(bits / 8)); the eids are the items'
// indices. Scratch as `binning`'s. The result lies in keys_a / vals_a after
// an even number of passes, else in keys_b / vals_b. Launches on `stream`
// and returns cudaGetLastError(); cudaErrorInvalidValue when tile is not
// this build's, passes does not cover bits or a size lies outside int32.
int radix_sort(void* keys_a, void* keys_b, int* vals_a, int* vals_b,
               int* counts, int* totals, const int* live, long long domain,
               int bits, int wide, int passes, int tile, void* stream) {
  if (tile != rx::kTile || domain < 1 || domain > kInt32Max || bits < 1 ||
      bits > (wide ? 64 : 32) || passes != passes_for(bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(domain, rx::kTile);
  if (wide) {
    rx::sort_pairs(static_cast<unsigned long long*>(keys_a),
                   static_cast<unsigned long long*>(keys_b), vals_a, vals_b,
                   counts, totals, live, grid, passes, st);
  } else {
    rx::sort_pairs(static_cast<uint32_t*>(keys_a),
                   static_cast<uint32_t*>(keys_b), vals_a, vals_b, counts,
                   totals, live, grid, passes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* binning_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
