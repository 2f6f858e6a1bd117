// Greedy reach walk on Hopper: tiles walked in shared memory, then
// stitched.
//
// Replaces tpz/kernels/parse.py::_parse_pallas: from p = 0, mark p and
// go on at p + max(step[p], 1) while p < N. The TPU version keeps the row
// in VMEM as [N / 128, 128] tiles and walks it with one scalar chain a
// row, read-modify-writing a 128-lane row per step, as Mosaic has no
// scalar VMEM stores.
//
// What bounds it: one chain a row is a chain of dependent global loads
// (about N / 3.6 of them for the steps of a gzip parse); at 512 rows of
// 65,536 the step array (134 MB) does not fit in L2, so each load is a
// DRAM round trip and 512 chains hide almost none of it. The design cuts
// the chain, as the parse walks do (parse_walk.cu, parse_v1_walk.cu):
//   (a) reach_tile_walk, a CUDA block a (row, tile) of `tile` positions:
//       the tile's steps are loaded coalesced into shared memory as 16-bit
//       codes (at least 1; a step that leaves the tile is cut to the tile's
//       end, so no code wraps), warp 0 walks the tile from its start, a
//       guess, by the 32 chunk walks of chunk_walk.cuh, and the block
//       writes the tile's whole int32 output row from the visited bits.
//       The tile's exit, the first position at or past its end that the
//       walk reaches, is taken from the last visited position's int32
//       step, saturated at N;
//   (b) reach_stitch, a warp a row: fix_chunks across tiles, in global
//       memory. Tile 0's start is true. From the previous tile's exit, lane
//       0 follows the true walk until it lands on a position the tile's
//       guessed walk visited (from there the two are one walk, and the
//       tile's exit stands) or leaves the tile; the warp clears the
//       guessed marks below that point, lane 0 sets the true ones. A step
//       past a whole tile clears all of its marks. Greedy walks meet within
//       a few tokens, so this is a handful of dependent loads a tile;
//       walks that never meet (steps of 2 from an odd start) are walked
//       through the whole tile here, slow but exact.
// So (a) streams the steps in and the output out once, and the serial
// part is a chain of shared-memory loads a chunk and (b)'s few global
// loads a tile. A step below 1 counts as 1, so every walk ends.
//
// Layout: step, out [NB, N] int32; tile_exit [NB, ceil(N / tile)] int32
// scratch. tile is a multiple of 32, at most 32,768.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunk_walk.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kStitchThreads = 128;

__device__ __forceinline__ int next_pos(const int32_t* srow, int p, int N) {
  const int s = srow[p];
  return s >= N - p ? N : p + max(s, 1);
}

__global__ void __launch_bounds__(kThreads)
    reach_tile_walk(const int32_t* __restrict__ step,
                    int32_t* __restrict__ out,
                    int32_t* __restrict__ tile_exit, int N, int tile,
                    int ntiles) {
  extern __shared__ uint32_t smem[];
  uint32_t* vis = smem;  // [tile / 32]
  uint16_t* code = reinterpret_cast<uint16_t*>(smem + (tile >> 5));
  __shared__ int chunk_exit[32];
  const int row = blockIdx.x / ntiles;
  const int k = blockIdx.x - row * ntiles;
  const int t0 = k * tile;
  const int n = min(tile, N - t0);
  const int nvis = (n + 31) >> 5;
  const int32_t* srow = step + (size_t)row * N + t0;
  int32_t* orow = out + (size_t)row * N + t0;

  for (int i = threadIdx.x; i < nvis; i += kThreads) vis[i] = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    code[i] = (uint16_t)min(max(__ldg(srow + i), 1), n - i);
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    chunk_walk::walk(code, 0xFFFF, vis, chunk_exit, n, lane);
    // The last visited position: the highest set bit (position 0 always
    // is one).
    int last = 0;
    for (int w = lane; w < nvis; w += 32)
      if (vis[w]) last = (w << 5) + 31 - __clz(vis[w]);
    last = __reduce_max_sync(0xFFFFFFFFu, last);
    if (lane == 0)
      tile_exit[(size_t)row * ntiles + k] =
          next_pos(srow - t0, t0 + last, N);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += kThreads)
    orow[i] = (int32_t)chunk_walk::visited(vis, i);
}

__global__ void __launch_bounds__(kStitchThreads)
    reach_stitch(const int32_t* __restrict__ step, int32_t* out,
                 const int32_t* __restrict__ tile_exit, int NB, int N,
                 int tile, int ntiles) {
  const int row = (blockIdx.x * kStitchThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= NB) return;
  const int32_t* srow = step + (size_t)row * N;
  int32_t* orow = out + (size_t)row * N;
  const int32_t* ex = tile_exit + (size_t)row * ntiles;
  int e = ex[0];  // the true walk's entry into tile k
  for (int k = 1; k < ntiles; ++k) {
    const int c = k * tile;
    const int end = min(c + tile, N);
    int m = e;
    if (lane == 0)
      while (m < end && !orow[m]) m = next_pos(srow, m, N);
    m = __shfl_sync(0xFFFFFFFFu, m, 0);
    const bool met = m < end;
    const int lim = met ? m : end;
    for (int q = c + lane; q < lim; q += 32) orow[q] = 0;
    __syncwarp();
    if (lane == 0)
      for (int q = e; q < lim; q = next_pos(srow, q, N)) orow[q] = 1;
    __syncwarp();
    e = met ? ex[k] : m;
  }
}

}  // namespace

// step, out [NB, N] int32; tile_exit [NB, ceil(N / tile)] int32 scratch.
// The caller checks the tile (a multiple of 32, at most 32,768: at most
// 68 KiB of shared memory). Launches reach_tile_walk, then reach_stitch.
// Returns a cudaError_t.
extern "C" int tpz_reach_walk(const int32_t* step, int32_t* out,
                              int32_t* tile_exit, int NB, int N, int tile,
                              cudaStream_t stream) {
  if (NB == 0 || N == 0) return 0;
  const int ntiles = (N + tile - 1) / tile;
  const int smem = 4 * (tile >> 5) + 2 * tile;  // visited bits, codes
  cudaError_t err = cudaFuncSetAttribute(
      reach_tile_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  reach_tile_walk<<<NB * ntiles, kThreads, smem, stream>>>(
      step, out, tile_exit, N, tile, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_a_block = kStitchThreads / 32;
  reach_stitch<<<(NB + rows_a_block - 1) / rows_a_block, kStitchThreads, 0,
                 stream>>>(step, out, tile_exit, NB, N, tile, ntiles);
  return (int)cudaGetLastError();
}
