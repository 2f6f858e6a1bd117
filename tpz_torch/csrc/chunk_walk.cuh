// The chunked walk through shared memory shared by the parse kernels
// (parse_v1_walk.cu, parse_walk.cu) and the reach walk's tiles
// (reach_walk.cu): the positions a walk p -> p + step(p) visits from 0
// until p >= n, as bits, when every step is known in advance and lies in
// shared memory.
//
// One warp runs it. Each lane walks one of 32 chunks of whole 32-position
// words from the chunk's start, as if a token began there (a guess),
// keeping the visited bits of its current word in a register and storing
// each word once; then lane 0 puts the chunks in order (fix_chunks).
// Greedy parses meet again within a few tokens, so a chunk's guessed walk
// is almost all of its true walk.

#pragma once

#include <cstdint>

namespace chunk_walk {

__device__ __forceinline__ bool visited(const uint32_t* vis, int p) {
  return (vis[p >> 5] >> (p & 31)) & 1u;
}

// Chunk k's walk began at its start c, a guess; the true walk enters at
// e, the first position at or past c that it visits (chunk 0 begins at
// 0, so its walk is true, and so is its exit). From e the true walk goes
// on until it lands on a position the guessed walk visited, m: from there
// the two are one walk, and the chunk's exit stands. The guessed bits
// below m are cleared and the true ones set. Where they do not meet inside
// the chunk, the true walk runs to the chunk's end and gives its exit.
__device__ inline void fix_chunks(const uint16_t* code, uint16_t mask,
                                  uint32_t* vis, const int* chunk_exit,
                                  int C, int n) {
  int e = chunk_exit[0];
  for (int c = C, k = 1; c < n; c += C, ++k) {
    const int end = min(c + C, n);
    int m = e;
    while (m < end && !visited(vis, m)) m += code[m] & mask;
    const bool met = m < end;
    const int lim = met ? m : end;
    for (int w = c >> 5; w << 5 < lim; ++w) {  // clear [c, lim)
      const int hi = lim - (w << 5);
      vis[w] &= hi >= 32 ? 0u : ~((1u << hi) - 1u);
    }
    for (int q = e; q < lim; q += code[q] & mask)
      vis[q >> 5] |= 1u << (q & 31);
    e = met ? chunk_exit[k] : m;
  }
}

// The walk over positions [0, n) by the calling warp (lane = its lane
// index): step(p) = code[p] & mask, at least 1. `vis` holds at least
// (n + 31) / 32 words, zeroed by the caller and visible to the warp; the
// bits of visited positions are set, the rest stay 0. `chunk_exit` is 32
// ints of shared memory. The warp is synchronised on return; the rest of
// the block sees `vis` after a __syncthreads.
__device__ inline void walk(const uint16_t* code, uint16_t mask,
                            uint32_t* vis, int* chunk_exit, int n,
                            int lane) {
  const int C = (n + 32 * 32 - 1) / (32 * 32) * 32;
  const int c0 = lane * C;
  const int c1 = min(c0 + C, n);
  int p = c0;
  if (c0 < n) {
    int w = c0 >> 5;
    uint32_t bits = 0;
    while (p < c1) {
      if ((p >> 5) != w) {
        vis[w] = bits;
        w = p >> 5;
        bits = 0;
      }
      bits |= 1u << (p & 31);
      p += code[p] & mask;
    }
    vis[w] = bits;
  }
  chunk_exit[lane] = p;
  __syncwarp();
  if (lane == 0 && n > 0) fix_chunks(code, mask, vis, chunk_exit, C, n);
  __syncwarp();
}

}  // namespace chunk_walk
