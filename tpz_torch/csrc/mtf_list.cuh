// The move-to-front list of csrc/bzip2_walk.cu and csrc/mtf_encode.cu,
// held in one warp's registers: 256 bytes, 8 a lane (lane l holds list
// positions 8l .. 8l + 7, position 8l + k in byte k). A lookup, a search
// and a move-to-front each cost a constant number of shuffles however
// deep the rank. Every lane of the warp calls each function together.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace mtf_list {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kOnes = 0x0101010101010101ull;
constexpr uint64_t kHighs = 0x8080808080808080ull;

// This lane's part of the list 0, 1, ..., 255.
__device__ __forceinline__ uint64_t identity(int lane) {
  uint64_t list = 0;
  for (int k = 7; k >= 0; --k) list = (list << 8) | (uint64_t)(8 * lane + k);
  return list;
}

// The byte at rank j (0..255), in every lane.
__device__ __forceinline__ int at(uint64_t list, int j) {
  const uint64_t v = __shfl_sync(kFull, list, j >> 3);
  return (int)((v >> ((j & 7) * 8)) & 0xff);
}

// The rank of byte s, which the list holds once, in every lane: a
// zero-byte test of list ^ s * 0x0101..01 in every lane (its lowest
// flagged byte is exact: only bytes above a zero byte can be flagged
// falsely), a ballot for the lane that holds s, and a shuffle of its
// byte position.
__device__ __forceinline__ int rank_of(uint64_t list, uint32_t s, int lane) {
  const uint64_t x = list ^ (kOnes * s);
  const uint64_t z = (x - kOnes) & ~x & kHighs;
  const unsigned hit = __ballot_sync(kFull, z != 0);
  const int here = 8 * lane + ((__ffsll((long long)z) - 1) >> 3);
  return __shfl_sync(kFull, here, __ffs(hit) - 1);
}

// The list with `byte`, found at rank j, moved to the front: ranks 0..j-1
// take ranks 1..j. A shuffle up of each lane's top byte and a masked
// shift.
__device__ __forceinline__ uint64_t move_to_front(uint64_t list, int j,
                                                  int byte, int lane) {
  const uint64_t prev = __shfl_up_sync(kFull, list, 1);
  const uint64_t shifted =
      (list << 8) | (lane == 0 ? (uint64_t)byte : prev >> 56);
  const int mine = j - 8 * lane + 1;  // this lane's ranks <= j
  const uint64_t mask =
      mine >= 8 ? ~0ull : (mine <= 0 ? 0ull : (1ull << (8 * mine)) - 1);
  return (shifted & mask) | (list & ~mask);
}

}  // namespace mtf_list
