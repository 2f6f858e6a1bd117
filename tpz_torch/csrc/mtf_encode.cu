// Move-to-front encode on Hopper: one warp per row.
//
// Replaces the XLA scan tpz/kernels/mtf.py::mtf_ranks, which computes the
// MTF rank of every symbol at once by the chunked last-occurrence formula
// (a cummax over a [chunk, alphabet] expansion per chunk, n x alpha work).
// It is not a Pallas kernel: this is a hand kernel for an XLA stage that
// eager torch runs as a loop of n / 2048 trips over [NB, 2048, alpha]
// temporaries. Here the list walk itself runs, as bzip2 encoders run it:
// the rank of symbol s is its position in the list, then s moves to the
// front. bzip2 encode calls it twice a block: on the block's mapped
// symbols (alpha <= 256) and on the selectors (alpha 6).
//
// Design: the 256-entry list lives in the warp's registers, 8 bytes a
// lane (lane l holds list positions 8l .. 8l + 7, position 8l + k in byte
// k), the mirror of the MTF list of csrc/bzip2_walk.cu. A rank is a
// zero-byte test of (list ^ s * 0x0101..01) in every lane, a ballot for
// the lane that holds s, and a shuffle of its byte position; the
// move-to-front is a shuffle up of each lane's top byte and a masked
// shift, so it costs the same whatever the rank. The list starts as the
// identity; symbols are < alpha <= 256, so entries from alpha up never
// reach the front. The warp loads 32 symbols with one coalesced load,
// ahead of their use, and stores their 32 ranks with one.
//
// What bounds it: the list makes a row one serial chain of shuffles and
// ballots (a few tens of cycles of latency per symbol), so the kernel is
// latency-bound with one warp per row; rows run in parallel.
//
// Layout: v, out [NB, n] int32; length [NB] int32. Positions at or past a
// row's length are not written (the wrapper zeroes out).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kOnes = 0x0101010101010101ull;
constexpr uint64_t kHighs = 0x8080808080808080ull;

__global__ void __launch_bounds__(32)
    mtf_encode_kernel(const int32_t* __restrict__ v,
                      const int32_t* __restrict__ length,
                      int32_t* __restrict__ out, int n) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* vrow = v + (size_t)b * n;
  int32_t* orow = out + (size_t)b * n;
  const int len = min(length[b], n);

  uint64_t mtf = 0;
  for (int k = 7; k >= 0; --k) mtf = (mtf << 8) | (uint64_t)(8 * lane + k);

  int next = lane < len ? vrow[lane] : 0;
  for (int base = 0; base < len; base += 32) {
    const int cur = next;
    const int ahead = base + 32 + lane;
    next = ahead < len ? vrow[ahead] : 0;
    const int cnt = min(32, len - base);
    int rank = 0;
    for (int t = 0; t < cnt; ++t) {
      const uint32_t s = (uint32_t)__shfl_sync(kFull, cur, t) & 0xff;
      // The byte equal to s: the lowest flagged byte of the zero-byte
      // test is exact (only bytes above a zero byte can be flagged
      // falsely), and s is in exactly one lane.
      const uint64_t x = mtf ^ (kOnes * s);
      const uint64_t z = (x - kOnes) & ~x & kHighs;
      const unsigned hit = __ballot_sync(kFull, z != 0);
      const int here = 8 * lane + ((__ffsll((long long)z) - 1) >> 3);
      const int j = __shfl_sync(kFull, here, __ffs(hit) - 1);
      // Move s from rank j to the front: ranks 0..j-1 take ranks 1..j.
      const uint64_t prev = __shfl_up_sync(kFull, mtf, 1);
      const uint64_t shifted = (mtf << 8) | (lane == 0 ? (uint64_t)s : prev >> 56);
      const int mine = j - 8 * lane + 1;  // this lane's ranks <= j
      const uint64_t mask =
          mine >= 8 ? ~0ull : (mine <= 0 ? 0ull : (1ull << (8 * mine)) - 1);
      mtf = (shifted & mask) | (mtf & ~mask);
      if (lane == t) rank = j;
    }
    if (base + lane < len) orow[base + lane] = rank;
  }
}

}  // namespace

// v, out [NB, n] int32 (out zeroed by the caller); length [NB] int32.
// Returns a cudaError_t.
extern "C" int tpz_mtf_encode(const void* v, const void* length, void* out,
                              int NB, int n, cudaStream_t stream) {
  if (NB == 0 || n == 0) return 0;
  mtf_encode_kernel<<<NB, 32, 0, stream>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(length),
      static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}
