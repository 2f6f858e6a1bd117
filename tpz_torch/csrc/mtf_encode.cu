// Move-to-front encode on Hopper, in segments that run in parallel.
//
// Replaces the XLA scan tpz/kernels/mtf.py::mtf_ranks, which computes the
// MTF rank of every symbol at once by the chunked last-occurrence formula
// (a cummax over a [chunk, alphabet] expansion per chunk, n x alpha work).
// It is not a Pallas kernel: this is a hand kernel for an XLA stage that
// eager torch runs as a loop of n / 2048 trips over [NB, 2048, alpha]
// temporaries. bzip2 encode calls it twice a block: on the block's mapped
// symbols (alpha <= 256) and on the selectors (alpha 6).
//
// What bounds it: the list walk of a row is one serial chain of shuffles
// and ballots, so one warp per row runs only as many chains as there are
// rows (36 at the 2 x 16 MiB level-9 headline, on a 132-SM card). The
// formula's closed form cuts the chain: the list before position i is
// the symbols ordered by their last occurrence before i (unseen symbols
// after them, in their initial order), so the list at any cut follows
// from the last occurrences before it, without walking up to it. Each
// row is cut into segments of `seg` symbols:
//   E1 last  (a CUDA block per segment): the last occurrence of each
//      symbol inside the segment, -1 where it does not occur, by a
//      shared-memory atomicMax (of a warp's lanes holding one symbol only
//      the last one tries).
//   E2 keys  (a block per row, a thread per symbol): in place, an
//      exclusive max-scan of those tables over the segments, the key of
//      symbol t entering a segment being its last occurrence before it,
//      or -1 - t if it has none; 8 segments' loads in flight at once.
//   E3 walk  (a warp per segment): the starting list puts symbol t at the
//      rank that counts the keys above its key (the keys are distinct);
//      then the walk: the list lives in the warp's registers
//      (mtf_list.cuh), a symbol's rank is found by a zero-byte test, a
//      ballot and a shuffle, and the move-to-front is a shuffle up and a
//      masked shift. 32 symbols come with one coalesced load, a chunk
//      ahead of their use, and leave as one store.
// Symbols are < alpha <= 256, so entries from alpha up never reach the
// front.
//
// Layout: v, out [NB, n] int32; length [NB] int32; keys [NB, ceil(n /
// seg), 256] int32 scratch. Positions at or past a row's length are not
// written (the wrapper zeroes out).

#include <cuda_runtime.h>
#include <cstdint>

#include "mtf_list.cuh"

namespace {

constexpr int kSegWarps = 4;  // E3: segments (warps) a CUDA block
constexpr int kScanBatch = 8;

// E1: grid (nseg, NB), 256 threads.
__global__ void __launch_bounds__(256)
    mtf_last_kernel(const int32_t* __restrict__ v,
                    const int32_t* __restrict__ length,
                    int32_t* __restrict__ keys, int n, int seg, int nseg) {
  __shared__ int32_t occ[256];
  const int b = blockIdx.y;
  const int k = blockIdx.x;
  const int len = min(length[b], n);
  if ((long long)k * seg >= len) return;
  const int lo = k * seg;
  const int hi = lo + min(seg, len - lo);
  const int lane = threadIdx.x & 31;
  const int32_t* row = v + (size_t)b * n;
  occ[threadIdx.x] = -1;
  __syncthreads();
  for (int base = lo; base < hi; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int s = i < hi ? row[i] & 0xff : -1;
    const int after = __shfl_down_sync(mtf_list::kFull, s, 1);
    if (s >= 0 && (lane == 31 || after != s)) atomicMax(&occ[s], i);
  }
  __syncthreads();
  keys[((size_t)b * nseg + k) * 256 + threadIdx.x] = occ[threadIdx.x];
}

// E2: grid NB, 256 threads.
__global__ void __launch_bounds__(256)
    mtf_keys_kernel(const int32_t* __restrict__ length,
                    int32_t* __restrict__ keys, int n, int seg, int nseg) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int len = min(length[b], n);
  const int live = len > 0 ? (len - 1) / seg + 1 : 0;
  int32_t* col = keys + (size_t)b * nseg * 256 + t;
  int key = -1 - t;
  for (int k0 = 0; k0 < live; k0 += kScanBatch) {
    int32_t last[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j)
      last[j] = k0 + j < live ? col[(size_t)(k0 + j) * 256] : -1;
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (k0 + j < live) {
        col[(size_t)(k0 + j) * 256] = key;
        if (last[j] >= 0) key = last[j];  // later segments, later positions
      }
    }
  }
}

// E3: grid (nseg / kSegWarps, NB).
__global__ void __launch_bounds__(32 * kSegWarps)
    mtf_encode_kernel(const int32_t* __restrict__ v,
                      const int32_t* __restrict__ length,
                      const int32_t* __restrict__ keys,
                      int32_t* __restrict__ out, int n, int seg, int nseg) {
  __shared__ int32_t key_s[kSegWarps][256];
  __shared__ uint64_t list_s[kSegWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int k = blockIdx.x * kSegWarps + warp;
  const int len = min(length[b], n);
  if (k >= nseg || (long long)k * seg >= len) return;
  const int lo = k * seg;
  const int hi = lo + min(seg, len - lo);

  // The starting list: symbol t at the number of keys above its key.
  int32_t* ks = key_s[warp];
  const int32_t* kb = keys + ((size_t)b * nseg + k) * 256;
  for (int t = lane; t < 256; t += 32) ks[t] = kb[t];
  __syncwarp();
  int mine[8], rank[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mine[j] = ks[8 * lane + j];
    rank[j] = 0;
  }
  for (int u = 0; u < 256; ++u) {
    const int ku = ks[u];
#pragma unroll
    for (int j = 0; j < 8; ++j) rank[j] += ku > mine[j];
  }
  uint8_t* ls = reinterpret_cast<uint8_t*>(list_s[warp]);
#pragma unroll
  for (int j = 0; j < 8; ++j) ls[rank[j]] = (uint8_t)(8 * lane + j);
  __syncwarp();
  uint64_t list = list_s[warp][lane];

  const int32_t* vrow = v + (size_t)b * n;
  int32_t* orow = out + (size_t)b * n;
  int next = lo + lane < hi ? vrow[lo + lane] : 0;
  for (int base = lo; base < hi; base += 32) {
    const int cur = next;
    const int ahead = base + 32 + lane;
    next = ahead < hi ? vrow[ahead] : 0;
    const int cnt = min(32, hi - base);
    int rank_out = 0;
    for (int t = 0; t < cnt; ++t) {
      const uint32_t s = (uint32_t)__shfl_sync(mtf_list::kFull, cur, t) & 0xff;
      const int j = mtf_list::rank_of(list, s, lane);
      if (j != 0) list = mtf_list::move_to_front(list, j, (int)s, lane);
      if (lane == t) rank_out = j;
    }
    if (base + lane < hi) orow[base + lane] = rank_out;
  }
}

}  // namespace

// v, out [NB, n] int32 (out zeroed by the caller); length [NB] int32;
// keys [NB, ceil(n / seg), 256] int32 scratch. Runs one pass: 0 last
// occurrences (E1), 1 keys (E2), 2 walk (E3); the caller runs them in
// order on one stream. Returns a cudaError_t.
extern "C" int tpz_mtf_encode(const void* v, const void* length, void* out,
                              void* keys, int NB, int n, int seg, int pass,
                              cudaStream_t stream) {
  if (NB == 0 || n == 0) return 0;
  const int nseg = (n - 1) / seg + 1;
  const int32_t* vv = static_cast<const int32_t*>(v);
  const int32_t* len = static_cast<const int32_t*>(length);
  int32_t* kk = static_cast<int32_t*>(keys);
  if (pass == 0) {
    mtf_last_kernel<<<dim3(nseg, NB), 256, 0, stream>>>(vv, len, kk, n, seg,
                                                        nseg);
  } else if (pass == 1) {
    mtf_keys_kernel<<<NB, 256, 0, stream>>>(len, kk, n, seg, nseg);
  } else if (pass == 2) {
    mtf_encode_kernel<<<dim3((nseg + kSegWarps - 1) / kSegWarps, NB),
                        32 * kSegWarps, 0, stream>>>(
        vv, len, kk, static_cast<int32_t*>(out), n, seg, nseg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
