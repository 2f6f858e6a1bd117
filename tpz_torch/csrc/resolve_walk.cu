// LZ77 copy machine on Hopper: match resolution over the dense marker
// space of the DEFLATE (and later LZHUF) decode.
//
// Replaces tpz/kernels/resolve_walk.py::_phase_call (both phases) and
// computes resolve_copy_machine's final packed state: index << 8 | byte at
// every position. Entries are u32 (index << 8 needs 32 bits below 2^24);
// "resolved" means entry >> 8 == own index, otherwise the entry is a
// pointer target << 8.
//
// Phase 1 (one warp per segment of seg_len positions, segments in
// parallel). The warp walks its segment in order, 32 positions at a time:
// it loads the markers, writes the literal state of the window (a
// non-literal reads as resolved byte 0 until a copy covers it), and finds
// the first match start by ballot. Byte k of a match (start p, len, dist)
// reads p - dist + (k mod dist) (the reference's modular re-basing of
// self-overlap), which always lies before p, so all of a match's bytes
// are independent and the 32 lanes copy them at once. A source before
// the segment becomes the pointer max(src, 0) << 8; a source in the
// segment that is itself a pointer is copied as a pointer (path
// compression), so every pointer leads into an earlier segment. A copy
// stops at the segment end: the caller injects a continuation marker at
// each segment cut.
//
// Phase 2 (the design differs from the reference's single in-order chain
// over the whole span, which would be one thread here). After phase 1 a
// pointer always targets an earlier position, and a target's entry only
// ever changes from a pointer to its final resolved value, so every
// position can follow its own chain at once: one thread per position, in
// one launch. Chains are as deep as the number of segments the data was
// copied across (one hop per segment, by path compression).
//
// What bounds it: phase 1 is a serial walk per segment, latency-bound on
// the dependent marker and state loads of each token (global memory, L1
// and L2 resident: a 64 Ki-position segment's state is 256 KiB, more than
// an SM's shared memory), with one warp per SM in flight. The reference's
// PHASE2_CAP chunks of 2^22 positions give 64 segments, so at most 64 SMs
// work at a time. Phase 2 is a bandwidth-bound pass with short chains.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kKindLit = 1;
constexpr uint32_t kKindMatch = 2;
constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32)
    resolve_phase1(const uint32_t* __restrict__ markers,
                   uint32_t* state, int seg_len, int dist_bias) {
  const int lane = threadIdx.x;
  const int base = blockIdx.x * seg_len;
  const int end = base + seg_len;
  int pos = base;
  while (pos < end) {
    const int q = pos + lane;
    const bool valid = q < end;
    const uint32_t mk = valid ? markers[q] : 0u;
    const uint32_t kind = mk >> 28;
    if (valid)
      state[q] = kind == kKindLit ? ((uint32_t)q << 8) | (mk & 0xFFu)
                                  : (uint32_t)q << 8;
    const unsigned matches = __ballot_sync(kAll, valid && kind == kKindMatch);
    if (matches == 0) {
      pos += 32;
      continue;
    }
    const int first = __ffs(matches) - 1;
    const int p = pos + first;
    const uint32_t mkp = __shfl_sync(kAll, mk, first);
    const int len = (int)(mkp & 511u);
    const int dist = (int)((mkp >> 9) & 0xFFFFu) + dist_bias;
    __syncwarp();  // the window's literal state is visible to every lane
    if (dist <= 0 || len == 0) {  // corrupt marker: skip it
      pos = p + 1;
      continue;
    }
    const int n = min(len, end - p);
    for (int k = lane; k < n; k += 32) {
      const int dst = p + k;
      const int src = p - dist + k % dist;
      uint32_t entry;
      if (src < base) {
        entry = (uint32_t)max(src, 0) << 8;
      } else {
        const uint32_t s = state[src];
        entry = (s >> 8) == (uint32_t)src ? ((uint32_t)dst << 8) | (s & 0xFFu)
                                          : s & 0xFFFFFF00u;
      }
      state[dst] = entry;
    }
    __syncwarp();  // the copy is visible before the next window reads
    pos = p + n;
  }
}

__global__ void resolve_phase2(uint32_t* state, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t cur = state[i] >> 8;
  if (cur == (uint32_t)i) return;
  uint32_t s;
  for (;;) {  // targets strictly decrease, so this ends
    s = state[cur];
    const uint32_t nxt = s >> 8;
    if (nxt == cur) break;
    cur = nxt;
  }
  state[i] = ((uint32_t)i << 8) | (s & 0xFFu);
}

}  // namespace

// markers and state are [n_seg * seg_len] int32, with n_seg * seg_len <=
// 2^24; phase2 = 0 for a single segment (phase 1 alone resolves it).
// Returns a cudaError_t.
extern "C" int tpz_resolve_walk(const void* markers, void* state, int n_seg,
                                int seg_len, int dist_bias, int phase2,
                                cudaStream_t cuda_stream) {
  if (n_seg == 0 || seg_len == 0) return 0;
  resolve_phase1<<<n_seg, 32, 0, cuda_stream>>>(
      static_cast<const uint32_t*>(markers), static_cast<uint32_t*>(state),
      seg_len, dist_bias);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !phase2) return (int)err;
  const int n = n_seg * seg_len;
  resolve_phase2<<<(n + 255) / 256, 256, 0, cuda_stream>>>(
      static_cast<uint32_t*>(state), n);
  return (int)cudaGetLastError();
}
