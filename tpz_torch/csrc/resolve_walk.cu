// LZ77 copy machine on Hopper: match resolution over the dense marker
// space of the DEFLATE and LZHUF decodes.
//
// Replaces tpz/kernels/resolve_walk.py::_phase_call (both phases) and
// computes resolve_copy_machine's final packed state: index << 8 | byte at
// every position. Entries are u32 (index << 8 needs 32 bits below 2^24);
// "resolved" means entry >> 8 == own index, otherwise the entry is a
// pointer target << 8. One launch covers a whole span of up to 2^24
// positions: the TPU's 2^22-position VMEM chunks do not carry over.
//
// Byte k of a match (start s, len, dist) reads s - dist + (k mod dist)
// (the reference's modular re-basing of self-overlap), which always lies
// before s. So every position's source is known from its token alone, and
// only the chains of copies of copies need resolving.
//
// Phase 1 (one CTA of 512 threads per segment of seg_len positions, the
// segment held in shared memory: 8 bytes a position, 64 KiB at the default
// 8,192). No walk in token order: the CTA's warps work on the whole
// segment at once.
//   A. The CTA stages the segment's markers (coalesced loads); each warp
//      notes the last token start (a literal or a match marker) in its
//      contiguous run of 32-position windows.
//   B. Each lane finds its position's token start by a ballot over its
//      window, carried from the warps and windows before it; the caller
//      injects a continuation marker at every segment cut, so no token
//      start lies before the segment. A match byte becomes a pointer to
//      its source: a local pointer when the source is in the segment,
//      else a pointer out of it (to max(src, 0)). Every other position
//      is resolved with its marker's low byte (a literal's byte; 0 for a
//      blank no match covers, as the plain version reads it).
//   C. Pointer jumping in shared memory: each local pointer takes its
//      target's entry, in rounds, until no local pointer is left (rounds
//      grow with log2 of the longest chain of copies inside the segment;
//      entries only move down their own chain, so the rounds work in
//      place). Every entry is then resolved or points before the segment,
//      path-compressed to the first source outside it.
//   D. Coalesced stores of the segment's packed state.
//
// Phase 2 (kChains positions a thread, their chains followed in lockstep
// so that as many loads are in flight; kPhase2Rounds launches). A pointer
// entry follows its chain for at most kPhase2Hops[r] hops, then stores
// what it reached (resolved, or a pointer further back). Entries change
// only along their own chain, so threads read each other's stores in
// place (through L2, where they land), and chains shorten for everyone. A round that starts after one
// that left nothing pending returns at once; the last round has no hop
// limit and always finishes. Each hop crosses at least one segment, so a
// chain is at most as deep as the segments behind it (2,048 at the
// default for 2^24 positions, e.g. a run of zeros whose every segment
// copies the byte before it); the two bounded rounds with their in-place
// compression bring that down to a few hops for the last.
//
// What bounds it: phase 1 moves 8 bytes a position (markers in, state
// out) and resolves in shared memory with no serial walk; phase 2 reads
// the state once more, then pays one dependent load a hop, and its warps
// wait for their longest chain. On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py) a 16 MiB gzip span takes ~0.39 ms, phase 2 ~0.3 of it,
// against a 0.04 ms bound by bytes. The segment length trades phase 1's
// shared memory (so CTAs in flight per SM: three at 8,192) against phase
// 2: shorter segments leave more bytes whose source lies outside their
// segment and longer cross-segment chains (there 4,096 and 16,384 were
// 3% and 9% slower than 8,192).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr uint32_t kKindLit = 1;
constexpr uint32_t kKindMatch = 2;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Phase 1's shared-memory entry: kDone | byte (resolved), kOut | global
// target (a source before the segment), else a local pointer.
constexpr uint32_t kDone = 0x80000000u;
constexpr uint32_t kOut = 0x40000000u;
constexpr int kPhase2Threads = 256;
constexpr int kChains = 4;  // positions (chains in flight) a thread
constexpr int kPhase2Rounds = 3;
constexpr int kPhase2Hops[kPhase2Rounds] = {64, 64, 0};  // 0: no limit

__global__ void __launch_bounds__(kThreads, 3)
    resolve_phase1(const uint32_t* __restrict__ markers,
                   uint32_t* __restrict__ state, int seg_len, int dist_bias) {
  extern __shared__ uint32_t smem[];
  uint32_t* mk = smem;            // [seg_len] markers
  uint32_t* st = smem + seg_len;  // [seg_len] entries
  __shared__ int warp_last[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * seg_len;
  const int nwin = seg_len >> 5;
  const int per_warp = (nwin + kWarps - 1) / kWarps;
  const int w0 = min(warp * per_warp, nwin);
  const int w1 = min(w0 + per_warp, nwin);

  // A: stage the markers (independent coalesced loads, several in flight
  // a thread), then each warp's last token start.
#pragma unroll 8
  for (int i = threadIdx.x; i < seg_len; i += kThreads)
    mk[i] = markers[base + i];
  __syncthreads();
  int last = -1;
  for (int w = w0; w < w1; ++w) {
    const uint32_t kind = mk[(w << 5) + lane] >> 28;
    const unsigned starts =
        __ballot_sync(kAll, kind == kKindLit || kind == kKindMatch);
    if (starts) last = (w << 5) + 31 - __clz(starts);
  }
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();

  // B: token starts and each position's first entry.
  int carry = lane < warp ? warp_last[lane] : -1;
  for (int o = 16; o; o >>= 1)
    carry = max(carry, __shfl_xor_sync(kAll, carry, o));
  for (int w = w0; w < w1; ++w) {
    const int i = (w << 5) + lane;
    const uint32_t m = mk[i];
    const uint32_t kind = m >> 28;
    const unsigned starts =
        __ballot_sync(kAll, kind == kKindLit || kind == kKindMatch);
    const unsigned upto = starts & (kAll >> (31 - lane));
    const int s = upto ? (w << 5) + 31 - __clz(upto) : carry;
    if (starts) carry = (w << 5) + 31 - __clz(starts);
    uint32_t e = kDone | (m & 0xFFu);
    if (s >= 0) {
      const uint32_t ms = mk[s];
      const int len = (int)(ms & 511u);
      const int dist = (int)((ms >> 9) & 0xFFFFu) + dist_bias;
      const int k = i - s;
      if ((ms >> 28) == kKindMatch && dist > 0 && k < len) {
        const int src = s - dist + k % dist;
        e = src >= 0 ? (uint32_t)src : kOut | (uint32_t)max(base + src, 0);
      }
    }
    st[i] = e;
  }
  __syncthreads();

  // C: pointer jumping over the local pointers.
  for (;;) {
    int pending = 0;
    for (int i = threadIdx.x; i < seg_len; i += kThreads) {
      const uint32_t e = st[i];
      if (e < kOut) {
        const uint32_t f = st[e];
        st[i] = f;
        pending |= f < kOut;
      }
    }
    if (!__syncthreads_or(pending)) break;
  }

  // D: the packed state.
  for (int i = threadIdx.x; i < seg_len; i += kThreads) {
    const uint32_t e = st[i];
    const uint32_t g = (uint32_t)(base + i);
    state[g] = (e & kDone) ? (g << 8) | (e & 0xFFu) : (e & (kOut - 1)) << 8;
  }
}

__global__ void __launch_bounds__(kPhase2Threads)
    resolve_phase2(uint32_t* state, int n, int hops, int* pending,
                   int round) {
  if (round > 0 && *(volatile int*)&pending[round - 1] == 0) return;
  const int base = blockIdx.x * kPhase2Threads * kChains + threadIdx.x;
  int idx[kChains];
  uint32_t cur[kChains];
  bool live[kChains];
#pragma unroll
  for (int u = 0; u < kChains; ++u) {
    idx[u] = base + u * kPhase2Threads;
    live[u] = idx[u] < n;
    cur[u] = live[u] ? state[idx[u]] >> 8 : 0;
    live[u] = live[u] && cur[u] != (uint32_t)idx[u];
  }
  int left = 0;
  for (int h = 1;; ++h) {  // targets strictly decrease, so this ends
    uint32_t s[kChains];
#pragma unroll
    for (int u = 0; u < kChains; ++u)
      if (live[u]) s[u] = __ldcg(&state[cur[u]]);
    bool any = false;
#pragma unroll
    for (int u = 0; u < kChains; ++u) {
      if (!live[u]) continue;
      const uint32_t nxt = s[u] >> 8;
      if (nxt == cur[u]) {
        state[idx[u]] = ((uint32_t)idx[u] << 8) | (s[u] & 0xFFu);
        live[u] = false;
      } else if (h == hops) {
        state[idx[u]] = nxt << 8;
        live[u] = false;
        ++left;
      } else {
        cur[u] = nxt;
        any = true;
      }
    }
    if (!any) break;
  }
  left = __reduce_add_sync(kAll, left);
  if (left && (threadIdx.x & 31) == 0) atomicAdd(&pending[round], left);
}

}  // namespace

// markers and state are [n_seg * seg_len] int32, with n_seg * seg_len <=
// 2^24 and seg_len a multiple of 32 whose 8 * seg_len bytes fit one CTA's
// shared memory; pending is [3] int32, zeroed by the caller. Returns a
// cudaError_t.
extern "C" int tpz_resolve_walk(const void* markers, void* state,
                                void* pending, int n_seg, int seg_len,
                                int dist_bias, cudaStream_t cuda_stream) {
  if (n_seg == 0 || seg_len == 0) return 0;
  const int smem = 2 * seg_len * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      resolve_phase1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  resolve_phase1<<<n_seg, kThreads, smem, cuda_stream>>>(
      static_cast<const uint32_t*>(markers), static_cast<uint32_t*>(state),
      seg_len, dist_bias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = n_seg * seg_len;
  for (int r = 0; r < kPhase2Rounds; ++r) {
    const int per_block = kPhase2Threads * kChains;
    resolve_phase2<<<(n + per_block - 1) / per_block, kPhase2Threads, 0,
                     cuda_stream>>>(
        static_cast<uint32_t*>(state), n, kPhase2Hops[r],
        static_cast<int*>(pending), r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
