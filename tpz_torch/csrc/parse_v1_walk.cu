// Spec-v1 parse walk on Hopper: one CUDA block per block of the parse,
// lengths in parallel, then a walk through shared memory.
//
// Replaces tpz/kernels/parse.py::parse_extend_pallas (the LZHUF encoder's
// fused greedy parse and winner-match extension). At p the walk takes the
// spec-v1 match length ln(p) (cpp/lzss.cc best_match with the too-far
// rule): the clamped 8-byte screen s of the winner candidate j; if s
// saturates (s >= 3 and s >= min(8, cap)) the match is extended by 4-byte
// compares of the two words while below cap = min(max_match, block_len -
// p); s < 3, a 3-byte match farther than too_far, or no candidate give a
// literal. With `lazy`, a match at p becomes a literal when ln(p + 1) >
// ln(p). The walk stores ln + 1 at every visited position and goes on at
// p + max(ln, 1) until p >= N, past block_len too, as the reference does;
// every other position of `out` gets 0.
//
// ln(p) depends on p alone; only the choice of positions is serial. So:
//   (a) the block's 512 threads compute ln' (ln after the lazy rule, whose
//       ln(p + 1) the same thread computes) at every position (p, p + 512,
//       ...: the screen, candidate and side-a word loads are coalesced
//       across neighbouring positions) into shared memory as 16 bits: the
//       step max(ln', 1), with kZero for ln' = 0 and kAtCap for ln' = cap
//       <= 0 (a saturated screen at or past block_len, where ln is the
//       negative cap);
//   (b) warp 0 walks p -> p + step through shared memory, one load and
//       one add a token, as 32 chunk walks from guessed starts that lane
//       0 then puts in order (chunk_walk.cuh, shared with parse_walk.cu);
//   (c) all threads write `out` and `mlen` in coalesced rows: ln' + 1
//       where visited, 0 elsewhere, and max(out - 1, 0).
// Shared memory: 2 bytes a position plus the visited bits, 68 KiB at N =
// 32,768 (parse_v1_shared_bytes in kernels/parse.py, which checks N
// against the limit before any launch).
//
// What bounds it: (a) reads the screen and candidate rows and the words
// its extensions compare (mostly from L2: the shared memory leaves L1
// little room), and extends at every position, the walk's or not; (b)
// is a chain of dependent shared-memory loads, one load and one add a
// token, 32 chunks at once, where the TPU-shaped walk paid dependent
// global loads. Three blocks fit an SM (shared memory, and
// __launch_bounds__ holds the registers to it), so one block's walk
// overlaps the others' (a) and (c). On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py) the lh5 headline (NB = 1,024) takes ~0.9 ms against a
// 0.21 ms bound by bytes; the work of (a) at positions the walk skips is
// not part of the bound.
//
// Layout: screen, best_j, out are [NB, N] int32; words is [NB, M] int32,
// the u32 little-endian 4-byte window at every haloed position (M-index
// = block position + window); block_len is [NB] int32. Word indices are
// clamped into the row, so a corrupt screen cannot read outside it.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunk_walk.cuh"

namespace {

struct Params {
  int N, M, window, max_match, too_far, lazy;
};

constexpr int kThreads = 512;
constexpr int kBatch = 4;
constexpr uint16_t kAtCap = 0x8000;  // ln' = min(max_match, blen - p) <= 0
constexpr uint16_t kZero = 0x4000;   // ln' = 0
constexpr uint16_t kStep = 0x3FFF;   // max(ln', 1); max_match < 2^14

__device__ __forceinline__ int lzbytes(uint32_t x) {
  // Equal low-order bytes of a nonzero xor.
  return (__ffs(x) - 1) >> 3;
}

// A word of the row; indices are clamped into it.
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ wrow,
                                         int m, const Params& P) {
  return wrow[min(max(m, 0), P.M - 1)];
}

// ln(p) from p's screen word sw and winner j.
__device__ __forceinline__ int match_len(int sw, int j,
                                         const uint32_t* __restrict__ wrow,
                                         int p, int blen, const Params& P) {
  const int s = min(max(sw + 1, 0), 9) - 1;
  const int cap = min(P.max_match, blen - p);
  int ln = s;
  if (s >= 3 && s >= min(8, cap)) {
    // Two compares a trip: the second (at k + 4) counts only when the
    // first found 4 equal bytes short of the cap, as one compare a trip.
    int k = s;
    while (k < cap) {
      const uint32_t x0 = word(wrow, p + P.window + k, P) ^ word(wrow, j + k, P);
      const uint32_t x1 =
          word(wrow, p + P.window + k + 4, P) ^ word(wrow, j + k + 4, P);
      if (x0 != 0) {
        k = min(k + lzbytes(x0), cap);
        break;
      }
      k = min(k + 4, cap);
      if (k >= cap) break;
      if (x1 != 0) {
        k = min(k + lzbytes(x1), cap);
        break;
      }
      k = min(k + 4, cap);
    }
    ln = min(k, cap);
  }
  if (s < 3) ln = 0;
  if (ln == 3 && p + P.window - j > P.too_far) ln = 0;
  if (j < 0) ln = 0;
  return ln;
}

// ln' back from its 16-bit code.
__device__ __forceinline__ int decoded(uint16_t c, int p, int blen,
                                       const Params& P) {
  return (c & kAtCap) ? min(P.max_match, blen - p)
                      : (c & kZero) ? 0 : (int)(c & kStep);
}

__global__ void __launch_bounds__(kThreads, 3)
    parse_v1_walk(const int32_t* __restrict__ screen,
                  const int32_t* __restrict__ best_j,
                  const int32_t* __restrict__ words,
                  const int32_t* __restrict__ block_len,
                  int32_t* __restrict__ out, int32_t* __restrict__ mlen,
                  Params P) {
  extern __shared__ uint32_t smem[];
  const int nvis = (P.N + 31) >> 5;
  uint32_t* vis = smem;                                        // [nvis]
  uint16_t* code = reinterpret_cast<uint16_t*>(smem + nvis);  // [N]
  const int b = blockIdx.x;
  const int blen = block_len[b];
  const int32_t* srow = screen + (size_t)b * P.N;
  const int32_t* jrow = best_j + (size_t)b * P.N;
  const uint32_t* wrow =
      reinterpret_cast<const uint32_t*>(words) + (size_t)b * P.M;
  int32_t* orow = out + (size_t)b * P.N;
  int32_t* lrow = mlen + (size_t)b * P.N;
  __shared__ int chunk_exit[32];

  // (a) every position's length, after the lazy rule. The screen and
  // candidate loads of kBatch positions are issued together.
  for (int i = threadIdx.x; i < nvis; i += kThreads) vis[i] = 0;
  for (int p0 = threadIdx.x; p0 < P.N; p0 += kBatch * kThreads) {
    int sw[kBatch], jj[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      sw[u] = p < P.N ? srow[p] : -1;
      jj[u] = p < P.N ? jrow[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      if (p >= P.N) break;
      int ln = match_len(sw[u], jj[u], wrow, p, blen, P);
      if (P.lazy && ln > 0 && p + 1 < blen && p + 1 < P.N &&
          match_len(srow[p + 1], jrow[p + 1], wrow, p + 1, blen, P) > ln)
        ln = 0;
      code[p] = ln < 0 ? (uint16_t)(kAtCap | 1)
                       : ln == 0 ? (uint16_t)(kZero | 1) : (uint16_t)ln;
    }
  }
  __syncthreads();

  // (b) the walk, by warp 0: 32 chunk walks from guessed starts, put in
  // order by lane 0 (chunk_walk.cuh).
  if (threadIdx.x < 32)
    chunk_walk::walk(code, kStep, vis, chunk_exit, P.N, threadIdx.x);
  __syncthreads();

  // (c) the output rows.
  for (int p = threadIdx.x; p < P.N; p += kThreads) {
    const int r =
        chunk_walk::visited(vis, p) ? decoded(code[p], p, blen, P) + 1 : 0;
    orow[p] = r;
    lrow[p] = max(r - 1, 0);
  }
}

}  // namespace

// screen, best_j [NB, N] int32, words [NB, M] int32, block_len [NB]
// int32, out and mlen [NB, N] int32 (every position written). The caller checks
// that N fits one CUDA block's shared memory and that max_match < 2^14.
// Returns a cudaError_t.
extern "C" int tpz_parse_v1_walk(const void* screen, const void* best_j,
                                 const void* words, const void* block_len,
                                 void* out, void* mlen, int NB, int N, int M,
                                 int window,
                                 int max_match, int too_far, int lazy,
                                 cudaStream_t stream) {
  if (NB == 0 || N == 0) return 0;
  const Params P{N, M, window, max_match, too_far, lazy};
  const int smem = 4 * ((N + 31) / 32) + 2 * N;
  cudaError_t err = cudaFuncSetAttribute(
      parse_v1_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  parse_v1_walk<<<NB, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(screen), static_cast<const int32_t*>(best_j),
      static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(block_len), static_cast<int32_t*>(out),
      static_cast<int32_t*>(mlen), P);
  return (int)cudaGetLastError();
}
