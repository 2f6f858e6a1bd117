// Spec-v1 parse walk on Hopper: one CUDA thread per block.
//
// Replaces tpz/kernels/parse.py::parse_extend_pallas (the LZHUF encoder's
// fused greedy parse and winner-match extension). Each thread walks its
// block from position 0: at p it takes the spec-v1 match length ln(p)
// (cpp/lzss.cc best_match with the too-far rule): the clamped 8-byte
// screen s of the winner candidate j; if s saturates (s >= 3 and
// s >= min(8, cap)) the match is extended by 4-byte compares of the two
// words while below cap = min(max_match, block_len - p); s < 3, a
// 3-byte match farther than too_far, or no candidate give a literal.
// With `lazy`, a match at p becomes a literal when ln(p + 1) > ln(p). The
// thread stores ln + 1 at every visited position and goes on at
// p + max(ln, 1) until p >= N, past block_len too, as the reference
// does. `out` arrives zeroed. The TPU version's 128-lane row caches and
// read-modify-writes do not carry over.
//
// What bounds it: the walk is serial within a block and every step's
// loads depend on the previous step's length, so it is latency-bound
// (a few dependent loads per token, more for long matches). Reads come
// from global memory; each block's rows are read in order, so they
// stream through L1 and L2. One thread per 32 KiB block is all the
// parallelism there is (1,024 threads for 32 MiB); blocks of 32 threads
// spread them over 32 SMs. Occupancy is left for later work.
//
// Layout: screen, best_j, out are [NB, N] int32; words is [NB, M] int32,
// the u32 little-endian 4-byte window at every haloed position (M-index
// = block position + window); block_len is [NB] int32. Word indices are
// clamped into the row, so a corrupt screen cannot read outside it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct Params {
  int N, M, window, max_match, too_far, lazy;
};

__device__ __forceinline__ int lzbytes(uint32_t x) {
  // Equal low-order bytes of a nonzero xor.
  return (__ffs(x) - 1) >> 3;
}

__device__ __forceinline__ int match_len(const int32_t* __restrict__ srow,
                                         const int32_t* __restrict__ jrow,
                                         const uint32_t* __restrict__ wrow,
                                         int p, int blen, const Params& P) {
  const int s = min(max(srow[p] + 1, 0), 9) - 1;
  const int j = jrow[p];
  const int cap = min(P.max_match, blen - p);
  int ln = s;
  if (s >= 3 && s >= min(8, cap)) {
    int k = s;
    while (k < cap) {
      const uint32_t x = wrow[min(max(p + P.window + k, 0), P.M - 1)] ^
                         wrow[min(max(j + k, 0), P.M - 1)];
      if (x != 0) {
        k = min(k + lzbytes(x), cap);
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

__global__ void parse_v1_walk(const int32_t* __restrict__ screen,
                              const int32_t* __restrict__ best_j,
                              const int32_t* __restrict__ words,
                              const int32_t* __restrict__ block_len,
                              int32_t* __restrict__ out, int NB, Params P) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= NB) return;
  const int blen = block_len[b];
  const int32_t* srow = screen + (size_t)b * P.N;
  const int32_t* jrow = best_j + (size_t)b * P.N;
  const uint32_t* wrow =
      reinterpret_cast<const uint32_t*>(words) + (size_t)b * P.M;
  int32_t* orow = out + (size_t)b * P.N;
  int p = 0;
  while (p < P.N) {
    int ln = match_len(srow, jrow, wrow, p, blen, P);
    if (P.lazy && ln > 0 && p + 1 < blen &&
        match_len(srow, jrow, wrow, p + 1, blen, P) > ln)
      ln = 0;
    orow[p] = ln + 1;
    p += max(ln, 1);
  }
}

}  // namespace

// screen, best_j [NB, N] int32, words [NB, M] int32, block_len [NB]
// int32, out [NB, N] int32 zeroed by the caller. Returns a cudaError_t.
extern "C" int tpz_parse_v1_walk(const void* screen, const void* best_j,
                                 const void* words, const void* block_len,
                                 void* out, int NB, int N, int M, int window,
                                 int max_match, int too_far, int lazy,
                                 cudaStream_t stream) {
  if (NB == 0) return 0;
  const Params P{N, M, window, max_match, too_far, lazy};
  const int threads = 32;
  parse_v1_walk<<<(NB + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const int32_t*>(screen), static_cast<const int32_t*>(best_j),
      static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(block_len), static_cast<int32_t*>(out), NB,
      P);
  return (int)cudaGetLastError();
}
