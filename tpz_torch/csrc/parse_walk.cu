// Spec-v3 parse walk on Hopper: one CUDA block per restart sub-walk,
// tokens at every position in parallel, then a walk through shared memory.
// Two forms of one templated body: parse_walk_v3 (#1) and parse_walk_v3w
// (#9).
//
// parse_walk_v3 replaces tpz/kernels/parse.py::parse_extend_pallas_v3y
// (and its XLA form parse_extend_v3z): the greedy/lazy LZSS parse with
// 4-byte match extension and the candidate-2 latch, over independent
// sub-walks of `restart` positions (restart = N: one walk a block). The
// walk of a sub-walk visits p from its start, emits the token at p and
// goes on at p + max(lnE, 1) while p < pend = min(sub-walk end,
// block_len); it does not go on past block_len. The outputs hold the
// token's mark (dE << 10) | (lnE + 1) at visited positions and 0
// elsewhere, as visited = mark & 1023, mlen = max(visited - 1, 0), mdist =
// mark >> 10 where mlen > 0.
//
// parse_walk_v3w replaces tpz/kernels/parse.py::parse_extend_pallas_v3w,
// the interleaved walk, which computes the same parse from the raw screen
// words with two differences: its cap at q is derived from q,
// min(max_match, block_len - q, restart - q mod restart), where #1 reads
// cap_at; and it never loads candidate 2 (R4), so it is #1 at n_extend =
// 1. The template's kV3w form takes the cap from q in the saturation test
// too, and reads neither cap_at nor pk2 (the wrapper passes no rows for
// them). The TPU version interleaves W sub-walks a micro-step at a time in
// one kernel body so that their VMEM reads pipeline; none of that carries
// over.
//
// Why the token at p is a function of p alone. The TOK / EXT / FIN
// machine of the serial walk (parse_extend_v3z's micro-steps) carries
// nothing from one token to the next: every state variable is set when
// the token at p begins, from loads at p and p + 1 only.
//   - The mark w1(q) (_v3_marks) is a function of the screen words at q
//     and q + 1, the cap (cap_at; v3w: derived from q) and block_len:
//     the saturated screen, the too-far
//     rule, and with `lazy` the demotion against the unsaturated
//     neighbour's length, or the RAW flag for a saturated q or neighbour.
//   - An unflagged mark is the token (the fast path).
//   - A flagged one runs the extension at q = p: candidate 1's 4-byte
//     compares from its screen length up to the cap min(max_match,
//     block_len - q, restart - q % restart), then candidate 2 (pk2 at q)
//     when n_extend >= 2 and candidate 1 falls short of the cap; s2v and
//     j2v are reloaded at every extension. The nz, too-far and zero-
//     distance rules then give (lnf, distf) at q.
//   - The lazy probe (lnf in (0, max_lazy) and p + 1 < block_len) reads
//     the length at q = p + 1, by its mark or by the same extension at
//     p + 1 (cap and candidates of p + 1, which may lie in the next
//     sub-walk: its length counts as the serial walk reads it), and
//     demotes p to a literal when that is longer.
// So only the choice of positions is serial. The design:
//   (a) the block's 512 threads compute, for every position p < pend of
//       the sub-walk, the token the walk would emit there: the step
//       max(lnE, 1) into shared memory (16 bits) and the mark into
//       `mdist`, used as scratch. Loads of neighbouring positions (pk1,
//       cap_at, the side-a words) are coalesced; a thread reads p + 1 and
//       p + 2 itself for the probe, so a block needs nothing past its
//       range from another block;
//   (b) warp 0 walks p -> p + step from the sub-walk's start to pend in
//       shared memory: 32 chunk walks from guessed starts, put in order by
//       lane 0 (chunk_walk.cuh, shared with parse_v1_walk.cu and
//       reach_walk.cu);
//   (c) the threads write visited, mlen and mdist in coalesced rows from
//       the visited bits and the scratch marks.
// A block a sub-walk (2,048 blocks at 2 x 16 MiB, restart 16 KiB) rather
// than a block a parse block: four times the blocks in flight, and the
// steps of 16 KiB positions (32 KiB) leave room for three blocks of 512
// threads an SM (__launch_bounds__ holds the registers to it).
// Shared memory: 2 bytes a position and the visited bits,
// parse_v3_shared_bytes(restart) in kernels/parse.py (34 KiB at 16,384;
// 136 KiB at restart 0 with N = 65,536, one block an SM), which both
// wrappers check against the limit before any launch.
//
// What bounds it: (a), which extends every saturated position, the
// walk's or not, and at a probe extends p + 1 as well: a long match costs
// its length in compares at each of its positions, each trip of them a
// round trip to L1 or L2, so a thread's positions are latency-bound; the
// trips take four compares at once, and 1,536 threads an SM overlap
// them. (b) is a chain of dependent shared-memory loads, one load and one
// add a token, 32 chunks at once; the old design paid
// a chain of dependent global loads (one L2 round trip a micro-step),
// one thread a sub-walk. The bound in chip_smoke.py counts the serial
// walk's work: its tokens, its extension compares and the bytes.
//
// Layout: pk1, pk2, cap_at, visited, mlen, mdist are [NB, N] int32 (the
// v3w form reads no pk2 or cap_at); words is [NB, M] int32, the u32
// little-endian 4-byte window at every haloed position (M-index = block
// position + window); block_len is [NB] int32. Word indices are clamped
// into the row as in the serial walk.

#include <cuda_runtime.h>
#include <cstdint>

#include "chunk_walk.cuh"

namespace {

constexpr int kRaw = 1 << 30;
constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // extension compares a trip

struct Params {
  int N, M, window, restart, max_match, screen_bytes, too_far, lazy,
      max_lazy, n_extend;
};

struct Rows {
  const int32_t* pk1;
  const int32_t* pk2;
  const int32_t* cap_at;
  const uint32_t* words;
  int blen;
};

__device__ __forceinline__ int lzbytes(uint32_t x) {
  // Equal low-order bytes of a nonzero xor.
  return (__ffs(x) - 1) >> 3;
}

__device__ __forceinline__ int shl10(int x) {
  return (int)((uint32_t)x << 10);
}

// The cap at q: cap_at's, or in the v3w form the one v3w derives from q,
// min(max_match, block_len - q, restart - q mod restart).
template <bool kV3w>
__device__ __forceinline__ int cap_of(const Rows& R, int q, const Params& P) {
  if (kV3w)
    return min(min(P.max_match, R.blen - q), P.restart - q % P.restart);
  return R.cap_at[q];
}

// The screen's length at q after the no-candidate and too-far rules
// (_v3_marks' lnp), its distance (distp) and whether it saturates (satp).
template <bool kV3w>
__device__ __forceinline__ void screen_at(const Rows& R, int q,
                                          const Params& P, int& ln,
                                          int& dist, bool& sat) {
  const int pk = R.pk1[q];
  const int ss1 = (pk & 63) - 1;
  const int jj1 = (pk >> 6) - 1;
  sat = ss1 >= min(cap_of<kV3w>(R, q, P), P.screen_bytes) && jj1 >= 0;
  ln = (jj1 < 0 || ss1 < 3) ? 0 : ss1;
  dist = q + P.window - jj1;
  if (ln == 3 && dist > P.too_far) ln = 0;
  if (ln <= 0) dist = 0;
}

// _v3_marks at q (0 <= q < N).
template <bool kV3w>
__device__ int mark_at(const Rows& R, int q, const Params& P) {
  int ln, dist;
  bool sat;
  screen_at<kV3w>(R, q, P, ln, dist, sat);
  bool demote = false, flagged = sat;
  if (P.lazy) {
    int ln1 = 0, d1;
    bool sat1 = false;
    if (q + 1 < P.N) screen_at<kV3w>(R, q + 1, P, ln1, d1, sat1);
    const bool probe = ln > 0 && ln < P.max_lazy && q + 1 < R.blen;
    demote = probe && !sat1 && ln1 > ln;
    flagged = sat || (probe && sat1);
  }
  if (flagged) return R.pk1[q] | kRaw;
  return (demote || ln == 0) ? shl10(ln) | 1 : shl10(dist) | (ln + 1);
}

// Candidate j's match at q, from k equal bytes up to cap: 4-byte
// compares, kUnroll a trip, their loads issued together (a compare
// counts only when the ones before it found 4 equal bytes short of the
// cap, as one compare a trip).
__device__ int extend(const uint32_t* __restrict__ wrow, int q, int k, int j,
                      int cap, const Params& P) {
  const int a0 = q + P.window;
  while (true) {
    uint32_t x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x[u] = wrow[min(a0 + k + 4 * u, P.M - 1)] ^
             wrow[min(max(j + k + 4 * u, 0), P.M - 1)];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (x[u] != 0 || k + 4 >= cap)
        return min(k + (x[u] == 0 ? 4 : lzbytes(x[u])), cap);
      k += 4;
    }
  }
}

// A flagged position q (raw screen word apk, pk2 read at qc): the
// serial walk's TOK, EXT and FIN without the lazy rule. Gives (lnf, distf).
// The v3w form never extends candidate 2.
template <bool kV3w>
__device__ void full_at(const Rows& R, int q, int qc, int apk,
                        const Params& P, int& lnf, int& distf) {
  const int ss1 = (apk & 63) - 1;
  const int jj1 = (apk >> 6) - 1;
  int cap = min(P.max_match, R.blen - q);
  cap = min(cap, P.restart - q % P.restart);
  const int scap = min(P.screen_bytes, cap);
  int jf = jj1;
  lnf = ss1;
  if (ss1 >= scap && jj1 >= 0) {
    const int ln1 = extend(R.words, q, ss1, jj1, cap, P);
    lnf = ln1;
    if (!kV3w && P.n_extend >= 2) {
      const int b = R.pk2[qc];
      const int s2v = (b & 63) - 1;
      const int j2v = (b >> 6) - 1;
      if (j2v >= 0 && s2v >= scap && ln1 < cap) {
        const int ln2 = extend(R.words, q, s2v, j2v, cap, P);
        lnf = max(ln2, ln1);
        jf = ln2 > ln1 ? j2v : jj1;
      }
    }
  }
  if (jj1 < 0 || ss1 < 3) lnf = 0;
  distf = q + P.window - jf;
  if (lnf == 3 && distf > P.too_far) lnf = 0;
  if (lnf <= 0) distf = 0;
}

// The token the walk emits at p (p < pend): its mark, and its step.
template <bool kV3w>
__device__ int token_at(const Rows& R, int p, const Params& P, int& step) {
  const int a = mark_at<kV3w>(R, p, P);
  const int apk = a & (kRaw - 1);
  if (!(a & kRaw)) {
    step = max((apk & 1023) - 1, 1);
    return apk;
  }
  int lnE, dE;
  full_at<kV3w>(R, p, p, apk, P, lnE, dE);
  if (P.lazy && lnE > 0 && lnE < P.max_lazy && p + 1 < R.blen) {
    const int q = p + 1;
    const int qc = min(q, P.N - 1);
    const int a1 = mark_at<kV3w>(R, qc, P);
    const int apk1 = a1 & (kRaw - 1);
    int ln1, d1;
    if (!(a1 & kRaw)) {
      const int aln = apk1 & 1023;
      ln1 = aln == 1 ? (apk1 >> 10) & 511 : aln - 1;
    } else {
      full_at<kV3w>(R, q, qc, apk1, P, ln1, d1);
    }
    if (ln1 > lnE) lnE = dE = 0;
  }
  step = max(lnE, 1);
  return shl10(dE) | (lnE + 1);
}

// The kernel body: a block a sub-walk, (a) to (c) above.
template <bool kV3w>
__device__ __forceinline__ void walk_body(
    const int32_t* __restrict__ pk1, const int32_t* __restrict__ pk2,
    const int32_t* __restrict__ cap_at, const int32_t* __restrict__ words,
    const int32_t* __restrict__ block_len, int32_t* __restrict__ visited,
    int32_t* __restrict__ mlen, int32_t* __restrict__ mdist, int nsub,
    const Params& P) {
  extern __shared__ uint32_t smem[];
  const int R = P.restart;
  const int nvis = (R + 31) >> 5;
  uint32_t* vis = smem;                                        // [nvis]
  uint16_t* code = reinterpret_cast<uint16_t*>(smem + nvis);  // [R]
  __shared__ int chunk_exit[32];
  const int blk = blockIdx.x / nsub;
  const int r0 = (blockIdx.x - blk * nsub) * R;
  const size_t row = (size_t)blk * P.N;
  const Rows rows{pk1 + row, kV3w ? nullptr : pk2 + row,
                  kV3w ? nullptr : cap_at + row,
                  reinterpret_cast<const uint32_t*>(words) +
                      (size_t)blk * P.M,
                  block_len[blk]};
  const int n = max(min(R, rows.blen - r0), 0);  // pend - r0
  int32_t* srow = mdist + row + r0;  // the marks' scratch

  // (a) the token at every position of the sub-walk below pend.
  for (int i = threadIdx.x; i < nvis; i += kThreads) vis[i] = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    int step;
    srow[i] = token_at<kV3w>(rows, r0 + i, P, step);
    code[i] = (uint16_t)step;
  }
  __syncthreads();

  // (b) the walk, by warp 0.
  if (threadIdx.x < 32)
    chunk_walk::walk(code, 0xFFFF, vis, chunk_exit, n, threadIdx.x);
  __syncthreads();

  // (c) the output rows.
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int m = i < n && chunk_walk::visited(vis, i) ? srow[i] : 0;
    const int v = m & 1023;
    const int ln = max(v - 1, 0);
    visited[row + r0 + i] = v;
    mlen[row + r0 + i] = ln;
    srow[i] = ln > 0 ? m >> 10 : 0;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    parse_walk_v3(const int32_t* __restrict__ pk1,
                  const int32_t* __restrict__ pk2,
                  const int32_t* __restrict__ cap_at,
                  const int32_t* __restrict__ words,
                  const int32_t* __restrict__ block_len,
                  int32_t* __restrict__ visited, int32_t* __restrict__ mlen,
                  int32_t* __restrict__ mdist, int nsub, Params P) {
  walk_body<false>(pk1, pk2, cap_at, words, block_len, visited, mlen, mdist,
                   nsub, P);
}

// The v3w form (#9): the cap derived from q, no candidate 2.
__global__ void __launch_bounds__(kThreads, 3)
    parse_walk_v3w(const int32_t* __restrict__ pk1,
                   const int32_t* __restrict__ words,
                   const int32_t* __restrict__ block_len,
                   int32_t* __restrict__ visited, int32_t* __restrict__ mlen,
                   int32_t* __restrict__ mdist, int nsub, Params P) {
  walk_body<true>(pk1, nullptr, nullptr, words, block_len, visited, mlen,
                  mdist, nsub, P);
}

// The dynamic shared memory of a block for sub-walks of `restart`
// positions: the visited bits and a 16-bit step a position.
int shared_bytes(int restart) {
  return 4 * ((restart + 31) / 32) + 2 * restart;
}

}  // namespace

// pk1, pk2, cap_at [NB, N] int32, words [NB, M] int32, block_len [NB]
// int32; visited, mlen, mdist [NB, N] int32 (every position written).
// restart divides N; the caller checks that its shared memory fits.
// Returns a cudaError_t.
extern "C" int tpz_parse_walk_v3(const void* pk1, const void* pk2,
                                 const void* cap_at, const void* words,
                                 const void* block_len, void* visited,
                                 void* mlen, void* mdist, int NB, int N,
                                 int M, int window, int restart,
                                 int max_match, int screen_bytes, int too_far,
                                 int lazy, int max_lazy, int n_extend,
                                 cudaStream_t stream) {
  const int nsub = N / restart;
  if (NB == 0 || nsub == 0) return 0;
  const Params P{N, M, window, restart, max_match, screen_bytes, too_far,
                 lazy, max_lazy, n_extend};
  const int smem = shared_bytes(restart);
  cudaError_t err = cudaFuncSetAttribute(
      parse_walk_v3, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  parse_walk_v3<<<NB * nsub, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(pk1), static_cast<const int32_t*>(pk2),
      static_cast<const int32_t*>(cap_at), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(block_len), static_cast<int32_t*>(visited),
      static_cast<int32_t*>(mlen), static_cast<int32_t*>(mdist), nsub, P);
  return (int)cudaGetLastError();
}

// The v3w form: pk1 [NB, N] int32, words [NB, M] int32, block_len [NB]
// int32; visited, mlen, mdist [NB, N] int32 (every position written).
// restart divides N; the caller checks that its shared memory fits.
// Returns a cudaError_t.
extern "C" int tpz_parse_v3w_walk(const void* pk1, const void* words,
                                  const void* block_len, void* visited,
                                  void* mlen, void* mdist, int NB, int N,
                                  int M, int window, int restart,
                                  int max_match, int screen_bytes,
                                  int too_far, int lazy, int max_lazy,
                                  cudaStream_t stream) {
  const int nsub = N / restart;
  if (NB == 0 || nsub == 0) return 0;
  const Params P{N, M, window, restart, max_match, screen_bytes, too_far,
                 lazy, max_lazy, 1};
  const int smem = shared_bytes(restart);
  cudaError_t err = cudaFuncSetAttribute(
      parse_walk_v3w, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  parse_walk_v3w<<<NB * nsub, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(pk1), static_cast<const int32_t*>(words),
      static_cast<const int32_t*>(block_len), static_cast<int32_t*>(visited),
      static_cast<int32_t*>(mlen), static_cast<int32_t*>(mdist), nsub, P);
  return (int)cudaGetLastError();
}
