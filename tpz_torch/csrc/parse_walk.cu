// Spec-v3 parse walk on Hopper: one CUDA thread per restart sub-walk.
//
// Replaces tpz/kernels/parse.py::parse_extend_pallas_v3y (and its XLA
// form parse_extend_v3z): the greedy/lazy LZSS parse with 4-byte match
// extension and the candidate-2 latch. The TPU version keeps per-chain
// SMEM windows refilled by DMA and writes marks into 128-lane rows; none
// of that carries over. Here each thread runs the same micro-step state
// machine (TOK / EXT / FIN, lazy probe at p + 1) as a scalar loop with
// its state in registers, reading:
//   - the precomputed mark w1 at q (and pk2 at q when a token saturates),
//   - two 4-byte words per EXT step (the position's and the candidate's),
// and storing one mark per emitted token at out[blk, p]. `out` arrives
// zeroed, so positions inside a match read 0, as in the reference.
//
// What bounds it: every step's load address depends on the previous
// step's result, so the walk is latency-bound (one L2 round trip per
// micro-step); a 64 KiB block's 98,816 words and marks sit in the 50 MB
// L2. The first design accepts few threads: NB * N / restart sub-walks
// (2,048 for 32 MiB at restart 16 KiB, about 16 per SM). Raising
// occupancy (a warp per sub-walk doing the compares in parallel, or
// smaller restart intervals) is later work.
//
// Layout: w1, pk2, out are [NB, N] int32; words is [NB, M] int32, the
// u32 little-endian 4-byte window at every haloed position (M-index =
// block position + window). block_len is [NB] int32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRaw = 1 << 30;

struct Params {
  int N, M, window, restart, max_match, screen_bytes, too_far, lazy,
      max_lazy, n_extend;
};

__device__ __forceinline__ int lzbytes(uint32_t x) {
  // Equal low-order bytes of a nonzero xor.
  return (__ffs(x) - 1) >> 3;
}

__global__ void parse_walk_v3(const int32_t* __restrict__ w1,
                              const int32_t* __restrict__ pk2,
                              const int32_t* __restrict__ words,
                              const int32_t* __restrict__ block_len,
                              int32_t* __restrict__ out, int NW, int nsub,
                              Params P) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= NW) return;
  const int blk = w / nsub;
  const int sub = w - blk * nsub;
  const int blen = block_len[blk];
  const int32_t* mrow = w1 + (size_t)blk * P.N;
  const int32_t* prow = pk2 + (size_t)blk * P.N;
  const uint32_t* wrow =
      reinterpret_cast<const uint32_t*>(words) + (size_t)blk * P.M;
  int32_t* orow = out + (size_t)blk * P.N;

  int p = sub * P.restart;
  const int pend = min((sub + 1) * P.restart, blen);
  // State, as in the reference's step_chain.
  bool ext = false;          // st: 0 TOK, 1 EXT
  int tgt = 0;               // 0: token at p; 1: lazy probe at p + 1
  int cand = 0, k = 0, j = 0, cap = 1, scap = 0;
  bool nz = false;
  int res1 = 0, jres1 = 0, s2v = -1, j2v = -1, ln0 = 0, dist0 = 0;

  while (p < pend) {
    const int q = p + tgt;
    int lnf, jf;
    bool nzv;
    if (!ext) {
      const int qc = min(q, P.N - 1);
      const int a = mrow[qc];
      const int apk = a & (kRaw - 1);
      if (!(a & kRaw)) {
        const int aln = apk & 1023;
        if (tgt == 0) {  // fast path: the precomputed mark is the token
          orow[p] = apk;
          p += max(aln - 1, 1);
          continue;
        }
        // Lazy probe over an unflagged mark: its pre-demotion length.
        const int ln1 = aln == 1 ? (apk >> 10) & 511 : aln - 1;
        const bool demote = ln1 > ln0;
        const int lnE = demote ? 0 : ln0;
        const int dE = demote ? 0 : dist0;
        orow[p] = (dE << 10) | (lnE + 1);
        p += max(lnE, 1);
        tgt = 0;
        continue;
      }
      // Raw screen word at q.
      const int ss1 = (apk & 63) - 1;
      const int jj1 = (apk >> 6) - 1;
      int cap_t = min(P.max_match, blen - q);
      cap_t = min(cap_t, P.restart - q % P.restart);
      const int scap_t = min(P.screen_bytes, cap_t);
      const bool no1 = jj1 < 0 || ss1 < 3;
      if (ss1 >= scap_t && jj1 >= 0) {  // saturated: extend candidate 1
        ext = true;
        cand = 1;
        k = ss1;
        j = jj1;
        cap = cap_t;
        scap = scap_t;
        nz = no1;
        if (P.n_extend >= 2) {
          const int b = prow[qc];
          s2v = (b & 63) - 1;
          j2v = (b >> 6) - 1;
        }
        continue;
      }
      lnf = ss1;
      jf = jj1;
      nzv = no1;
    } else {
      // EXT: one 4-byte compare step.
      const int ea = min(q + P.window + k, P.M - 1);
      const int eb = min(max(j + k, 0), P.M - 1);
      const uint32_t x = wrow[ea] ^ wrow[eb];
      if (x == 0 && k + 4 < cap) {
        k += 4;
        continue;
      }
      const int lnc = min(k + (x == 0 ? 4 : lzbytes(x)), cap);
      if (cand == 1) {
        if (j2v >= 0 && s2v >= scap && lnc < cap) {  // try candidate 2
          cand = 2;
          res1 = lnc;
          jres1 = j;
          k = s2v;
          j = j2v;
          continue;
        }
        lnf = lnc;
        jf = j;
      } else {
        lnf = max(lnc, res1);
        jf = lnc > res1 ? j : jres1;
      }
      nzv = nz;
      ext = false;
    }
    // FIN: rules, lazy, emit.
    if (nzv) lnf = 0;
    int distf = q + P.window - jf;
    if (lnf == 3 && distf > P.too_far) lnf = 0;
    if (lnf <= 0) distf = 0;
    if (P.lazy && tgt == 0 && lnf > 0 && lnf < P.max_lazy && p + 1 < blen) {
      tgt = 1;
      ln0 = lnf;
      dist0 = distf;
      continue;
    }
    int lnE = lnf, dE = distf;
    if (tgt == 1 && lnf > ln0) {
      lnE = 0;
      dE = 0;
    } else if (tgt == 1) {
      lnE = ln0;
      dE = dist0;
    }
    orow[p] = (dE << 10) | (lnE + 1);
    p += max(lnE, 1);
    tgt = 0;
  }
}

}  // namespace

extern "C" int tpz_parse_walk_v3(const int32_t* w1, const int32_t* pk2,
                                 const int32_t* words,
                                 const int32_t* block_len, int32_t* out,
                                 int NB, int N, int M, int window,
                                 int restart, int max_match, int screen_bytes,
                                 int too_far, int lazy, int max_lazy,
                                 int n_extend, cudaStream_t stream) {
  const int nsub = N / restart;
  const int NW = NB * nsub;
  if (NW == 0) return 0;
  const Params P{N, M, window, restart, max_match, screen_bytes, too_far,
                 lazy, max_lazy, n_extend};
  const int threads = 128;
  parse_walk_v3<<<(NW + threads - 1) / threads, threads, 0, stream>>>(
      w1, pk2, words, block_len, out, NW, nsub, P);
  return (int)cudaGetLastError();
}
