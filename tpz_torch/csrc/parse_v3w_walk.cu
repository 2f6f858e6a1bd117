// Interleaved spec-v3 parse walk on Hopper: one CUDA thread per restart
// sub-walk.
//
// Replaces tpz/kernels/parse.py::parse_extend_pallas_v3w. That walk runs
// the spec-v3 greedy/lazy parse as a state machine that reads the RAW
// screen words: TOK unpacks the candidate (len | (j + 1) << 6) of pk1 at
// q = p + tgt, EXT extends a saturated candidate by 4-byte compares, FIN
// applies the min-match and too-far rules and the one-step lazy probe at
// p + 1, then emits (dist << 10) | (len + 1) at p. Unlike #1
// (parse_walk.cu) there is no precomputed mark and no fast path: every
// token goes through TOK. v3w never loads its second candidate (s2v and
// j2v stay 0 while the cap is at least 1, so its candidate-2 branch is
// never taken; R4), so the kernel has no candidate-2 state.
//
// The TPU version advances W = nblk * N / restart sub-walks one micro-step
// per loop trip inside one kernel body, so their dynamic VMEM row reads
// pipeline; each sub-walk keeps its output row in a register. None of that
// carries over: here each sub-walk is a thread with its state in
// registers, reading pk1 and words from global memory and storing one
// mark per token into the zeroed output.
//
// What bounds it: every micro-step's load address depends on the previous
// step, so a sub-walk is latency-bound (one L2 round trip per token or
// compare); NB * N / restart threads (2,048 for 32 MiB at restart 16 KiB)
// hide little of it.
//
// Layout: pk1, out [NB, N] int32; words [NB, M] int32, the u32 4-byte
// window at every haloed position (M-index = block position + window);
// block_len [NB] int32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

struct Params {
  int N, M, window, restart, max_match, screen_bytes, too_far, lazy,
      max_lazy;
};

__device__ __forceinline__ int lzbytes(uint32_t x) {
  // Equal low-order bytes of a nonzero xor.
  return (__ffs(x) - 1) >> 3;
}

__global__ void parse_v3w_walk(const int32_t* __restrict__ pk1,
                               const int32_t* __restrict__ words,
                               const int32_t* __restrict__ block_len,
                               int32_t* __restrict__ out, int NW, int nsub,
                               Params P) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= NW) return;
  const int blk = w / nsub;
  const int sub = w - blk * nsub;
  const int blen = block_len[blk];
  const int32_t* prow = pk1 + (size_t)blk * P.N;
  const uint32_t* wrow =
      reinterpret_cast<const uint32_t*>(words) + (size_t)blk * P.M;
  int32_t* orow = out + (size_t)blk * P.N;

  int p = sub * P.restart;
  const int pend = min((sub + 1) * P.restart, blen);
  // State, as in the reference's step_chain.
  bool ext = false;          // st: 0 TOK, 1 EXT
  int tgt = 0;               // 0: token at p; 1: lazy probe at p + 1
  int k = 0, j = 0, cap = 1;
  bool nz = false;
  int ln0 = 0, dist0 = 0;

  while (p < pend) {
    const int q = p + tgt;
    int lnf, jf;
    bool nzv;
    if (!ext) {
      // TOK: the raw screen word at q.
      const int a = prow[min(q, P.N - 1)];
      const int ss1 = (a & 63) - 1;
      const int jj1 = (a >> 6) - 1;
      int cap_t = min(P.max_match, blen - q);
      cap_t = min(cap_t, P.restart - q % P.restart);
      const int scap_t = min(P.screen_bytes, cap_t);
      const bool no1 = jj1 < 0 || ss1 < 3;
      if (ss1 >= scap_t && jj1 >= 0) {  // saturated: extend the candidate
        ext = true;
        k = ss1;
        j = jj1;
        cap = cap_t;
        nz = no1;
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
      lnf = min(k + (x == 0 ? 4 : lzbytes(x)), cap);
      jf = j;
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
    if (tgt == 1) {
      const bool demote = lnf > ln0;
      lnE = demote ? 0 : ln0;
      dE = demote ? 0 : dist0;
    }
    orow[p] = (dE << 10) | (lnE + 1);
    p += max(lnE, 1);
    tgt = 0;
  }
}

}  // namespace

extern "C" int tpz_parse_v3w_walk(const int32_t* pk1, const int32_t* words,
                                  const int32_t* block_len, int32_t* out,
                                  int NB, int N, int M, int window,
                                  int restart, int max_match,
                                  int screen_bytes, int too_far, int lazy,
                                  int max_lazy, cudaStream_t stream) {
  const int nsub = N / restart;
  const int NW = NB * nsub;
  if (NW == 0) return 0;
  const Params P{N, M, window, restart, max_match, screen_bytes, too_far,
                 lazy, max_lazy};
  const int threads = 128;
  parse_v3w_walk<<<(NW + threads - 1) / threads, threads, 0, stream>>>(
      pk1, words, block_len, out, NW, nsub, P);
  return (int)cudaGetLastError();
}
