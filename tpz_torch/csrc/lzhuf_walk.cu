// LZHUF (LHA lh4-lh7) token walk on Hopper: one CUDA block per segment;
// L lanes walk it from guessed bit offsets, each at D phases, the lanes
// are stitched in order, then each lane stores its own.
//
// Replaces tpz/kernels/lzhuf_walk.py::_walk (the Pallas walk) and
// computes what its lane-parallel twin _walk_vz computes: each segment
// decodes its MSB-first token stream from bit body_bit_local with the
// segment's fused tables [c L1 4096 | c L2 4096 | p L1 4096 | p L2 4096]
// (entries sym << 5 | code length; 12-bit level 1, a length of 31
// escapes into the 32-entry level-2 chunk at entry >> 5; constant-code
// tables hold 0-bit entries), and stores one marker per token at
// out[seg, out_pos], from out_pos = start_pos (the carried match's
// length) until out_len: 1 << 28 | byte for a literal, 2 << 28 |
// (dist - 1) << 9 | len for a match, len = c symbol - 253 and dist - 1 =
// the p code c (0 or 1), or 2^(c-1) | (c - 1 raw bits). Every other
// position of the row reads 0 (positions inside a match, before
// start_pos and from out_len on): the kernel writes the whole row, and
// the resolve depends on the zeros. The TPU version's SMEM stream window,
// DMA refills and 128-lane row read-modify-writes do not carry over.
//
// The walk's state between tokens is (bit position, output position)
// and nothing else, and the host indexer cuts segments at every table
// change, so the segment's bits can be cut into L lane ranges [g_k,
// g_k+1) (guesses spread over [body bit, end bit); the end-bit hint
// places them) and walked at once, if each lane knows where the true walk
// enters its range: at the first true token start at or past g_k. That
// entry is unknown until the lanes before it are walked, but it lies
// within one token of g_k: at most 26 bits past it on the lh5 headline
// of chip_smoke.py and 22 on lh7 (phase 9; a match's c code, p code and
// raw bits straddling g_k), a literal's code on incompressible data.
// Walks from wrong bits do not reliably fall into step with the true walk
// (a stream of 8-bit literal codes keeps its phase mod 8 forever), so the
// lanes do not speculate on meeting it. Instead:
//   staging  the block zeroes its output row, stages the segment's tables
//            narrowed to 16 bits (an escape keeps its level-2 chunk index;
//            a row with an entry that does not fit is read from global
//            memory instead) and its slice up to the end-bit hint; later
//            words (read only past a wrong hint) come through L1
//   pass A   D phase walks a lane (threads k * D + d): walk d decodes from
//            bit g_k + d, without storing, until its next token would
//            start at or past g_k+1 or its output count reaches what the
//            segment can hold; it keeps its exit bit and count
//   stitch   thread 0 composes the lanes in order: the true walk enters
//            lane k at x; where x - g_k < D, phase walk x - g_k started
//            exactly there, so its exit and count are the true walk's
//            (one lookup); otherwise (a longer token straddles g_k) thread
//            0 walks lane k's range itself (the slow route, exact)
//   pass C   thread k re-decodes lane k's range from its true entry and
//            output position and stores the markers (the last lane goes
//            on until the walk ends)
// The result never depends on the guesses, the hint, L or D: they only
// decide how much of the walk goes the slow route and where its loads
// come from. lzhuf_walk.last_stats in kernels/lzhuf_walk.py counts the
// lane boundaries each route resolved and the largest entry offset.
//
// What bounds it: each token is a chain of dependent shared-memory loads
// (stream words, c L1, maybe c L2, p L1, maybe p L2, raw bits), so a
// walk is latency-bound; the D phase walks of a lane run side by side in
// a warp's threads and cost issue slots, not latency. A block's time is
// about two lane ranges of tokens (pass A, pass C) plus the slow route's
// ranges.
// Shared memory: 32 KiB of 16-bit tables, 4 SW bytes of slice, 8 L D
// bytes of phase exits and 16 L bytes of lane state
// (lzhuf_walk.shared_bytes; tpz_lzhuf_walk_occupancy gives the blocks
// resident per SM).
//
// Corrupt input: the word index is clamped to [0, SW - 3] and the level-2
// indices to the table row, so no load leaves the slice or the row; the
// loop ends because every token advances out_pos by at least 1. The host
// token indexer has already walked these exact bits, so valid streams
// never need the clamps.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBlock = 65536;
constexpr int kL1Bits = 12;
constexpr int kL1W = 1 << kL1Bits;
constexpr int kL2Cap = 4096;
constexpr int kTW = 2 * (kL1W + kL2Cap);
constexpr int kOC2 = kL1W;
constexpr int kOP1 = kL1W + kL2Cap;
constexpr int kOP2 = 2 * kL1W + kL2Cap;
constexpr int kMaxThreads = 1024;

// n bits (MSB first) starting sh + off bits into the 96-bit big-endian
// window (w0, w1, w2). A shift by 32 is undefined in C++, hence the
// s2 > 0 test and the & 31; n == 0 gives 0.
__device__ __forceinline__ uint32_t bits_at(uint32_t w0, uint32_t w1,
                                            uint32_t w2, int sh, int off,
                                            int n) {
  const int b = sh + off;
  const int wi = b >> 5;
  const int s2 = b & 31;
  const uint32_t lo = wi == 0 ? w0 : (wi == 1 ? w1 : w2);
  const uint32_t hi = wi == 0 ? w1 : (wi == 1 ? w2 : 0u);
  uint32_t v = lo << s2;
  if (s2 > 0) v |= hi >> ((32 - s2) & 31);
  return n > 0 ? v >> ((32 - n) & 31) : 0u;
}

// A table entry in 16 bits, or 0x10000 when it does not fit: an escape
// keeps its level-2 chunk index (offset / 32).
__device__ __forceinline__ uint32_t narrow(uint32_t e) {
  if ((e & 31) != 31) return e < 0x10000u ? e : 0x10000u;
  return ((e >> 5) & 31) == 0 && (e >> 10) < 2048 ? ((e >> 10) << 5) | 31
                                                  : 0x10000u;
}

struct Seg {
  const uint16_t* t16;  // narrowed tables in shared memory, or null
  const uint32_t* tg;   // the row's tables in global memory
  const uint32_t* s;    // the staged words, in shared memory
  const uint32_t* sg;   // the slice, in global memory
  int ns, SW;
};

__device__ __forceinline__ uint32_t entry(const Seg& sg, int i) {
  if (sg.t16 != nullptr) {
    const uint32_t v = sg.t16[i];
    return (v & 31) == 31 ? ((v >> 5) << 10) | 31u : v;
  }
  return __ldg(sg.tg + i);
}

__device__ __forceinline__ uint32_t word(const Seg& sg, int i) {
  return i < sg.ns ? sg.s[i] : __ldg(sg.sg + i);
}

// n bits (1 <= n <= 32, off + n <= 64) at off of the 64-bit window.
__device__ __forceinline__ uint32_t peek(uint64_t win, int off, int n) {
  return (uint32_t)((win << off) >> (64 - n));
}

// Decode-table lookup at bit off of the window: a level-1 entry, or the
// level-2 entry it escapes to (the 5 bits after the 12 peeked ones).
__device__ __forceinline__ uint32_t lookup(const Seg& sg, int l1, int l2,
                                           uint64_t win, int off) {
  const uint32_t e = entry(sg, l1 + (int)peek(win, off, kL1Bits));
  if ((e & 31) != 31) return e;
  const int i = l2 + (int)(e >> 5) + (int)peek(win, off + kL1Bits, 5);
  return entry(sg, min(i, kTW - 1));
}

struct Token {
  int nbits, nout;
  int32_t mark;
};

// The token at bitpos, as the serial walk decodes it. The lookups read
// the 64 bits from bitpos (a code is at most 31 bits, so both tables'
// peeks lie inside them); the raw bits do too unless the p code asks for
// more than a valid table holds, and then come from the 96-bit window as
// the serial walk reads them.
__device__ __forceinline__ Token decode(const Seg& sg, int bitpos) {
  const int wc = min(max(bitpos >> 5, 0), sg.SW - 3);
  const uint32_t w0 = word(sg, wc), w1 = word(sg, wc + 1),
                 w2 = word(sg, wc + 2);
  const int sh = bitpos & 31;
  uint64_t win = ((uint64_t)w0 << 32 | w1) << sh;
  if (sh > 0) win |= w2 >> (32 - sh);
  const uint32_t e = lookup(sg, 0, kOC2, win, 0);
  const int clen = (int)(e & 31);
  const uint32_t csym = e >> 5;
  if (csym < 256) return {clen, 1, (int32_t)((1u << 28) | csym)};
  const int mlen = (int)min(csym - 253u, 258u);  // csym >= 256: >= 3
  const uint32_t pe = lookup(sg, kOP1, kOP2, win, clen);
  const int plen = (int)(pe & 31);
  const uint32_t pc = pe >> 5;
  const int raw_n = pc > 1 ? (int)pc - 1 : 0;
  const int at = clen + plen;
  const uint32_t raw =
      raw_n == 0 ? 0u
      : raw_n <= 32 && at + raw_n <= 64 ? peek(win, at, raw_n)
                                        : bits_at(w0, w1, w2, sh, at, raw_n);
  const uint32_t pval = pc > 1 ? (raw_n < 32 ? (1u << raw_n) : 0u) | raw
                               : pc;
  return {at + raw_n, mlen,
          (int32_t)((2u << 28) | (pval << 9) | (uint32_t)mlen)};
}

// The walk from token start x with output count n through a range that
// ends at bit `end`: until its next token would start at or past `end`,
// or its count reaches `cap`.
__device__ __forceinline__ void walk(const Seg& sg, int end, int cap, int& x,
                                     int& n) {
  while (x < end && n < cap) {
    const Token t = decode(sg, x);
    x += t.nbits;
    n += t.nout;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    lzhuf_walk_kernel(const uint32_t* __restrict__ stream,
                      const int32_t* __restrict__ body_bit,
                      const int32_t* __restrict__ out_len,
                      const int32_t* __restrict__ start_pos,
                      const uint32_t* __restrict__ tab,
                      const int32_t* __restrict__ walk_end_bit,
                      int32_t* __restrict__ out, int32_t* __restrict__ stats,
                      int SW, int L, int D) {
  extern __shared__ uint32_t smem[];
  uint16_t* t16 = reinterpret_cast<uint16_t*>(smem);     // [kTW]
  uint32_t* s_s = smem + kTW / 2;                        // [SW] slice
  int* wex = reinterpret_cast<int*>(s_s + SW);           // [L][D] exits
  int* wcnt = wex + L * D;                               // [L][D] counts
  int* g = wcnt + L * D;                                 // [L + 1] guesses
  int* T = g + L + 1;                                    // [L] true entry
  int* O = T + L;                                        // [L] its output
  int* own = O + L;                                      // [L] lane is live

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int olen = min(out_len[c], kBlock);
  const int start = start_pos[c];
  int32_t* orow = out + (size_t)c * kBlock;
  // The whole row reads 0 but at the markers pass C stores after the
  // barriers below.
  int4* orow4 = reinterpret_cast<int4*>(orow);
  for (int i = t; i < kBlock / 4; i += blockDim.x)
    orow4[i] = make_int4(0, 0, 0, 0);
  if (start >= olen) return;

  const int lo = body_bit[c];
  int hi = SW * 32;
  int ns = SW;  // words staged: the slice up to the hint
  if (walk_end_bit != nullptr) {
    const int h = walk_end_bit[c];
    if (h > lo && h <= hi) {
      hi = h;
      ns = min(SW, (h >> 5) + 3);
    }
  }
  const uint32_t* trow = tab + (size_t)c * kTW;
  const uint32_t* srow = stream + (size_t)c * SW;
  int wide = 0;
  for (int i = t; i < kTW; i += blockDim.x) {
    const uint32_t v = narrow(trow[i]);
    wide |= v >> 16;
    t16[i] = (uint16_t)v;
  }
  for (int i = t; i < ns; i += blockDim.x) s_s[i] = srow[i];
  const long long span = max(hi - lo, 0);
  if (t < L) g[t] = lo + (int)(span * t / L);
  if (t == 0) g[L] = max(hi, lo);
  wide = __syncthreads_or(wide);

  const Seg sg{wide ? nullptr : t16, trow, s_s, srow, ns, SW};
  const int cap = olen - start;  // outputs the segment can hold

  // Pass A: phase walk d of lane k.
  {
    const int k = t / D, d = t - k * D;
    int x = g[k] + d, n = 0;
    walk(sg, g[k + 1], cap, x, n);
    wex[t] = x;
    wcnt[t] = n;
  }
  __syncthreads();

  // The stitch, by thread 0.
  if (t == 0) {
    int direct = 0, serial = 0, far = 0;
    int x = lo, o = 0;
    bool alive = true;
    for (int k = 0; k < L; ++k) {
      own[k] = alive;
      if (!alive) continue;
      T[k] = x;
      O[k] = o;
      const int d = x - g[k];
      far = max(far, d);
      int n = o;
      if (d >= 0 && d < D) {
        x = wex[k * D + d];
        n += wcnt[k * D + d];
        ++direct;
      } else {
        walk(sg, g[k + 1], cap, x, n);
        ++serial;
      }
      o = n;
      if (o >= cap) alive = false;
    }
    if (stats != nullptr) {
      atomicAdd(stats, direct);
      atomicAdd(stats + 1, serial);
      atomicMax(stats + 2, far);
    }
  }
  __syncthreads();

  // Pass C: thread k stores the markers of lane k's range.
  if (t < L && own[t]) {
    const int end = t + 1 < L ? g[t + 1] : INT_MAX;
    int x = T[t], pos = start + O[t];
    while (x < end && pos < olen) {
      const Token tok = decode(sg, x);
      orow[pos] = tok.mark;
      x += tok.nbits;
      pos += tok.nout;
    }
  }
}

size_t shared_bytes(int L, int D, int SW) {
  return (size_t)kTW * 2 + (size_t)SW * 4 + (size_t)8 * L * D +
         (size_t)4 * (4 * L + 1);
}

}  // namespace

// stream [NB, SW] big-endian u32 words, body_bit / out_len / start_pos
// [NB] int32, tab [NB, 16384] u32, walk_end_bit [NB] int32 or null (a
// hint), out [NB, 65536] int32 (every position written), stats [3] int32
// or null (lane boundaries resolved by a phase walk, walked by the slow
// route, added to; the largest entry offset past a guess, maxed). L lanes
// of D phase walks, L * D threads in [1, 1024]. Returns a cudaError_t.
extern "C" int tpz_lzhuf_walk(const void* stream, const void* body_bit,
                              const void* out_len, const void* start_pos,
                              const void* tab, const void* walk_end_bit,
                              void* out, void* stats, int NB, int SW, int L,
                              int D, cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  if (L < 1 || D < 1 || L * D > kMaxThreads || SW < 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(L, D, SW);
  cudaError_t err = cudaFuncSetAttribute(
      lzhuf_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lzhuf_walk_kernel<<<NB, L * D, smem, cuda_stream>>>(
      static_cast<const uint32_t*>(stream),
      static_cast<const int32_t*>(body_bit),
      static_cast<const int32_t*>(out_len),
      static_cast<const int32_t*>(start_pos),
      static_cast<const uint32_t*>(tab),
      static_cast<const int32_t*>(walk_end_bit), static_cast<int32_t*>(out),
      static_cast<int32_t*>(stats), SW, L, D);
  return (int)cudaGetLastError();
}

// Blocks of the token walk resident per SM at L lanes, D phase walks and
// slices of SW words (0 where the configuration does not fit).
extern "C" int tpz_lzhuf_walk_occupancy(int L, int D, int SW) {
  if (L < 1 || D < 1 || L * D > kMaxThreads) return 0;
  const size_t smem = shared_bytes(L, D, SW);
  if (cudaFuncSetAttribute(lzhuf_walk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lzhuf_walk_kernel, L * D, smem) != cudaSuccess)
    return 0;
  return blocks;
}
