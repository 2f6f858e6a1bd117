// DEFLATE symbol walk on Hopper: one CUDA block per block or segment
// chain; L lanes decode it from guessed bit offsets, the pieces are
// stitched in lane order, then each lane emits its own.
//
// Replaces tpz/kernels/inflate_pipeline.py::_symbol_walk (the Pallas walk)
// and computes what its lane-parallel twin _symbol_walk_vz computes: each
// chain Huffman-decodes its entry's symbol stream from bit
// body_bit_local, with the two-level tables (10-bit L1, 32-entry L2
// chunks, escape = code length 31), and stores one marker per token at
// out[chain, out_pos]: 1 << 28 | byte for a literal, 2 << 28 | dist << 9
// | len for a match, until an invalid symbol or distance code, symbol 256,
// or out_pos >= out_len. `out` arrives zeroed: positions inside a match
// read 0, and the resolve depends on it. The TPU version's SMEM stream
// windows, DMA refills and 128-lane row read-modify-writes do not carry
// over.
//
// The walk's state between tokens is (bit position, output position) and
// nothing else, and a token's decode reads only its bit position. So two
// decodes that reach one bit position at a token start are one decode
// from there on, up to a constant output offset; and a Huffman decode
// started at a wrong bit falls into step with the true one within a few
// tokens. The design:
//   staging  the block's 256 threads copy the chain's 28 KiB of tables and
//            its stream slice (72 KiB at SW = 18,432 words) into shared
//            memory; then the L lanes' warps alone go on.
//   pass A   lane k starts at a guess g_k, spread evenly over the chain's
//            bits [body bit, end bit) (walk_end_bit, a hint: the slice's
//            end without it; lane 0 starts at the true body bit), decodes
//            without storing, and records the bit position and running
//            output count of its first E token starts, until its next
//            token would start at or past g_{k+1}, an invalid symbol, or
//            its output count reaching what the chain can hold.
//   pass B   lane k - 1 goes on from its own exit into lane k's range and
//            compares its token starts with lane k's list: where they
//            meet, lane k's exit and count hold from there, shifted by
//            the difference. Where they do not meet within lane k's E
//            recorded starts, lane k - 1 carries the walk through lane k's
//            whole range (the slow route: exact, and in parallel with the
//            other lanes' pass B).
//   stitch   lane 0 composes the transitions in lane order (a serial scan
//            of L entries): a lane's true start is the true exit of the
//            lane before. Where the true entry is not the exit that pass
//            B started from (lane k - 1 itself did not meet), or lane k
//            stopped early on its output count, lane 0 carries the true
//            walk through lane k's range itself (serially). Where the
//            true walk ends (an invalid symbol, or the output count),
//            later lanes own nothing.
//   pass C   each lane re-decodes its confirmed range from its true start
//            and output position and stores the markers (the last lane
//            goes on until the walk ends).
// The result never depends on the guesses, nor on E: they only decide how
// much of the walk goes the slow route. A speculative lane past the true
// end leaves no trace (passes A and B store only to shared memory).
// symbol_walk.last_stats in kernels/inflate_pipeline.py counts the lane
// boundaries each route resolved.
//
// What bounds it: each token is a chain of about six dependent shared-
// memory loads and bit extractions (peek, L1, maybe L2, length extra,
// distance L1/L2, distance extra), so a lane is latency-bound; the design
// runs L of them a chain, each over ~1/L of it twice (A and C), plus the
// tokens of B until the walks meet (a whole range where they do not).
// The lanes of a warp run in step, so a warp pays for its slowest lane's
// tokens and for both sides of a literal/match branch. L
// (inflate_pipeline.SPEC_LANES) trades those passes against the stitch's
// serial scan; E (SPEC_RECORDS) trades shared memory (L x E x 8 bytes,
// 8 KiB at 128 x 8, so that two chains still fit an SM next to their 100
// KiB of tables and slice) against how late a lane may fall into step
// before its boundary takes the slow route: a short range gains less
// from a late meeting, so more lanes need fewer records. chip_smoke.py
// times the headline's walk at three such pairs (PERF.md).
//
// Corrupt streams: the reference's clamps are kept (word index <= SW - 3,
// length index 0..28, distance index 0..29, L2 index inside the table),
// and an invalid symbol ends the chain, so no load leaves the slice or
// the table; the CRC or Adler-32 check rejects the output.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kBlock = 65536;
constexpr int kL1Bits = 10;
constexpr uint32_t kL1Mask = (1u << kL1Bits) - 1;
constexpr int kThreads = 256;
constexpr int kMaxLanes = kThreads;
constexpr int kMaxRec = 64;

// Why a lane's pass A stopped.
constexpr int kRange = 0, kInvalid = 1, kCap = 2;
// How a walk continued into a lane's range ended.
constexpr int kMet = 0, kThrough = 1, kEnded = 2, kNone = 3;

// Bits [sh + off, sh + off + n) of the 96-bit little-endian window
// (w0, w1, w2). A shift by 32 is undefined in C++, hence the s2 > 0 test
// and the & 31; n == 0 gives 0.
__device__ __forceinline__ uint32_t bits_at(uint32_t w0, uint32_t w1,
                                            uint32_t w2, int sh, int off,
                                            int n) {
  const int b = sh + off;
  const int wi = b >> 5;
  const int s2 = b & 31;
  const uint32_t lo = wi == 0 ? w0 : (wi == 1 ? w1 : w2);
  const uint32_t hi = wi == 0 ? w1 : (wi == 1 ? w2 : 0u);
  uint32_t v = lo >> s2;
  if (s2 > 0) v |= hi << ((32 - s2) & 31);
  return n > 0 ? v & (0xFFFFFFFFu >> ((32 - n) & 31)) : 0u;
}

struct Chain {
  const uint32_t* s;  // the slice, in shared memory
  const uint32_t* t;  // the fused tables, in shared memory
  const int *lb, *le, *db, *de;
  int SW, TW, odist1;
};

struct Token {
  bool ok;
  int nbits, nout;
  int32_t mark;
};

// The token at bitpos, as the serial walk decodes it.
__device__ __forceinline__ Token decode(const Chain& ch, int bitpos) {
  const int wc = min(max(bitpos >> 5, 0), ch.SW - 3);
  const uint32_t w0 = ch.s[wc], w1 = ch.s[wc + 1], w2 = ch.s[wc + 2];
  const int sh = bitpos & 31;
  Token tok{false, 0, 0, 0};

  const uint32_t peek = bits_at(w0, w1, w2, sh, 0, 15);
  uint32_t e = ch.t[peek & kL1Mask];
  if ((e & 31) == 31)
    e = ch.t[min((1 << kL1Bits) + (int)(e >> 5) +
                     (int)((peek >> kL1Bits) & 31),
                 ch.TW - 1)];
  const int clen = e & 31;
  const int sym = (int)(e >> 5);
  if (clen == 0 || sym == 256 || sym > 285) return tok;  // invalid
  if (sym < 256) {
    tok = {true, clen, 1, (int32_t)((1u << 28) | (uint32_t)sym)};
    return tok;
  }
  const int li = min(sym - 257, 28);
  const int eb = ch.le[li];
  const int lval = ch.lb[li] + (int)bits_at(w0, w1, w2, sh, clen, eb);
  const uint32_t pk = bits_at(w0, w1, w2, sh, clen + eb, 15);
  uint32_t e2 = ch.t[ch.odist1 + (int)(pk & kL1Mask)];
  if ((e2 & 31) == 31)
    e2 = ch.t[min(ch.odist1 + (1 << kL1Bits) + (int)(e2 >> 5) +
                      (int)((pk >> kL1Bits) & 31),
                  ch.TW - 1)];
  const int dlen = e2 & 31;
  if (dlen == 0) return tok;  // invalid distance code
  const int ds = min((int)(e2 >> 5), 29);
  const int deb = ch.de[ds];
  const int dval =
      ch.db[ds] + (int)bits_at(w0, w1, w2, sh, clen + eb + dlen, deb);
  tok = {true, clen + eb + dlen + deb, lval,
         (int32_t)((2u << 28) | ((uint32_t)dval << 9) | (uint32_t)lval)};
  return tok;
}

// A walk at token start x with output count c, continued into a lane's
// range (ending at bit `end`) against that lane's recorded starts rbit[0,
// nrec) from index i: kMet when it lands on rbit[i], kThrough when its
// next start is at or past `end`, kEnded on an invalid token or a count
// of `cap`. Past the last record it can no longer meet, and goes on to
// the range's end (the slow route).
__device__ int carry(const Chain& ch, const int* rbit, int nrec, int end,
                     int cap, int& x, int& c, int& i) {
  while (true) {
    if (x >= end) return kThrough;
    while (i < nrec && rbit[i] < x) ++i;
    if (i < nrec && rbit[i] == x) return kMet;
    if (c >= cap) return kEnded;
    const Token t = decode(ch, x);
    if (!t.ok) return kEnded;
    x += t.nbits;
    c += t.nout;
  }
}

// Barrier 1 for the first n threads of the block (the lanes' warps).
__device__ __forceinline__ void lanes_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

__global__ void __launch_bounds__(kThreads)
    symbol_walk_kernel(const uint32_t* __restrict__ stream,
                       const int32_t* __restrict__ body_bit,
                       const int32_t* __restrict__ out_len,
                       const uint32_t* __restrict__ tab,
                       const int32_t* __restrict__ len_base,
                       const int32_t* __restrict__ len_extra,
                       const int32_t* __restrict__ dist_base,
                       const int32_t* __restrict__ dist_extra,
                       const int32_t* __restrict__ start_pos,
                       const int32_t* __restrict__ walk_end_bit,
                       int32_t* __restrict__ out, int32_t* __restrict__ stats,
                       int SW, int TW, int lit_tw, int L, int E) {
  extern __shared__ uint32_t smem[];
  uint32_t* t_s = smem;                                      // [TW] tables
  uint32_t* s_s = smem + TW;                                 // [SW] slice
  int* rbit = reinterpret_cast<int*>(smem + TW + SW);        // [L][E]
  int* rcnt = rbit + L * E;                                  // [L][E]
  __shared__ int lb[29], le[29], db[30], de[30];
  // Pass A per lane: guess g (g[L] = end of the guesses), exit bit,
  // count, records, stop; pass B per lane k (from lane k - 1's exit):
  // kind, exit, count, record index; the stitch's starts.
  __shared__ int g[kMaxLanes + 1], ex[kMaxLanes], cnt[kMaxLanes],
      nrec[kMaxLanes], stop[kMaxLanes];
  __shared__ int bkind[kMaxLanes], bx[kMaxLanes], bc[kMaxLanes],
      bi[kMaxLanes];
  __shared__ int T[kMaxLanes], O[kMaxLanes], own[kMaxLanes];

  const int c = blockIdx.x;
  const int olen = min(out_len[c], kBlock);
  const int start = start_pos[c];
  if (start >= olen) return;  // stored block or empty entry: whole block

  for (int i = threadIdx.x; i < TW; i += blockDim.x)
    t_s[i] = tab[(size_t)c * TW + i];
  for (int i = threadIdx.x; i < SW; i += blockDim.x)
    s_s[i] = stream[(size_t)c * SW + i];
  if (threadIdx.x < 29) {
    lb[threadIdx.x] = len_base[threadIdx.x];
    le[threadIdx.x] = len_extra[threadIdx.x];
  }
  if (threadIdx.x < 30) {
    db[threadIdx.x] = dist_base[threadIdx.x];
    de[threadIdx.x] = dist_extra[threadIdx.x];
  }
  __syncthreads();
  // The lanes' warps go on; they meet at barrier 1.
  const int nthreads = (L + 31) & ~31;
  if (threadIdx.x >= nthreads) return;
  const int k = threadIdx.x;
  const bool lane = k < L;
  const Chain ch{s_s, t_s, lb, le, db, de, SW, TW, lit_tw};
  const int cap = olen - start;  // outputs the chain can hold
  const int lo = body_bit[c];
  int hi = SW * 32;
  if (walk_end_bit != nullptr) {
    const int h = walk_end_bit[c];
    if (h > lo && h <= hi) hi = h;
  }
  const long long span = max(hi - lo, 0);
  if (lane) g[k] = lo + (int)(span * k / L);
  if (k == 0) g[L] = max(hi, lo);
  lanes_sync(nthreads);

  // Pass A.
  int* my_bit = rbit + k * E;
  int* my_cnt = rcnt + k * E;
  if (lane) {
    const int end = g[k + 1];
    int x = g[k], n = 0, r = 0, why = kRange;
    while (x < end) {
      if (n >= cap) {
        why = kCap;
        break;
      }
      const Token t = decode(ch, x);
      if (!t.ok) {
        why = kInvalid;
        break;
      }
      if (r < E) {
        my_bit[r] = x;
        my_cnt[r] = n;
        ++r;
      }
      x += t.nbits;
      n += t.nout;
    }
    ex[k] = x;
    cnt[k] = n;
    nrec[k] = r;
    stop[k] = why;
  }
  lanes_sync(nthreads);

  // Pass B: lane k - 1 into lane k's range.
  if (k + 1 < L) {
    const int j = k + 1;
    int kind = kNone, x = ex[k], n = 0, i = 0;
    if (stop[k] == kRange)
      kind = carry(ch, rbit + j * E, nrec[j], g[j + 1], cap, x, n, i);
    bkind[j] = kind;
    bx[j] = x;
    bc[j] = n;
    bi[j] = i;
  }
  lanes_sync(nthreads);

  // The stitch, by lane 0.
  if (k == 0) {
    int met = 0, through = 0, serial = 0;
    int x = ex[0], o = cnt[0];
    bool alive = stop[0] == kRange && o < cap;
    T[0] = lo;
    O[0] = 0;
    own[0] = 1;
    for (int j = 1; j < L; ++j) {
      own[j] = alive;
      if (!alive) continue;
      T[j] = x;
      O[j] = o;
      const int* jb = rbit + j * E;
      int kind, i = 0, n = o;
      if (x == ex[j - 1] && bkind[j] != kNone) {
        kind = bkind[j];
        x = bx[j];
        n = o + bc[j];
        i = bi[j];
        ++(kind == kMet ? met : through);
      } else {
        kind = carry(ch, jb, nrec[j], g[j + 1], cap, x, n, i);
        ++serial;
      }
      if (kind == kMet) {
        n += cnt[j] - rcnt[j * E + i];
        x = ex[j];
        if (stop[j] == kInvalid) {
          alive = false;
        } else if (stop[j] == kCap && n < cap) {
          // Lane j stopped on its own count, the true walk has not: it
          // goes on from lane j's exit, matching nothing.
          i = nrec[j];
          kind = carry(ch, jb, nrec[j], g[j + 1], cap, x, n, i);
        }
      }
      if (kind == kEnded) alive = false;
      o = n;
      if (o >= cap) alive = false;
    }
    if (stats != nullptr) {
      atomicAdd(stats, met);
      atomicAdd(stats + 1, through);
      atomicAdd(stats + 2, serial);
    }
  }
  lanes_sync(nthreads);

  // Pass C: every lane stores the markers of its confirmed range.
  if (lane && own[k]) {
    int32_t* orow = out + (size_t)c * kBlock;
    const int end = k + 1 < L ? g[k + 1] : INT_MAX;
    int x = T[k], pos = start + O[k];
    while (x < end && pos < olen) {
      const Token t = decode(ch, x);
      if (!t.ok) break;
      orow[pos] = t.mark;
      x += t.nbits;
      pos += t.nout;
    }
  }
}

}  // namespace

// stream [NB, SW] u32 words, tab [NB, TW] u32, body_bit / out_len /
// start_pos [NB] int32, len/dist base and extra [29]/[30] int32,
// walk_end_bit [NB] int32 or null (a hint), out [NB, 65536] int32 zeroed
// by the caller, stats [3] int32 or null (lane boundaries met in pass B,
// carried through their range in pass B without meeting, re-walked in
// the stitch; added to). L lanes in [1, 256], E records in [1, 64].
// Returns a cudaError_t.
extern "C" int tpz_symbol_walk(const void* stream, const void* body_bit,
                               const void* out_len, const void* tab,
                               const void* len_base, const void* len_extra,
                               const void* dist_base, const void* dist_extra,
                               const void* start_pos, const void* walk_end_bit,
                               void* out, void* stats, int NB, int SW, int TW,
                               int lit_tw, int L, int E,
                               cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  if (E < 1 || E > kMaxRec || L < 1 || L > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(TW + SW + 2 * L * E) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      symbol_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  symbol_walk_kernel<<<NB, kThreads, smem, cuda_stream>>>(
      static_cast<const uint32_t*>(stream),
      static_cast<const int32_t*>(body_bit),
      static_cast<const int32_t*>(out_len),
      static_cast<const uint32_t*>(tab),
      static_cast<const int32_t*>(len_base),
      static_cast<const int32_t*>(len_extra),
      static_cast<const int32_t*>(dist_base),
      static_cast<const int32_t*>(dist_extra),
      static_cast<const int32_t*>(start_pos),
      static_cast<const int32_t*>(walk_end_bit), static_cast<int32_t*>(out),
      static_cast<int32_t*>(stats), SW, TW, lit_tw, L, E);
  return (int)cudaGetLastError();
}
