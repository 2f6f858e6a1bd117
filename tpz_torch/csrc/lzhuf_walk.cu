// LZHUF (LHA lh4-lh7) token walk on Hopper: one CUDA block per segment,
// one walking thread.
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
// the p code c (0 or 1), or 2^(c-1) | (c - 1 raw bits). `out` arrives
// zeroed: positions inside a match read 0, and the resolve depends on it.
// The TPU version's SMEM stream window, DMA refills and 128-lane row
// read-modify-writes do not carry over.
//
// What bounds it: a token is a chain of dependent loads (stream words,
// c L1, maybe c L2, p L1, maybe p L2), so the walk is latency-bound, one
// token at a time per segment. The design keeps every load of the walk
// in shared memory: the block's 256 threads first copy the segment's
// 64 KiB of tables and its 80 KiB stream slice into dynamic shared
// memory (144 KiB, one block per SM), then thread 0 walks. The
// parallelism is one thread per segment (about 512 per 16 MiB).
//
// Corrupt input: the word index is clamped to [0, SW - 3] and the level-2
// indices to the table row, so no load leaves the slice or the row; the
// loop ends because every token advances out_pos by at least 1. The host
// token indexer has already walked these exact bits, so valid streams
// never need the clamps.

#include <cuda_runtime.h>
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
constexpr int kThreads = 256;

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

// Decode-table lookup: a level-1 entry, or the level-2 entry it escapes
// to (the 5 bits after the 12 peeked ones).
__device__ __forceinline__ uint32_t lookup(const uint32_t* t, int l1, int l2,
                                           uint32_t w0, uint32_t w1,
                                           uint32_t w2, int sh, int off) {
  const uint32_t e = t[l1 + (int)bits_at(w0, w1, w2, sh, off, kL1Bits)];
  if ((e & 31) != 31) return e;
  const int i = l2 + (int)(e >> 5) +
                (int)bits_at(w0, w1, w2, sh, off + kL1Bits, 5);
  return t[min(i, kTW - 1)];
}

__global__ void __launch_bounds__(kThreads)
    lzhuf_walk_kernel(const uint32_t* __restrict__ stream,
                      const int32_t* __restrict__ body_bit,
                      const int32_t* __restrict__ out_len,
                      const int32_t* __restrict__ start_pos,
                      const uint32_t* __restrict__ tab,
                      int32_t* __restrict__ out, int SW) {
  extern __shared__ uint32_t smem[];
  uint32_t* t_s = smem;        // [kTW] fused tables
  uint32_t* s_s = smem + kTW;  // [SW] stream slice

  const int c = blockIdx.x;
  const int olen = min(out_len[c], kBlock);
  int out_pos = start_pos[c];
  if (out_pos >= olen) return;

  for (int i = threadIdx.x; i < kTW; i += blockDim.x)
    t_s[i] = tab[(size_t)c * kTW + i];
  for (int i = threadIdx.x; i < SW; i += blockDim.x)
    s_s[i] = stream[(size_t)c * SW + i];
  __syncthreads();
  if (threadIdx.x != 0) return;

  int32_t* orow = out + (size_t)c * kBlock;
  int bitpos = body_bit[c];
  while (out_pos < olen) {
    const int wc = min(max(bitpos >> 5, 0), SW - 3);
    const uint32_t w0 = s_s[wc], w1 = s_s[wc + 1], w2 = s_s[wc + 2];
    const int sh = bitpos & 31;

    const uint32_t e = lookup(t_s, 0, kOC2, w0, w1, w2, sh, 0);
    const int clen = (int)(e & 31);
    const uint32_t csym = e >> 5;
    if (csym < 256) {
      orow[out_pos] = (int32_t)((1u << 28) | csym);
      bitpos += clen;
      out_pos += 1;
      continue;
    }
    const int mlen = (int)min(csym - 253u, 258u);  // csym >= 256: >= 3
    const uint32_t pe = lookup(t_s, kOP1, kOP2, w0, w1, w2, sh, clen);
    const int plen = (int)(pe & 31);
    const uint32_t pc = pe >> 5;
    const int raw_n = pc > 1 ? (int)pc - 1 : 0;
    const uint32_t raw = bits_at(w0, w1, w2, sh, clen + plen, raw_n);
    const uint32_t pval =
        pc > 1 ? (raw_n < 32 ? (1u << raw_n) : 0u) | raw : pc;
    orow[out_pos] = (int32_t)((2u << 28) | (pval << 9) | (uint32_t)mlen);
    bitpos += clen + plen + raw_n;
    out_pos += mlen;
  }
}

}  // namespace

// stream [NB, SW] big-endian u32 words, body_bit / out_len / start_pos
// [NB] int32, tab [NB, 16384] u32, out [NB, 65536] int32 zeroed by the
// caller. Returns a cudaError_t.
extern "C" int tpz_lzhuf_walk(const void* stream, const void* body_bit,
                              const void* out_len, const void* start_pos,
                              const void* tab, void* out, int NB, int SW,
                              cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  const size_t smem = (size_t)(kTW + SW) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      lzhuf_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lzhuf_walk_kernel<<<NB, kThreads, smem, cuda_stream>>>(
      static_cast<const uint32_t*>(stream),
      static_cast<const int32_t*>(body_bit),
      static_cast<const int32_t*>(out_len),
      static_cast<const int32_t*>(start_pos),
      static_cast<const uint32_t*>(tab), static_cast<int32_t*>(out), SW);
  return (int)cudaGetLastError();
}
