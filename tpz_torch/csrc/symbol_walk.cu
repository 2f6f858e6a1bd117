// DEFLATE symbol walk on Hopper: one CUDA block per block or segment
// chain, one walking thread.
//
// Replaces tpz/kernels/inflate_pipeline.py::_symbol_walk (the Pallas walk)
// and computes what its lane-parallel twin _symbol_walk_vz computes: each
// chain Huffman-decodes its entry's symbol stream from bit
// body_bit_local, with the two-level tables (10-bit L1, 32-entry L2
// chunks, escape = code length 31), and stores one marker per token at
// out[chain, out_pos]: 1 << 28 | byte for a literal, 2 << 28 | dist << 9
// | len for a match. `out` arrives zeroed: positions inside a match read
// 0, and the resolve depends on it. The TPU version's SMEM stream windows,
// DMA refills and 128-lane row read-modify-writes do not carry over.
//
// What bounds it: a token is a chain of dependent loads (peek, L1 entry,
// maybe L2 entry, length extra, distance L1/L2, distance extra), so the
// walk is latency-bound, one token at a time per chain. The design keeps
// every load of the walk in shared memory: the block's 256 threads first
// copy the chain's 28 KiB of tables and its stream slice (72 KiB at
// SW = 18432 words) into dynamic shared memory, then thread 0 walks. One
// chain per block spreads the chains over the SMs (256 chains at 16 MiB
// take 132 SMs, two blocks each, instead of two SMs for 128-thread
// blocks of chains). The parallelism is still one thread per chain; more,
// shorter chains (a smaller segment length) would raise it.
//
// Corrupt streams: the reference's clamps are kept (word index <= SW - 3,
// length index 0..28, distance index 0..29, L2 index inside the table),
// and an invalid symbol ends the chain, so no load leaves the slice or
// the table; the CRC or Adler-32 check rejects the output.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBlock = 65536;
constexpr int kL1Bits = 10;
constexpr uint32_t kL1Mask = (1u << kL1Bits) - 1;
constexpr int kThreads = 256;

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
                       int32_t* __restrict__ out, int SW, int TW,
                       int lit_tw) {
  extern __shared__ uint32_t smem[];
  uint32_t* t_s = smem;       // [TW] fused tables
  uint32_t* s_s = smem + TW;  // [SW] stream slice
  __shared__ int lb[29], le[29], db[30], de[30];

  const int c = blockIdx.x;
  const int olen = min(out_len[c], kBlock);
  int out_pos = start_pos[c];
  if (out_pos >= olen) return;  // stored block or empty entry: whole block

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
  if (threadIdx.x != 0) return;

  int32_t* orow = out + (size_t)c * kBlock;
  const int olit2 = 1 << kL1Bits;
  const int odist1 = lit_tw;
  const int odist2 = lit_tw + (1 << kL1Bits);
  int bitpos = body_bit[c];
  while (out_pos < olen) {
    const int wc = min(max(bitpos >> 5, 0), SW - 3);
    const uint32_t w0 = s_s[wc], w1 = s_s[wc + 1], w2 = s_s[wc + 2];
    const int sh = bitpos & 31;

    const uint32_t peek = bits_at(w0, w1, w2, sh, 0, 15);
    uint32_t e = t_s[peek & kL1Mask];
    if ((e & 31) == 31)
      e = t_s[min(olit2 + (int)(e >> 5) + (int)((peek >> kL1Bits) & 31),
                  TW - 1)];
    const int clen = e & 31;
    const int sym = (int)(e >> 5);
    if (clen == 0 || sym == 256 || sym > 285) break;  // invalid: abort
    if (sym < 256) {
      orow[out_pos] = (int32_t)((1u << 28) | (uint32_t)sym);
      bitpos += clen;
      out_pos += 1;
      continue;
    }
    const int li = min(sym - 257, 28);
    const int eb = le[li];
    const int lval = lb[li] + (int)bits_at(w0, w1, w2, sh, clen, eb);
    const uint32_t pk = bits_at(w0, w1, w2, sh, clen + eb, 15);
    uint32_t e2 = t_s[odist1 + (int)(pk & kL1Mask)];
    if ((e2 & 31) == 31)
      e2 = t_s[min(odist2 + (int)(e2 >> 5) + (int)((pk >> kL1Bits) & 31),
                   TW - 1)];
    const int dlen = e2 & 31;
    if (dlen == 0) break;  // invalid distance code: abort
    const int ds = min((int)(e2 >> 5), 29);
    const int deb = de[ds];
    const int dval =
        db[ds] + (int)bits_at(w0, w1, w2, sh, clen + eb + dlen, deb);
    orow[out_pos] = (int32_t)((2u << 28) | ((uint32_t)dval << 9) |
                              (uint32_t)lval);
    bitpos += clen + eb + dlen + deb;
    out_pos += lval;
  }
}

}  // namespace

// stream [NB, SW] u32 words, tab [NB, TW] u32, body_bit / out_len /
// start_pos [NB] int32, len/dist base and extra [29]/[30] int32, out
// [NB, 65536] int32 zeroed by the caller. Returns a cudaError_t.
extern "C" int tpz_symbol_walk(const void* stream, const void* body_bit,
                               const void* out_len, const void* tab,
                               const void* len_base, const void* len_extra,
                               const void* dist_base, const void* dist_extra,
                               const void* start_pos, void* out, int NB,
                               int SW, int TW, int lit_tw,
                               cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  const size_t smem = (size_t)(TW + SW) * sizeof(uint32_t);
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
      static_cast<const int32_t*>(start_pos), static_cast<int32_t*>(out), SW,
      TW, lit_tw);
  return (int)cudaGetLastError();
}
