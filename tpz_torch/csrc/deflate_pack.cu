// DEFLATE's bit packer (LSB-first) on Hopper: one CUDA block a 64 KiB
// block row, the finished u32 words written in place.
//
// Replaces no TPU kernel. The reference's packer
// (tpz/kernels/bitpack.py::assemble_stream_v2) is plain jnp that XLA
// fuses; eager torch built its [NB, 2B + 1] slots as int64 tensors (537
// MB each at 512 rows) and assembled the words with two index_add_
// calls, which send every dead slot (most of them: slot 1 of every
// literal, both slots inside a match) to one spare word, so ~134 M
// atomic adds ran mostly one after another on one or two addresses.
//
// Semantics: those of assemble_stream_v2. Every position contributes a
// literal/length slot (code, then extra bits) and a distance slot, a
// fixed or dynamic row one end-of-block slot after them; a stored row a
// raw byte for each position below block_len (table320's column 318
// ahead of it). Slots follow one another in position order from
// body_off; a stored row's positions from STORED_CHUNK on sit past the
// second chunk's header, chunk1_off - body_off - 8 STORED_CHUNK bits
// further. The header slots (vals, nbits, offs) sit at absolute offsets.
//
// What bounds it: bytes. is_token, mlen, mdist and the bytes are read
// once (13 B a position), the words written once (~11 MB for 2 x 16 MiB
// at level 6).
//
// Design: a block walks its row in tiles of kTile positions. cub's
// BlockLoad stages each input tile through shared memory (warp
// transpose), so the global reads are coalesced, and hands each thread
// kPer consecutive positions, 2 kPer consecutive slots, whose widths it
// derives in registers (the length and distance symbols with __clz, the
// code lengths from the row's table320 in shared memory). cub's
// BlockScan gives each thread its first bit; a 64-bit running row offset
// carries over the tiles. The thread then derives its slots again and
// streams their bits through a 64-bit register: a word whose 32 bits all
// come from its own slots is a plain store; any other word (its first
// or last, shared with a neighbour thread, tile or row, a header or the
// stored gap) takes atomicOr. The bit ranges are disjoint, so the words
// are exact, and a second launch on the same words writes the same
// words. Dead slots write nothing. Thread 0 ORs the end-of-block slot
// in after the last tile, and the block ORs its row's header slots in.
//
// Layout: data_block [NB, B] int32 (bytes 0..255); is_token [NB, B]
// bool; mlen, mdist [NB, B] int32; table320 [NB, 320] int32 (bit-
// reversed code | len << 16: 0..287 litlen, 288..317 distance, 318 the
// raw byte's); body_off, btype, block_len, chunk1_off [NB] int32;
// hdr_vals [NB, H] int64 (u32 values); hdr_nbits, hdr_offs [NB, H]
// int32; out [total_words] u32, zeroed. Words at or past total_words
// are not written. B a multiple of kTile.

#include <cuda_runtime.h>
#include <cstdint>

#include <cub/block/block_load.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                 // positions a thread, a tile
constexpr int kTile = kThreads * kPer;  // 2,048 positions
constexpr int kStoredChunk = 32768;     // bitpack.STORED_CHUNK
constexpr int kCols = 320;              // table320's columns
constexpr int kDistCol = 288;
constexpr int kRawCol = 318;
constexpr int kEob = 256;
static_assert(kStoredChunk % kTile == 0,
              "a stored row's second chunk starts a tile");

using LoadInt = cub::BlockLoad<int32_t, kThreads, kPer,
                               cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using LoadFlag = cub::BlockLoad<uint8_t, kThreads, kPer,
                                cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using Scan = cub::BlockScan<int, kThreads>;

struct Slot {
  int nbits;  // 0: writes nothing
  unsigned long long val;
};

__device__ __forceinline__ int bitlen(uint32_t x) { return 32 - __clz(x); }

// cl: a table320 entry; ev, eb: the extra bits' value and count.
__device__ __forceinline__ Slot make_slot(bool live, int cl, int ev,
                                          int eb) {
  const int clen = cl >> 16;
  return {live ? clen + eb : 0,
          (unsigned long long)(cl & 0xFFFF)
              | ((unsigned long long)(long long)ev << clen)};
}

// Both slots of position p (bitpack.length_symbol and dist_symbol).
__device__ __forceinline__ void position_slots(bool stored, bool in_block,
                                               bool tok, int ml, int md,
                                               int byte, const int* tab,
                                               Slot& s0, Slot& s1) {
  s1 = {0, 0};
  if (stored) {
    s0 = make_slot(in_block, tab[kRawCol], byte, 8);
    return;
  }
  if (!(tok && ml > 0)) {
    s0 = make_slot(tok, tab[byte & 0xFF], 0, 0);
    return;
  }
  const int m = min(ml, 258);
  const int l = max(m - 3, 0);
  const int e = max(bitlen(l) - 3, 0);
  if (m >= 258) {
    s0 = make_slot(true, tab[285], 0, 0);
  } else if (m <= 10) {
    s0 = make_slot(true, tab[254 + m], 0, 0);
  } else {
    s0 = make_slot(true, tab[257 + 4 * (e + 1) + ((l >> e) & 3)],
                   l & ((1 << e) - 1), e);
  }
  const int d = max(md, 1) - 1;
  const int de = max(min(bitlen(d), 16) - 2, 0);
  const int dsym = d < 4 ? d : 2 * (de + 1) + ((d >> de) & 1);
  s1 = make_slot(true, tab[kDistCol + min(dsym, 29)], d & ((1 << de) - 1),
                 de);
}

__device__ __forceinline__ void put(uint32_t* out, long long w, uint32_t v,
                                    bool own, long long total_words) {
  if (w >= total_words) return;
  if (own)
    out[w] = v;
  else if (v)
    atomicOr(out + w, v);
}

// v (at most 32 bits) at absolute bit `off`, into one or two words.
__device__ __forceinline__ void or_bits(uint32_t* out, long long off,
                                        unsigned long long v,
                                        long long total_words) {
  const long long w = off >> 5;
  const int sh = (int)(off & 31);
  put(out, w, (uint32_t)(v << sh), false, total_words);
  if (sh) put(out, w + 1, (uint32_t)(v >> (32 - sh)), false, total_words);
}

__global__ void __launch_bounds__(kThreads)
    deflate_pack(const int32_t* __restrict__ data_block,
                 const uint8_t* __restrict__ is_token,
                 const int32_t* __restrict__ mlen,
                 const int32_t* __restrict__ mdist,
                 const int32_t* __restrict__ table320,
                 const int32_t* __restrict__ body_off,
                 const int32_t* __restrict__ btype,
                 const int32_t* __restrict__ block_len,
                 const int32_t* __restrict__ chunk1_off,
                 const long long* __restrict__ hdr_vals,
                 const int32_t* __restrict__ hdr_nbits,
                 const int32_t* __restrict__ hdr_offs,
                 uint32_t* __restrict__ out, int B, int H,
                 long long total_words) {
  __shared__ int s_tab[kCols];
  __shared__ LoadInt::TempStorage s_load_len, s_load_dist,
      s_load_byte;
  __shared__ LoadFlag::TempStorage s_load_tok;
  __shared__ Scan::TempStorage s_scan;

  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < kCols; i += kThreads)
    s_tab[i] = table320[(size_t)row * kCols + i];
  const bool stored = btype[row] == 0;
  const int blen = block_len[row];
  const long long boff = body_off[row];
  // int32, as the plain version computes it.
  const int gap = chunk1_off[row] > 0
                      ? chunk1_off[row] - body_off[row] - 8 * kStoredChunk
                      : 0;
  __syncthreads();

  const size_t base = (size_t)row * B;
  long long run = 0;  // bits of the row's slots before the tile
  for (int t0 = 0; t0 < B; t0 += kTile) {
    if (stored && t0 >= blen) break;  // nothing left to write
    int ml[kPer], md[kPer], byte[kPer];
    uint8_t tok[kPer];
    LoadInt(s_load_len).Load(mlen + base + t0, ml);
    LoadInt(s_load_dist).Load(mdist + base + t0, md);
    LoadInt(s_load_byte).Load(data_block + base + t0, byte);
    LoadFlag(s_load_tok).Load(is_token + base + t0, tok);

    const int p0 = t0 + threadIdx.x * kPer;
    int bits = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      Slot s0, s1;
      position_slots(stored, p0 + j < blen, tok[j], ml[j], md[j], byte[j],
                     s_tab, s0, s1);
      bits += s0.nbits + s1.nbits;
    }
    int excl, tile_bits;
    Scan(s_scan).ExclusiveSum(bits, excl, tile_bits);

    const long long start = boff + run + excl
                            + (stored && t0 >= kStoredChunk ? gap : 0);
    long long w = start >> 5;
    int nacc = (int)(start & 31);
    bool own = nacc == 0;  // the word's low bits are this thread's too
    unsigned long long acc = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      Slot s[2];
      position_slots(stored, p0 + j < blen, tok[j], ml[j], md[j], byte[j],
                     s_tab, s[0], s[1]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (!s[k].nbits) continue;
        acc |= s[k].val << nacc;
        nacc += s[k].nbits;
        while (nacc >= 32) {
          put(out, w, (uint32_t)acc, own, total_words);
          acc >>= 32;
          nacc -= 32;
          ++w;
          own = true;
        }
      }
    }
    if (bits && nacc) put(out, w, (uint32_t)acc, false, total_words);
    run += tile_bits;
    __syncthreads();  // the load and scan storage is used again
  }

  if (threadIdx.x == 0 && !stored) {
    const int cl = s_tab[kEob];
    if (cl >> 16) or_bits(out, boff + run, cl & 0xFFFF, total_words);
  }
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const size_t i = (size_t)row * H + h;
    if (hdr_nbits[i] > 0)
      or_bits(out, hdr_offs[i], (unsigned long long)hdr_vals[i],
              total_words);
  }
}

}  // namespace

// One launch: one CUDA block a row. B not a multiple of kTile returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int tpz_deflate_pack(const void* data_block, const void* is_token,
                                const void* mlen, const void* mdist,
                                const void* table320, const void* body_off,
                                const void* btype, const void* block_len,
                                const void* chunk1_off, const void* hdr_vals,
                                const void* hdr_nbits, const void* hdr_offs,
                                void* out, int NB, int B, int H,
                                long long total_words, cudaStream_t stream) {
  if (B <= 0 || B % kTile || H < 0 || total_words < 0)
    return (int)cudaErrorInvalidValue;
  if (NB == 0) return 0;
  deflate_pack<<<NB, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(data_block),
      static_cast<const uint8_t*>(is_token),
      static_cast<const int32_t*>(mlen), static_cast<const int32_t*>(mdist),
      static_cast<const int32_t*>(table320),
      static_cast<const int32_t*>(body_off),
      static_cast<const int32_t*>(btype),
      static_cast<const int32_t*>(block_len),
      static_cast<const int32_t*>(chunk1_off),
      static_cast<const long long*>(hdr_vals),
      static_cast<const int32_t*>(hdr_nbits),
      static_cast<const int32_t*>(hdr_offs), static_cast<uint32_t*>(out), B,
      H, total_words);
  return (int)cudaGetLastError();
}
