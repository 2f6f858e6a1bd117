// LZHUF's bit packer (MSB-first) on Hopper: one CUDA block a 32 KiB block
// row, its header slots and then its body, the finished u32 words written
// in place.
//
// Replaces no TPU kernel. It stands for the reference's pack stage,
// tpz/kernels/lzhuf_pipeline.py:110 `_stage2` with
// tpz/kernels/bitpack.py:246 `assemble_stream_msb`, plain jnp that XLA
// fuses. Eager torch built the body's [NB, 2 x 32768] slots as int64
// tensors (537 MB each at 1,024 rows) and assembled the words with two
// index_add_ calls, which send every dead slot (the p slot of every
// literal, both slots inside a match) to two spare words, so the atomic
// adds ran mostly one after another on one or two addresses.
//
// Semantics: those of lzhuf_pipeline.pack_words_plain. A row's header
// slots (hdr_vals, hdr_bits) follow one another from head_off. Its body
// follows from body_off: each position contributes a c slot (a token: the
// C code of 256 + mlen - 3 for a match, of the byte for a literal) and
// then a p slot (a match: the P code of c = bit_length(mdist - 1), then
// the c - 1 low bits of mdist - 1). A slot is at most 31 bits, width 0 a
// dead slot. Bits are MSB-first: word w holds stream bits [32w, 32w + 32),
// bit 32w at its MSB, as assemble_stream_msb has them.
//
// What bounds it: bytes. The bytes, is_token, mlen and mdist are read
// once (10 B a position), the tables and the header slots once (~13 MB at
// 1,024 rows), the words written once (~12 MB for 2 x 16 MiB at lh5):
// ~0.11 ms at 3.35 TB/s.
//
// Design (deflate_pack.cu's, read MSB-first): a block walks its row in
// tiles of kTile positions. cub's BlockLoad stages each input tile through
// shared memory (warp transpose), so the global reads are coalesced, and
// hands each thread kPer consecutive positions, 2 kPer consecutive slots,
// which it forms in registers (the P symbol with __clz, the codes from the
// row's C and P tables in shared memory). The bytes are read straight
// from the encode's uint8 blocks, at the row's window offset. cub's
// BlockScan gives each thread its first bit; a 64-bit running row offset
// carries over the tiles. The thread then streams its slots through a
// 64-bit register, oldest bits highest: a word whose 32 bits all come from
// its own slots is a plain store; any other word (its first or last,
// shared with a neighbour thread, tile or row, or with the row's header)
// takes atomicOr. The bit ranges are disjoint, so the words are exact, and
// a second launch on the same words writes the same words. Dead slots
// write nothing. The header slots go the same way first, kHeadPer a
// thread, from head_off.
//
// Layout: blocks [NB, M] uint8 (the row's positions at [window, window +
// B)); is_token [NB, B] bool; mlen, mdist [NB, B] int32; table [NB, 530]
// int32, code | len << 16 (0..509 the C table, 510..529 the P table);
// hdr_vals [NB, S] int64 (u32 values); hdr_bits [NB, S] int32; head_off,
// body_off [NB] int64; out [total_words] u32, zeroed. Words at or past
// total_words are not written. B a multiple of kTile.

#include <cuda_runtime.h>
#include <cstdint>

#include <cub/block/block_load.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                 // positions a thread, a tile
constexpr int kTile = kThreads * kPer;  // 2,048 positions
constexpr int kHeadPer = 5;             // header slots a thread, a tile
constexpr int kHeadTile = kThreads * kHeadPer;  // 1,280 >= S (<= 1,061)
constexpr int kNC = 510;                // the C table's symbols
constexpr int kCols = kNC + 20;         // the joint table's columns

using LoadInt = cub::BlockLoad<int32_t, kThreads, kPer,
                               cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using LoadByte = cub::BlockLoad<uint8_t, kThreads, kPer,
                                cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using LoadVal = cub::BlockLoad<long long, kThreads, kHeadPer,
                               cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using LoadBits = cub::BlockLoad<int32_t, kThreads, kHeadPer,
                                cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using Scan = cub::BlockScan<int, kThreads>;

__device__ __forceinline__ void put(uint32_t* out, long long w, uint32_t v,
                                    bool own, long long total_words) {
  if (w >= total_words) return;
  if (own)
    out[w] = v;
  else if (v)
    atomicOr(out + w, v);
}

// A thread's slots, MSB-first from absolute bit `start`. acc holds the
// nacc bits not yet written, oldest highest; the start's first
// start & 31 bits are other slots' and stay 0.
struct MsbWriter {
  uint32_t* out;
  long long total_words;
  long long w;
  int nacc;
  bool own;  // every bit of word w so far is this thread's
  unsigned long long acc;

  __device__ MsbWriter(uint32_t* o, long long tw, long long start)
      : out(o), total_words(tw), w(start >> 5), nacc((int)(start & 31)),
        own(nacc == 0), acc(0) {}

  // n in [0, 31]: the low n bits of v.
  __device__ __forceinline__ void push(uint32_t v, int n) {
    if (n <= 0) return;
    acc = (acc << n) | (v & (0xFFFFFFFFu >> (32 - n)));
    nacc += n;
    if (nacc >= 32) {
      nacc -= 32;
      put(out, w, (uint32_t)(acc >> nacc), own, total_words);
      ++w;
      own = true;
    }
  }

  __device__ __forceinline__ void flush() {
    if (nacc) put(out, w, (uint32_t)(acc << (32 - nacc)), false, total_words);
  }
};

// Both slots of a position (lzhuf_pipeline._stage2).
__device__ __forceinline__ void position_slots(bool tok, int ml, int md,
                                               int byte, const int* tab,
                                               uint32_t& v0, int& n0,
                                               uint32_t& v1, int& n1) {
  const bool match = tok && ml > 0;
  const int csym = min(max(match ? 256 + ml - 3 : byte, 0), kNC - 1);
  const int ce = tab[csym];
  v0 = (uint32_t)(ce & 0xFFFF);
  n0 = tok ? ce >> 16 : 0;
  // _bitlen16: bit_length, 17 for anything past 16 bits.
  const uint32_t p = (uint32_t)(max(md, 1) - 1);
  const int c = min(32 - __clz(p), 17);
  const int raw = max(c - 1, 0);
  const int pe = tab[kNC + c];
  v1 = ((uint32_t)(pe & 0xFFFF) << raw) | (p & ((1u << raw) - 1u));
  n1 = match ? (pe >> 16) + raw : 0;
}

__global__ void __launch_bounds__(kThreads)
    lzhuf_pack(const uint8_t* __restrict__ blocks,
               const uint8_t* __restrict__ is_token,
               const int32_t* __restrict__ mlen,
               const int32_t* __restrict__ mdist,
               const int32_t* __restrict__ table,
               const long long* __restrict__ hdr_vals,
               const int32_t* __restrict__ hdr_bits,
               const long long* __restrict__ head_off,
               const long long* __restrict__ body_off,
               uint32_t* __restrict__ out, int M, int window, int B, int S,
               long long total_words) {
  __shared__ int s_tab[kCols];
  __shared__ union {
    struct {
      LoadInt::TempStorage len, dist;
      LoadByte::TempStorage byte, tok;
    } body;
    struct {
      LoadVal::TempStorage vals;
      LoadBits::TempStorage bits;
    } head;
  } s_load;
  __shared__ Scan::TempStorage s_scan;

  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < kCols; i += kThreads)
    s_tab[i] = table[(size_t)row * kCols + i];
  __syncthreads();

  long long run = head_off[row];  // the row's next header bit
  for (int h0 = 0; h0 < S; h0 += kHeadTile) {
    long long v[kHeadPer];
    int n[kHeadPer];
    const int valid = min(S - h0, kHeadTile);
    LoadVal(s_load.head.vals).Load(hdr_vals + (size_t)row * S + h0, v, valid,
                                   0LL);
    LoadBits(s_load.head.bits).Load(hdr_bits + (size_t)row * S + h0, n,
                                    valid, 0);
    int bits = 0;
#pragma unroll
    for (int j = 0; j < kHeadPer; ++j) bits += n[j];
    int excl, tile_bits;
    Scan(s_scan).ExclusiveSum(bits, excl, tile_bits);
    MsbWriter wr(out, total_words, run + excl);
#pragma unroll
    for (int j = 0; j < kHeadPer; ++j) wr.push((uint32_t)v[j], n[j]);
    wr.flush();
    run += tile_bits;
    __syncthreads();  // the load and scan storage is used again
  }

  const size_t base = (size_t)row * B;
  const uint8_t* bytes = blocks + (size_t)row * M + window;
  run = body_off[row];  // the row's next body bit
  for (int t0 = 0; t0 < B; t0 += kTile) {
    int ml[kPer], md[kPer];
    uint8_t byte[kPer], tok[kPer];
    LoadInt(s_load.body.len).Load(mlen + base + t0, ml);
    LoadInt(s_load.body.dist).Load(mdist + base + t0, md);
    LoadByte(s_load.body.byte).Load(bytes + t0, byte);
    LoadByte(s_load.body.tok).Load(is_token + base + t0, tok);

    uint32_t v[2 * kPer];
    int n[2 * kPer];
    int bits = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      position_slots(tok[j], ml[j], md[j], byte[j], s_tab, v[2 * j],
                     n[2 * j], v[2 * j + 1], n[2 * j + 1]);
      bits += n[2 * j] + n[2 * j + 1];
    }
    int excl, tile_bits;
    Scan(s_scan).ExclusiveSum(bits, excl, tile_bits);
    MsbWriter wr(out, total_words, run + excl);
#pragma unroll
    for (int k = 0; k < 2 * kPer; ++k) wr.push(v[k], n[k]);
    wr.flush();
    run += tile_bits;
    __syncthreads();  // the load and scan storage is used again
  }
}

}  // namespace

// One launch: one CUDA block a row. B not a multiple of kTile, or rows of
// blocks too short for window + B, return cudaErrorInvalidValue and launch
// nothing.
extern "C" int tpz_lzhuf_pack(const void* blocks, const void* is_token,
                              const void* mlen, const void* mdist,
                              const void* table, const void* hdr_vals,
                              const void* hdr_bits, const void* head_off,
                              const void* body_off, void* out, int NB, int M,
                              int window, int B, int S,
                              long long total_words, cudaStream_t stream) {
  if (B <= 0 || B % kTile || window < 0 || M < window + B || S < 0
      || total_words < 0)
    return (int)cudaErrorInvalidValue;
  if (NB == 0) return 0;
  lzhuf_pack<<<NB, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const uint8_t*>(is_token),
      static_cast<const int32_t*>(mlen), static_cast<const int32_t*>(mdist),
      static_cast<const int32_t*>(table),
      static_cast<const long long*>(hdr_vals),
      static_cast<const int32_t*>(hdr_bits),
      static_cast<const long long*>(head_off),
      static_cast<const long long*>(body_off), static_cast<uint32_t*>(out), M,
      window, B, S, total_words);
  return (int)cudaGetLastError();
}
