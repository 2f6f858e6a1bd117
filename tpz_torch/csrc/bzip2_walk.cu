// bzip2 symbol walk on Hopper: one CUDA block per bzip2 block, one warp
// walking it.
//
// Replaces tpz/kernels/bzip2_walk.py::_walk_kernel (the Pallas walk) and
// computes what its step_chain computes: from bit sym_local of the
// block's big-endian stream words, the multi-table Huffman decode (the
// table switches every 50 symbols, from the selector list; a 12-bit
// level 1, and on an escape (len 31) the 32-entry level-2 chunk at
// entry >> 5 indexed by the next 5 bits), MTF^-1 over a 256-byte list,
// and RLE2^-1: RUNA/RUNB add (s + 1) << run_bit to the run, and a
// non-run symbol after a run first flushes it as one record. Records are
// count << 8 | byte. The walk stops at end of block, at an error, or at
// S - 2 records; meta = (records, err, end bitpos), err being the
// reference's reason bits (1 zero-length code, 2 selectors exhausted,
// 4 symbol above end-of-block, 8 run above 2^21, 16 record cap) with
// (bitpos + 1) << 10 of the failing symbol. The reference holds the
// symbol after a flush for one more trip (held, sym_h); so does this
// walk, which keeps its records and meta equal to the reference's. The
// TPU version's interleaved chains, SMEM stream window with DMA refills
// and 128-lane row stores do not carry over.
//
// What bounds it: each symbol is a chain of dependent loads (stream
// word, selector, level-1 entry, maybe level-2 entry), and the MTF state
// makes a block one serial chain, so the walk is latency-bound and runs
// only as many chains as there are blocks (about 38 for 32 MiB at level
// 9). The design keeps every load but the stream in shared memory: the
// block's 256 threads stage the six tables as 16-bit entries (an escape
// stores its level-2 base divided by 32), 148,224 bytes, and the 18,432
// selectors; then warp 0 walks. The MTF list lives in the warp's
// registers, 8 bytes a lane, so a move-to-front is a constant number of
// shuffles however deep the rank. The two stream words stay in registers
// until the bit position leaves them.
//
// Corrupt input: the word index is clamped to SW - 2, the selector to 5
// and the selector index to the list, so no load leaves the slice or the
// tables; the walk ends by S - 2 records.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kSelCap = 18432;
constexpr int kGroup = 50;
constexpr int kL1Bits = 12;
constexpr int kL1W = 1 << kL1Bits;
constexpr int kTabStride = kL1W + 258 * 32;
constexpr int kTabs = 6;
constexpr int kThreads = 256;
constexpr int kMeta = 3;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    bzip2_walk_kernel(const int32_t* __restrict__ n_used,
                      const int32_t* __restrict__ nsel,
                      const int32_t* __restrict__ sym_local,
                      const uint32_t* __restrict__ stream,
                      const int32_t* __restrict__ tab,
                      const uint8_t* __restrict__ selectors,
                      const uint8_t* __restrict__ mtf_init,
                      int32_t* __restrict__ recs, int32_t* __restrict__ meta,
                      int SW, int S) {
  extern __shared__ uint16_t smem16[];
  uint16_t* tab_s = smem16;                                   // [6 x stride]
  uint8_t* sel_s = reinterpret_cast<uint8_t*>(smem16 + kTabs * kTabStride);

  const int b = blockIdx.x;
  const int32_t* tb = tab + (size_t)b * kTabs * kTabStride;
  for (int i = threadIdx.x; i < kTabs * kTabStride; i += blockDim.x) {
    const uint32_t e = (uint32_t)tb[i];
    tab_s[i] = (uint16_t)((e & 31) == 31 ? ((e >> 10) << 5) | 31 : e);
  }
  const uint8_t* sb = selectors + (size_t)b * kSelCap;
  for (int i = threadIdx.x; i < kSelCap; i += blockDim.x) sel_s[i] = sb[i];
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  // MTF list: lane l holds ranks 8l .. 8l+7, rank 8l + k in byte k.
  uint64_t mtf = 0;
  for (int k = 7; k >= 0; --k)
    mtf = (mtf << 8) | mtf_init[(size_t)b * 256 + 8 * lane + k];
  int head = mtf_init[(size_t)b * 256];

  const uint32_t* sw = stream + (size_t)b * SW;
  int32_t* orow = recs + (size_t)b * S;
  const int eob = n_used[b] + 1;
  const int ns = nsel[b];
  int bitpos = sym_local[b];
  int gi = 0, gpos = kGroup, nrec = 0, run_acc = 0, run_bit = 0, sym_h = 0;
  bool held = false;
  uint32_t err = 0;
  int cw = -2;
  uint32_t w0 = 0, w1 = 0;

  while (nrec < S) {
    const int t = min(gi < kSelCap ? (int)sel_s[gi] : 0, kTabs - 1);
    const int w = min(bitpos >> 5, SW - 2);
    if (w != cw) {
      w0 = w == cw + 1 ? w1 : sw[w];
      w1 = sw[w + 1];
      cw = w;
    }
    const int sh = bitpos & 31;
    uint32_t top = w0 << sh;
    if (sh > 0) top |= w1 >> ((32 - sh) & 31);
    const uint16_t* tt = tab_s + t * kTabStride;
    uint32_t e = tt[top >> (32 - kL1Bits)];
    if ((e & 31) == 31)
      e = tt[kL1W + (e >> 5) * 32 + ((top >> (32 - kL1Bits - 5)) & 31)];
    const int ln = (int)(e & 31);

    const bool consume = !held;
    const int s = held ? sym_h : (int)(e >> 5);
    const uint32_t why = (consume && ln == 0 ? 1u : 0u) |
                         (consume && gi >= ns ? 2u : 0u) |
                         (s > eob ? 4u : 0u) |
                         (run_acc > (1 << 21) ? 8u : 0u) |
                         (nrec >= S - 2 ? 16u : 0u);
    const bool bad = why != 0;
    const bool is_run = s <= 1;
    const bool flush = !is_run && run_acc > 0;
    const bool is_eob = !is_run && run_acc == 0 && s == eob;
    const bool is_plain = !is_run && run_acc == 0 && s != eob && !bad;

    if (flush) {
      if (lane == 0) orow[nrec] = (int32_t)(((uint32_t)run_acc << 8) | head);
      ++nrec;
    } else if (is_plain) {
      // Move rank j to the front: ranks 1..j take ranks 0..j-1.
      const int j = min(max(s - 1, 0), 255);
      const uint64_t v = __shfl_sync(kFull, mtf, j >> 3);
      const int byte = (int)((v >> ((j & 7) * 8)) & 0xff);
      const uint64_t prev = __shfl_up_sync(kFull, mtf, 1);
      const uint64_t shifted =
          (mtf << 8) | (lane == 0 ? (uint64_t)byte : prev >> 56);
      const int mine = j - 8 * lane + 1;  // this lane's ranks <= j
      const uint64_t mask =
          mine >= 8 ? ~0ull : (mine <= 0 ? 0ull : (1ull << (8 * mine)) - 1);
      mtf = (shifted & mask) | (mtf & ~mask);
      head = byte;
      if (lane == 0) orow[nrec] = (int32_t)((1u << 8) | (uint32_t)byte);
      ++nrec;
    }
    if (is_run && !bad) {
      run_acc += (s + 1) << run_bit;
      ++run_bit;
    } else if (flush) {
      run_acc = 0;
      run_bit = 0;
    }
    held = flush && !bad;
    if (flush) sym_h = s;
    if (bad) {
      err = why | ((uint32_t)(bitpos + 1) << 10);
      break;
    }
    if (consume) {
      bitpos += ln;
      if (--gpos == 0) {
        ++gi;
        gpos = kGroup;
      }
    }
    if (is_eob) break;
  }
  if (lane == 0) {
    meta[(size_t)b * kMeta + 0] = nrec;
    meta[(size_t)b * kMeta + 1] = (int32_t)err;
    meta[(size_t)b * kMeta + 2] = bitpos;
  }
}

}  // namespace

// n_used, nsel, sym_local [NB] int32; stream [NB, SW] big-endian u32
// words; tab [NB, 6 x 12352] int32; selectors [NB, 18432] and mtf_init
// [NB, 256] uint8; recs [NB, S] and meta [NB, 3] int32. Returns a
// cudaError_t.
extern "C" int tpz_bzip2_walk(const void* n_used, const void* nsel,
                              const void* sym_local, const void* stream,
                              const void* tab, const void* selectors,
                              const void* mtf_init, void* recs, void* meta,
                              int NB, int SW, int S,
                              cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  const size_t smem = (size_t)kTabs * kTabStride * sizeof(uint16_t) + kSelCap;
  cudaError_t err = cudaFuncSetAttribute(
      bzip2_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bzip2_walk_kernel<<<NB, kThreads, smem, cuda_stream>>>(
      static_cast<const int32_t*>(n_used), static_cast<const int32_t*>(nsel),
      static_cast<const int32_t*>(sym_local),
      static_cast<const uint32_t*>(stream), static_cast<const int32_t*>(tab),
      static_cast<const uint8_t*>(selectors),
      static_cast<const uint8_t*>(mtf_init), static_cast<int32_t*>(recs),
      static_cast<int32_t*>(meta), SW, S);
  return (int)cudaGetLastError();
}
