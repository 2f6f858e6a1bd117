// bzip2 symbol walk on Hopper: a serial records pass, then the MTF^-1 in
// segments that run in parallel.
//
// Replaces tpz/kernels/bzip2_walk.py::_walk_call / _walk_kernel (the
// Pallas walk) and computes what its step_chain computes: from bit
// sym_local of the block's big-endian stream words, the multi-table
// Huffman decode (the table switches every 50 symbols, from the selector
// list; a 12-bit level 1, and on an escape (len 31) the 32-entry level-2
// chunk at entry >> 5 indexed by the next 5 bits), MTF^-1 over a 256-byte
// list, and RLE2^-1: RUNA/RUNB add (s + 1) << run_bit to the run, and a
// non-run symbol after a run first flushes it as one record. Records are
// count << 8 | byte. The walk stops at end of block or at an error; meta =
// (records, err, end bitpos), err being the reference's reason bits (1
// zero-length code, 2 selectors exhausted, 4 symbol above end-of-block, 8
// run above 2^21, 16 record cap at S - 2) with (bitpos + 1) << 10 of the
// failing symbol. The reference holds the symbol after a flush for one
// more trip, which consumes no bits; its record cap is checked on that
// trip too, after the flush has advanced the bit position. The TPU
// version's interleaved chains, SMEM stream window with DMA refills and
// 128-lane row stores do not carry over.
//
// What bounds it: the Huffman decode of a block is one serial chain of
// dependent steps (bit position -> stream bits -> table entry -> code
// length -> bit position), latency-bound, one chain per bzip2 block. On
// one thread every instruction of the trip waits on the one before it
// (a lone warp issues a dependent instruction every ~4 cycles), so the
// design keeps that thread's trip as short as it can and moves the rest
// elsewhere. The MTF list is the only state that forces the MTF^-1 to
// run in order, and none of the walk's error bits depends on it. So:
//   A  records (one CUDA block per bzip2 block): the block's 256 threads
//      stage the six tables as 16-bit entries (an escape stores its
//      level-2 base divided by 32; an entry that ends the walk, an empty
//      code or a symbol at or above end-of-block, carries bit 15), 148,224
//      bytes, and the 18,432 selectors in shared memory. Then two warps
//      run side by side. Lane 0 of warp 0 decodes: per trip the entry's
//      code is shifted out of a 64-bit bit buffer (refilled from a word
//      loaded one refill ahead; an L1 prefetch runs 96 words ahead), the
//      next level-1 load starts, and only then does the entry go into a
//      ring of 8,192 in shared memory and its end bit get tested, so the
//      chain is load -> length -> shift -> load. The table switches
//      every 50 symbols; a group that cannot reach the slice's end skips
//      the clamp test; the ring's head is published once a group. Warp 1
//      runs RLE2 over the
//      ring, 32 trips at a time, a lane a trip: warp scans give each trip
//      its bit position, its run (RUNA/RUNB add (s + 1) << k, k counted
//      from the last non-run symbol) and its record index; the first
//      trip that ends the walk (a bad one, the record cap on a flush's
//      held trip, end-of-block) is a ballot. It writes count << 8 |
//      rank: rank s - 1 for a literal, 0 for a flushed run (a run's byte
//      is the list head), and meta.
//   B1 labels (a warp per segment of `seg` records): walks the segment's
//      ranks on the identity list of labels 0..255 (the register list of
//      mtf_list.cuh; rank 0 moves nothing), rewrites each record's low
//      byte as the label at its rank, and stores the segment's final
//      label list P_k (256 bytes).
//   B2 lists (a block per bzip2 block): L_0 = mtf_init, L_{k+1}[i] =
//      L_k[P_k[i]], each L_k stored.
//   B3 bytes (a thread per record): low byte = L_k[label]. A label names
//      a position of the list at its segment's start, so this is the byte
//      the serial walk would have moved.
// B runs over every block's records up to its count, err or not; records
// past the count stay as the caller left them.
//
// Corrupt input: the word index is clamped to SW - 2, the selector to 5
// and the selector index to the list, so no load leaves the slice or the
// tables; the walk ends by S - 2 records.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "mtf_list.cuh"

namespace {

constexpr int kSelCap = 18432;
constexpr int kGroup = 50;
constexpr int kL1Bits = 12;
constexpr int kL1W = 1 << kL1Bits;
constexpr int kTabStride = kL1W + 258 * 32;
constexpr int kTabs = 6;
constexpr int kThreads = 256;
constexpr int kMeta = 3;
constexpr int kSegWarps = 4;  // B1: segments (warps) a CUDA block

constexpr int kRing = 8192;  // (s, len) entries between the two warps
constexpr uint16_t kLast = 0x8000;  // an entry that ends the decode

__device__ __forceinline__ const uint16_t* table_for(const uint16_t* tab_s,
                                                     const uint8_t* sel_s,
                                                     int gi) {
  const int t = min(gi < kSelCap ? (int)sel_s[gi] : 0, kTabs - 1);
  return tab_s + t * kTabStride;
}

__device__ __forceinline__ int warp_excl_sum(int x, int lane) {
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(mtf_list::kFull, inc, o);
    if (lane >= o) inc += y;
  }
  return inc - x;
}

__device__ __forceinline__ uint64_t warp_incl_sum64(uint64_t x, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(mtf_list::kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Shared memory: tables [6 x stride] u16 | selectors [18432] u8 | ring
// [kRing] u16 | control: head (entries published), tail (entries
// consumed), done (the decoder has stopped), stop (the records warp asks
// it to).
constexpr size_t kRingOff = (size_t)kTabs * kTabStride * 2 + kSelCap;
constexpr size_t kCtlOff = kRingOff + kRing * 2;
constexpr size_t kRecordsSmem = kCtlOff + 16;

__global__ void __launch_bounds__(kThreads)
    bzip2_records_kernel(const int32_t* __restrict__ n_used,
                         const int32_t* __restrict__ nsel,
                         const int32_t* __restrict__ sym_local,
                         const uint32_t* __restrict__ stream,
                         const int32_t* __restrict__ tab,
                         const uint8_t* __restrict__ selectors,
                         int32_t* __restrict__ recs,
                         int32_t* __restrict__ meta, int SW, int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* tab_s = reinterpret_cast<uint16_t*>(smem);
  uint8_t* sel_s = smem + (size_t)kTabs * kTabStride * 2;
  volatile uint16_t* ring = reinterpret_cast<uint16_t*>(smem + kRingOff);
  volatile int* ctl = reinterpret_cast<int*>(smem + kCtlOff);

  const int b = blockIdx.x;
  const int eob = n_used[b] + 1;
  const int ns = nsel[b];
  // An entry ends the decode where the reference's trip would end the
  // walk whatever came before it: an empty code, or a symbol at or above
  // end-of-block (which is then not a run symbol).
  const int s_last = max(eob, 2);
  const int32_t* tb = tab + (size_t)b * kTabs * kTabStride;
  for (int i = threadIdx.x; i < kTabs * kTabStride; i += blockDim.x) {
    const uint32_t e = (uint32_t)tb[i];
    const uint32_t ln = e & 31, s = e >> 5;
    tab_s[i] = (uint16_t)(ln == 31 ? ((e >> 10) << 5) | 31
                          : e | (ln == 0 || (int)s >= s_last ? kLast : 0));
  }
  const uint8_t* sb = selectors + (size_t)b * kSelCap;
  for (int i = threadIdx.x; i < kSelCap; i += blockDim.x) sel_s[i] = sb[i];
  if (threadIdx.x < 4) ctl[threadIdx.x] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 0) {
    if (lane != 0) return;
    // The decoder: one trip a symbol, each (s, len) entry into the ring.
    // buf holds the `avail` bits from bitpos, left-aligned; nw is word
    // widx, the next to append, loaded one refill ahead from L1, which a
    // prefetch keeps 96 words ahead.
    const uint32_t* sw = stream + (size_t)b * SW;
    auto word = [&](int i) { return i < SW ? __ldg(sw + i) : 0u; };
    int bitpos = sym_local[b];
    uint64_t buf = (((uint64_t)word(0) << 32) | word(1)) << bitpos;
    int avail = 64 - bitpos;
    int widx = 2;
    uint32_t nw = word(2);
    // Past bit lim the reference reads words SW - 2 and SW - 1 (its
    // clamp).
    const int lim = 32 * (SW - 1);
    const uint32_t cl0 = sw[SW - 2], cl1 = sw[SW - 1];
    int i = 0, tail = 0;
    // One trip: resolve the entry e (loaded from the bits `top`), shift
    // its code out, start the next entry's load, then hand e to the ring.
    // Returns whether e ends the decode. A group far enough from the
    // slice's end leaves the clamp out of the chain.
    uint32_t top = 0, e = 0;
    auto trip = [&](const uint16_t* tt, auto clamped) {
      if ((e & 31) == 31)
        e = tt[kL1W + (e >> 5) * 32 + ((top >> (32 - kL1Bits - 5)) & 31)];
      const int ln = (int)(e & 31);
      bitpos += ln;
      buf <<= ln;
      avail -= ln;
      if (avail <= 32) {
        buf |= (uint64_t)nw << (32 - avail);
        avail += 32;
        ++widx;
        nw = word(widx);
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            sw + min(widx + 96, SW - 1)));
      }
      top = !decltype(clamped)::value || bitpos < lim
                ? (uint32_t)(buf >> 32)
                : __funnelshift_l(cl1, cl0, bitpos & 31);
      const uint32_t now = e;
      e = tt[top >> (32 - kL1Bits)];
      ring[i++ & (kRing - 1)] = (uint16_t)now;
      return (now & kLast) != 0;
    };
    top = bitpos < lim ? (uint32_t)(buf >> 32)
                       : __funnelshift_l(cl1, cl0, bitpos & 31);
    bool last = false;
    for (int gi = 0;; ++gi) {
      const uint16_t* tt = table_for(tab_s, sel_s, gi);
      e = tt[top >> (32 - kL1Bits)];
      if (gi >= ns) {  // this trip is bad: selectors exhausted
        trip(tt, std::true_type());
        last = true;
      } else if (bitpos + kGroup * 32 <= lim) {
#pragma unroll 10
        for (int k = 0; k < kGroup; ++k) {
          if (trip(tt, std::false_type())) {
            last = true;
            break;
          }
        }
      } else {
        for (int k = 0; k < kGroup; ++k) {
          if (trip(tt, std::true_type())) {
            last = true;
            break;
          }
        }
      }
      __threadfence_block();
      ctl[0] = i;
      if (last || ctl[3]) break;
      while (i + kGroup > tail + kRing) {
        tail = ctl[1];
        if (ctl[3]) break;
      }
      if (ctl[3]) break;
    }
    __threadfence_block();
    ctl[2] = 1;
    return;
  }
  if (warp != 1) return;

  // The records warp: RLE2 over 32 trips at a time, a lane a trip; warp
  // scans carry the bit position, the run and the record count across
  // them. It finds the first trip that ends the walk and stamps meta as
  // the reference's walk does, the held trip after a flush included.
  int32_t* orow = recs + (size_t)b * S;
  int bitpos = sym_local[b], nrec = 0, run_acc = 0, run_bit = 0;
  for (int c = 0;; c += 32) {
    int h;
    for (;;) {
      const int fin = ctl[2];
      __threadfence_block();
      h = ctl[0];
      if (h >= c + 32 || fin) break;
      __nanosleep(256);
    }
    __threadfence_block();
    if (h <= c) {  // cannot happen: the decoder's last entry ends the walk
      if (lane == 0) {
        ctl[3] = 1;
        meta[(size_t)b * kMeta + 0] = nrec;
        meta[(size_t)b * kMeta + 1] = (int32_t)((uint32_t)(bitpos + 1) << 10);
        meta[(size_t)b * kMeta + 2] = bitpos;
      }
      return;
    }
    const int t = c + lane;
    const bool valid = t < h;
    const uint32_t e = valid ? ring[t & (kRing - 1)] & (kLast - 1) : 0;
    const int ln = (int)(e & 31), s = (int)(e >> 5);
    const bool is_run = s <= 1;
    const int bp = bitpos + warp_excl_sum(ln, lane);
    // The run before this trip: the runs of the lanes after the last
    // non-run lane below, or the carried run and every lane below.
    const unsigned nonrun = __ballot_sync(mtf_list::kFull, valid && !is_run);
    const unsigned below = nonrun & ((1u << lane) - 1);
    const int p = below ? 31 - __clz(below) : -1;
    const int kbit = p >= 0 ? lane - p - 1 : run_bit + lane;
    const uint64_t add = is_run && valid
                             ? (uint64_t)(s + 1) << min(kbit, 40) : 0;
    const uint64_t incl = warp_incl_sum64(add, lane);
    const uint64_t at_p = __shfl_sync(mtf_list::kFull, incl, max(p, 0));
    const uint64_t run = incl - add - (p >= 0 ? at_p : 0) +
                         (p >= 0 ? 0 : (uint64_t)run_acc);
    const bool flush = !is_run && run > 0;
    const bool lit = !is_run && s != eob;
    const int nr = nrec + warp_excl_sum(flush + lit, lane);
    const uint32_t why = (ln == 0 ? 1u : 0u) | (t / kGroup >= ns ? 2u : 0u) |
                         (s > eob ? 4u : 0u) | (run > (1u << 21) ? 8u : 0u) |
                         (nr >= S - 2 ? 16u : 0u);
    const bool capped = !why && flush && nr + 1 >= S - 2;
    const bool ends = why || capped || (!is_run && s == eob);
    const unsigned endm = __ballot_sync(mtf_list::kFull, valid && ends);
    const int first = endm ? __ffs(endm) - 1 : 32;
    if (valid && lane <= first) {
      if (flush) orow[nr] = (int32_t)((uint32_t)run << 8);  // rank 0
      if (lit && !why && !capped)
        orow[nr + flush] = (int32_t)((1u << 8) | (uint32_t)min(s - 1, 255));
    }
    if (endm) {
      if (lane == first) {
        meta[(size_t)b * kMeta + 0] = nr + flush;
        meta[(size_t)b * kMeta + 1] =
            (int32_t)(why ? why | ((uint32_t)(bp + 1) << 10)
                          : capped ? 16u | ((uint32_t)(bp + ln + 1) << 10)
                                   : 0u);
        meta[(size_t)b * kMeta + 2] = why ? bp : bp + ln;
        ctl[3] = 1;
      }
      return;
    }
    // Carry to the next 32 trips, from lane 31.
    bitpos = __shfl_sync(mtf_list::kFull, bp + ln, 31);
    nrec = __shfl_sync(mtf_list::kFull, nr + flush + lit, 31);
    run_acc = __shfl_sync(mtf_list::kFull, is_run ? (int)(run + add) : 0, 31);
    run_bit = __shfl_sync(mtf_list::kFull, is_run ? kbit + 1 : 0, 31);
    if (lane == 0) ctl[1] = c + 32;
  }
}

// B1: grid (segments / kSegWarps, NB).
__global__ void __launch_bounds__(32 * kSegWarps)
    mtf_labels_kernel(int32_t* __restrict__ recs,
                      const int32_t* __restrict__ meta,
                      uint8_t* __restrict__ lists, int S, int seg,
                      int nseg) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int nrec = meta[(size_t)b * kMeta];
  if (k >= nseg || (long long)k * seg >= nrec) return;
  const int lo = k * seg;
  const int hi = lo + min(seg, nrec - lo);
  int32_t* row = recs + (size_t)b * S;

  uint64_t list = mtf_list::identity(lane);
  int head = 0;
  int32_t next = lo + lane < hi ? row[lo + lane] : 0;
  for (int base = lo; base < hi; base += 32) {
    const int32_t cur = next;
    const int ahead = base + 32 + lane;
    next = ahead < hi ? row[ahead] : 0;
    const int cnt = min(32, hi - base);
    int label = 0;
    for (int t = 0; t < cnt; ++t) {
      const int j = __shfl_sync(mtf_list::kFull, cur, t) & 0xff;
      if (j != 0) {
        head = mtf_list::at(list, j);
        list = mtf_list::move_to_front(list, j, head, lane);
      }
      if (lane == t) label = head;
    }
    if (base + lane < hi) row[base + lane] = (cur & ~0xff) | label;
  }
  reinterpret_cast<uint64_t*>(lists + ((size_t)b * nseg + k) * 256)[lane] =
      list;
}

// B2: grid NB, 256 threads (one per list position).
__global__ void __launch_bounds__(256)
    mtf_lists_kernel(const int32_t* __restrict__ meta,
                     const uint8_t* __restrict__ mtf_init,
                     const uint8_t* __restrict__ labels,
                     uint8_t* __restrict__ starts, int seg, int nseg) {
  __shared__ uint8_t cur[256];
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int nrec = meta[(size_t)b * kMeta];
  const int live = nrec > 0 ? min((nrec - 1) / seg + 1, nseg) : 0;
  const uint8_t* pb = labels + (size_t)b * nseg * 256;
  uint8_t* lb = starts + (size_t)b * nseg * 256;
  uint8_t v = mtf_init[(size_t)b * 256 + i];
  uint8_t p = live > 0 ? pb[i] : 0;
  for (int k = 0; k < live; ++k) {
    lb[(size_t)k * 256 + i] = v;
    const uint8_t pn = k + 1 < live ? pb[(size_t)(k + 1) * 256 + i] : 0;
    cur[i] = v;
    __syncthreads();
    v = cur[p];
    __syncthreads();
    p = pn;
  }
}

// B3: grid (x, NB), grid-stride over each block's records.
__global__ void __launch_bounds__(256)
    mtf_bytes_kernel(int32_t* __restrict__ recs,
                     const int32_t* __restrict__ meta,
                     const uint8_t* __restrict__ starts, int S, int seg,
                     int nseg) {
  const int b = blockIdx.y;
  const int nrec = meta[(size_t)b * kMeta];
  const uint8_t* lb = starts + (size_t)b * nseg * 256;
  int32_t* row = recs + (size_t)b * S;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nrec;
       i += gridDim.x * blockDim.x) {
    const int32_t r = row[i];
    row[i] = (r & ~0xff) | lb[(size_t)(i / seg) * 256 + (r & 0xff)];
  }
}

}  // namespace

// n_used, nsel, sym_local [NB] int32; stream [NB, SW] big-endian u32
// words; tab [NB, 6 x 12352] int32; selectors [NB, 18432] and mtf_init
// [NB, 256] uint8; recs [NB, S] and meta [NB, 3] int32; labels and starts
// [NB, ceil(S / seg), 256] uint8 scratch (P_k and L_k). Runs one pass:
// 0 records, 1 labels (B1), 2 lists (B2), 3 bytes (B3); the caller runs
// them in order on one stream. Returns a cudaError_t.
extern "C" int tpz_bzip2_walk(const void* n_used, const void* nsel,
                              const void* sym_local, const void* stream,
                              const void* tab, const void* selectors,
                              const void* mtf_init, void* recs, void* meta,
                              void* labels, void* starts, int NB, int SW,
                              int S, int seg, int pass,
                              cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  const int nseg = (S - 1) / seg + 1;
  int32_t* r = static_cast<int32_t*>(recs);
  const int32_t* m = static_cast<const int32_t*>(meta);
  if (pass == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        bzip2_records_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kRecordsSmem);
    if (err != cudaSuccess) return (int)err;
    bzip2_records_kernel<<<NB, kThreads, kRecordsSmem, cuda_stream>>>(
        static_cast<const int32_t*>(n_used),
        static_cast<const int32_t*>(nsel),
        static_cast<const int32_t*>(sym_local),
        static_cast<const uint32_t*>(stream),
        static_cast<const int32_t*>(tab),
        static_cast<const uint8_t*>(selectors), r,
        static_cast<int32_t*>(meta), SW, S);
  } else if (pass == 1) {
    mtf_labels_kernel<<<dim3((nseg + kSegWarps - 1) / kSegWarps, NB),
                        32 * kSegWarps, 0, cuda_stream>>>(
        r, m, static_cast<uint8_t*>(labels), S, seg, nseg);
  } else if (pass == 2) {
    mtf_lists_kernel<<<NB, 256, 0, cuda_stream>>>(
        m, static_cast<const uint8_t*>(mtf_init),
        static_cast<const uint8_t*>(labels), static_cast<uint8_t*>(starts),
        seg, nseg);
  } else if (pass == 3) {
    const int gx = (S + 255) / 256 < 1024 ? (S + 255) / 256 : 1024;
    mtf_bytes_kernel<<<dim3(gx, NB), 256, 0, cuda_stream>>>(
        r, m, static_cast<const uint8_t*>(starts), S, seg, nseg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
