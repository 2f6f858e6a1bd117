// Inverse BWT on Hopper: list ranking by splitters, walking each chain
// once, in three kernels (walk, stitch, place).
//
// Replaces tpz/kernels/ibwt_walk.py::_walk_kernel (the Pallas slot walk)
// and the stitch and placement sort around it in ibwt_body. Input: w
// [NB, N] = tvec << 8 | last at each live node (tvec, the LF-mapping
// permutation, from a torch sort), the start node start_g = tvec[orig]
// and the length n of each block. Node j with (j & (SEG-1)) == 0, and
// the start node, are splitters; chain c < K = ceil(n / SEG) starts at
// node c * SEG, and chain K at the start node when that is not already a
// regular splitter.
//   walk    one thread per chain walks to the next splitter: its length,
//           its successor chain, and its bytes in walk order, staged in
//           chunks of CAP bytes (the chain's own chunk, then chunks taken
//           from its block's pool of N / CAP + 1 and linked)
//   stitch  one CUDA block per bzip2 block ranks the live chains: every
//           live chain's successor must be a live chain and no chain may
//           have two predecessors (a bitmap), so the successors are a
//           permutation; then pointer jumping over them, cut at the start
//           chain (log2 of the chains rounds, in shared memory where the
//           block's chains fit and in global memory otherwise) gives each
//           chain the bytes from it to the end, and the start chain's
//           total must be n (then its cycle holds every live chain).
//           (Shared memory holds 2 int32 and a bit a live chain: 28,126
//           chains, a 900 k bzip2 block at SEG 32, fit its 227 KiB.)
//           That is the serial stitch's check (visit every live chain
//           once, come back to the start chain, cover n bytes); a block
//           that fails it (a periodic block, whose LF map has several
//           cycles; a row of length 0; a chain cut at n + 1 steps; a pool
//           run dry, which only a block whose chains sum past N can do)
//           is flagged and its offsets cleared
//   place   eight threads per chain copy its staged chunks to out at its
//           offset, a word each (32 bytes an instruction)
// The TPU version's 8 interleaved slot streams, their cap (CAP) and the
// placement sort do not carry over: offsets come from the stitch, so no
// block is declined for capacity.
//
// What bounds it: every step of the walk is a dependent load of a random
// node of a 4 MiB row (N = 2^20), and the batch's rows (151 MB at the
// bzip2 headline) do not fit in the 50 MB L2, so a walk costs about one
// 32-byte sector a step; and it lasts as long as its longest chain
// (segment lengths are about exponential, the longest some ln(chains) x
// SEG). A shorter stride shortens that tail. Walk threads resident
// together, taken in chain order, read only a few rows at a time, so the
// launch caps them (`resident` an SM, padding each block's shared
// memory): at SEG 32, 1,024 an SM cover ~4 rows, whose sectors then stay
// in L2 (1.2x faster than 2,048 on an H100; PERF.md). The stitch,
// log-depth in the chains of a block, and the flat copy of the placement
// grow with the chain count but stay small. The
// staged bytes cost a store every four steps and one coalesced copy, in
// place of a second walk of dependent loads (per-node records of chain
// and rank and a scatter, which write and read 8 random bytes a node,
// measured 3.7x slower on an H100 at SEG 32; PERF.md).
//
// Inputs as ibwt_walk.lf_inputs makes them: 0 <= length <= N and every
// live node's successor below N.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWalkThreads = 64;
constexpr int kStitchThreads = 1024;
constexpr int kStitchItems = 4;  // chains a thread holds in a round
constexpr int kPlaceThreads = 256;
constexpr int kPlaceLanes = 8;   // threads a chain in the placement, each
                                 // copying a word of the chain's 32 bytes
constexpr int kTerm = -2;        // the pointer of a chain whose successor
                                 // is the start chain
constexpr uint32_t kSat = 1u << 30;  // sums saturate (only a block that
                                     // fails its checks gets there)

struct Chain {
  int b, c, n, sg, K, n_live, start_id;
};

__device__ __forceinline__ Chain chain_of(long long id, int KC, int m,
                                          const int32_t* start_g,
                                          const int32_t* length) {
  Chain ch;
  ch.b = (int)(id / KC);
  ch.c = (int)(id % KC);
  ch.n = length[ch.b];
  ch.sg = start_g[ch.b];
  const int seg = 1 << m;
  ch.K = (ch.n + seg - 1) >> m;
  const bool sg_reg = (ch.sg & (seg - 1)) == 0;
  ch.n_live = ch.n >= 1 ? ch.K + (sg_reg ? 0 : 1) : 0;
  ch.start_id = sg_reg ? ch.sg >> m : ch.K;
  return ch;
}

// Dynamic shared memory for each walk block, unused, so that at most
// `resident` walk threads share an SM (0: no cap, as many as fit).
size_t walk_smem(int resident) {
  if (resident <= 0) return 0;
  int dev = 0, per_sm = 0, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  const int blocks = resident / kWalkThreads > 1 ? resident / kWalkThreads : 1;
  // Each block takes its request plus the reserve, in 128-byte units.
  const int take = per_sm / blocks / 128 * 128 - reserved;
  return take > 0 ? (size_t)take : 0;
}

// The stitch's shared memory for n chains: pointers, sums, bitmap.
__host__ __device__ size_t stitch_shared(int n) {
  return (size_t)(2 * n + ((n + 31) >> 5)) * sizeof(int32_t);
}

struct Scratch {
  int32_t *len, *succ, *goff, *link, *bitmap, *pool_top, *spill;
  uint8_t* stage;  // the staged chunks
};

__global__ void __launch_bounds__(kWalkThreads)
    ibwt_rank_walk(const int32_t* __restrict__ w,
                   const int32_t* __restrict__ start_g,
                   const int32_t* __restrict__ length, Scratch s, int NB,
                   int N, int m, int KC, int CAP, int PC) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)NB * KC) return;
  const Chain ch = chain_of(id, KC, m, start_g, length);
  if (ch.c >= ch.n_live) {
    s.len[id] = 0;
    s.succ[id] = -1;
    return;
  }
  const int32_t* wb = w + (size_t)ch.b * N;
  const int mask = (1 << m) - 1;
  int cur = ch.c == ch.K ? ch.sg : ch.c << m;
  int cnt = 0, nx = -1;
  // Bytes go out four at a time into chunk `chunk` at byte r.
  long long chunk = id;
  int r = 0;
  uint32_t acc = 0;
  bool staging = true;
  for (;;) {
    const uint32_t v = (uint32_t)wb[min(max(cur, 0), N - 1)];
    if (staging) {
      acc |= (v & 255u) << (8 * (r & 3));
      if ((++r & 3) == 0) {
        *reinterpret_cast<uint32_t*>(s.stage + chunk * CAP + r - 4) = acc;
        acc = 0;
      }
    }
    const int nxt = (int)(v >> 8);
    ++cnt;
    if ((nxt & mask) == 0 || nxt == ch.sg) {
      nx = nxt == ch.sg ? ch.start_id : nxt >> m;
      break;
    }
    if (cnt > ch.n) break;  // longer than the block: not one cycle
    cur = nxt;
    if (staging && r == CAP) {  // the chain goes on: link a pool chunk
      const int j = atomicAdd(s.pool_top + ch.b, 1);
      if (j >= PC) {
        s.spill[ch.b] = 1;
        staging = false;
      } else {
        const long long next = (long long)NB * KC + (long long)ch.b * PC + j;
        s.link[chunk] = (int32_t)next;
        chunk = next;
        r = 0;
      }
    }
  }
  if (staging && (r & 3))
    *reinterpret_cast<uint32_t*>(s.stage + chunk * CAP + (r & ~3)) = acc;
  s.len[id] = cnt;
  s.succ[id] = nx;
}

__global__ void __launch_bounds__(kStitchThreads)
    ibwt_rank_stitch(const int32_t* __restrict__ start_g,
                     const int32_t* __restrict__ length, Scratch s,
                     int32_t* __restrict__ flag, int m, int KC,
                     int smem_bytes) {
  extern __shared__ int32_t sh[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t base = (size_t)b * KC;
  const Chain ch = chain_of((long long)b * KC, KC, m, start_g, length);
  const int nl = ch.n_live;
  // Pointer and bytes-to-the-end of each live chain, and the bitmap of
  // chains that have a predecessor: in shared memory where the block's
  // live chains fit, else in global memory, where the pointers take the
  // successors' place and the sums the offsets'.
  int32_t *P, *S, *bm;
  const int nw = min(nl, KC);
  const int BW = (nw + 31) >> 5;
  if (stitch_shared(nw) <= (size_t)smem_bytes) {
    P = sh;
    S = sh + nw;
    bm = sh + 2 * nw;
  } else {
    P = s.succ + base;
    S = s.goff + base;
    bm = s.bitmap + (size_t)b * ((KC + 31) >> 5);
  }
  for (int i = t; i < BW; i += blockDim.x) bm[i] = 0;
  __syncthreads();
  int bad = ch.n < 1 || nl > KC || ch.start_id < 0 || ch.start_id >= nl ||
            s.spill[b] != 0;
  if (!bad) {
    for (int c = t; c < nl; c += blockDim.x) {
      const int nx = s.succ[base + c];
      const int32_t ln = s.len[base + c];
      if (nx < 0 || nx >= nl) {
        bad = 1;
      } else {
        const uint32_t bit = 1u << (nx & 31);
        if (atomicOr(reinterpret_cast<unsigned*>(bm) + (nx >> 5), bit) & bit)
          bad = 1;
      }
      P[c] = nx == ch.start_id ? kTerm : nx;
      S[c] = ln;
    }
  }
  bad = __syncthreads_or(bad);
  if (!bad) {
    // Rounds of pointer jumping. Each round reads a slice of the chains'
    // pointers and sums, then writes them back after a barrier, so no
    // read sees half an update; a later slice may read what an earlier
    // one wrote, which only jumps further.
    const int rounds = 33 - __clz(nl);
    for (int round = 0; round < rounds; ++round) {
      int moved = 0;
      for (int c0 = 0; c0 < nl; c0 += kStitchItems * blockDim.x) {
        int np[kStitchItems], ns[kStitchItems];
#pragma unroll
        for (int j = 0; j < kStitchItems; ++j) {
          const int c = c0 + j * blockDim.x + t;
          np[j] = kTerm;
          if (c < nl) {
            const int p = P[c];
            if (p != kTerm) {
              np[j] = P[p];
              ns[j] = (int)min((uint32_t)S[c] + (uint32_t)S[p], kSat);
            }
          }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kStitchItems; ++j) {
          const int c = c0 + j * blockDim.x + t;
          if (c < nl && P[c] != kTerm) {
            P[c] = np[j];
            S[c] = ns[j];
            moved = 1;
          }
        }
        __syncthreads();
      }
      if (!__syncthreads_or(moved)) break;
    }
    // One cycle: the successors are a permutation of the live chains,
    // each chain holds at least one node and no node is in two chains, so
    // the start chain's cycle covers n nodes only if it holds them all.
    bad = S[ch.start_id] != ch.n;
  }
  __syncthreads();
  for (int c = t; c < KC; c += blockDim.x)
    s.goff[base + c] = !bad && c < nl ? ch.n - S[c] : -1;
  if (t == 0) flag[b] = bad ? 1 : 0;
}

// The placement: eight threads a chain copy its chunks to out at its
// offset, a word each (32 bytes an instruction); the stitch cleared the
// offsets of a flagged block.
__global__ void __launch_bounds__(kPlaceThreads)
    ibwt_rank_place(const Scratch s, uint8_t* __restrict__ out, int NB,
                    int N, int KC, int CAP) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long id = t / kPlaceLanes;
  const int lane = (int)(t % kPlaceLanes);
  if (id >= (long long)NB * KC) return;
  const int g = s.goff[id];
  if (g < 0) return;
  const int len = s.len[id];
  uint8_t* ob = out + (size_t)(id / KC) * N + g;
  long long chunk = id;
  for (int r0 = 0; r0 < len; r0 += CAP) {
    if (r0 > 0) chunk = s.link[chunk];
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(s.stage + chunk * CAP);
    const int take = min(CAP, len - r0);
    for (int r = 4 * lane; r < take; r += 4 * kPlaceLanes) {
      const uint32_t v = src[r >> 2];
      const int k = min(4, take - r);
      for (int j = 0; j < k; ++j) ob[r0 + r + j] = (uint8_t)(v >> (8 * j));
    }
  }
}

}  // namespace

// w [NB, N] int32, start_g / length [NB] int32; scratch int32: chain
// lengths, successors, offsets [NB, KC] each, chunk links [NB * KC + NB *
// PC], the stitch's bitmap [NB, ceil(KC / 32)], pool tops and spill flags
// [NB] each (zeroed here); stage [(NB * KC + NB * PC) * CAP] bytes; out
// [NB, N] uint8 zeroed by the caller, flag [NB] int32; SEG = 1 << m, KC =
// N / SEG + 1 chains a block, CAP a multiple of 4; at most `resident`
// walk threads an SM (0: no cap). Returns a cudaError_t.
extern "C" int tpz_ibwt_walk(const void* w, const void* start_g,
                             const void* length, void* scratch, void* stage,
                             void* out, void* flag, int NB, int N,
                             int m, int KC, int CAP, int PC, int resident,
                             cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  if (CAP < 4 || (CAP & 3) || PC < 1) return (int)cudaErrorInvalidValue;
  const size_t chains = (size_t)NB * KC;
  Scratch s;
  s.len = static_cast<int32_t*>(scratch);
  s.succ = s.len + chains;
  s.goff = s.succ + chains;
  s.link = s.goff + chains;
  s.bitmap = s.link + chains + (size_t)NB * PC;
  s.pool_top = s.bitmap + (size_t)NB * ((KC + 31) >> 5);
  s.spill = s.pool_top + NB;
  s.stage = static_cast<uint8_t*>(stage);
  cudaError_t err = cudaMemsetAsync(s.pool_top, 0, 2 * NB * sizeof(int32_t),
                                    cuda_stream);
  if (err != cudaSuccess) return (int)err;
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* sg = static_cast<const int32_t*>(start_g);
  const auto* ln = static_cast<const int32_t*>(length);
  const size_t wsmem = walk_smem(resident);
  if (wsmem > 48 * 1024) {
    err = cudaFuncSetAttribute(ibwt_rank_walk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)wsmem);
    if (err != cudaSuccess) return (int)err;
  }
  ibwt_rank_walk<<<(unsigned)((chains + kWalkThreads - 1) / kWalkThreads),
                   kWalkThreads, wsmem, cuda_stream>>>(wp, sg, ln, s, NB, N,
                                                       m, KC, CAP, PC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // As much shared memory as a block may hold, up to what all KC chains
  // need: a block whose live chains fit it stitches there.
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t smem = stitch_shared(KC) < (size_t)limit ? stitch_shared(KC)
                                                        : (size_t)limit;
  err = cudaFuncSetAttribute(ibwt_rank_stitch,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ibwt_rank_stitch<<<NB, kStitchThreads, smem, cuda_stream>>>(
      sg, ln, s, static_cast<int32_t*>(flag), m, KC, (int)smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t threads = chains * kPlaceLanes;
  ibwt_rank_place<<<(unsigned)((threads + kPlaceThreads - 1) /
                               kPlaceThreads),
                    kPlaceThreads, 0, cuda_stream>>>(
      s, static_cast<uint8_t*>(out), NB, N, KC, CAP);
  return (int)cudaGetLastError();
}

// Walk threads resident per SM when at most `resident` are asked for (0:
// no cap), from the occupancy calculator; -1 on error.
extern "C" int tpz_ibwt_walk_resident(int resident) {
  const size_t wsmem = walk_smem(resident);
  if (wsmem > 48 * 1024 &&
      cudaFuncSetAttribute(ibwt_rank_walk,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ibwt_rank_walk, kWalkThreads, wsmem) != cudaSuccess)
    return -1;
  return blocks * kWalkThreads;
}
