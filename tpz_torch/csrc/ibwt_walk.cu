// Inverse BWT walk on Hopper: list ranking by splitters, in three
// kernels (pass 1, stitch, pass 2).
//
// Replaces tpz/kernels/ibwt_walk.py::_walk_kernel (the Pallas slot walk)
// and the stitch and placement sort around it in ibwt_body. Input: w
// [NB, N] = tvec << 8 | last at each live node (tvec, the LF-mapping
// permutation, from a torch sort), the start node start_g = tvec[orig]
// and the length n of each block. Node j with (j & (SEG-1)) == 0, and
// the start node, are splitters; chain c < K = ceil(n / SEG) starts at
// node c * SEG, and chain K at the start node when that is not already a
// regular splitter.
//   pass 1  one thread per chain walks to the next splitter: its length
//           and its successor chain
//   stitch  one block per bzip2 block follows the successors from the
//           start chain over the live chains, in shared memory, giving
//           each chain its output offset. The walk must visit every live
//           chain once, come back to the start chain and cover n bytes;
//           otherwise (a periodic block, whose LF map has several
//           cycles) the block is flagged and its offsets cleared
//   pass 2  one thread per chain walks again and writes its bytes at its
//           offset
// The TPU version's 8 interleaved slot streams, their cap (CAP) and the
// placement sort do not carry over: offsets come from the stitch, so no
// block is declined for capacity.
//
// What bounds it: every step is a dependent load of a random node of a
// 4 MiB row (N = 2^20), and the batch's rows do not fit in the 50 MB L2,
// so a pass is latency-bound at about one DRAM access per step and chain.
// Its time is the longest chain's (segment lengths are about
// exponential, the longest some ln(chains) x SEG), so a smaller SEG
// shortens the tail and puts more loads in flight; the stitch, serial in
// the chains of a block, then grows, which the shared-memory copy of its
// arrays keeps cheap.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kPassThreads = 64;
constexpr int kStitchThreads = 256;

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

__global__ void __launch_bounds__(kPassThreads)
    ibwt_pass1(const int32_t* __restrict__ w,
               const int32_t* __restrict__ start_g,
               const int32_t* __restrict__ length, int32_t* __restrict__ len,
               int32_t* __restrict__ succ, int32_t* __restrict__ goff,
               int NB, int N, int m, int KC) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)NB * KC) return;
  const Chain ch = chain_of(id, KC, m, start_g, length);
  goff[id] = -1;
  if (ch.c >= ch.n_live) {
    len[id] = 0;
    succ[id] = -1;
    return;
  }
  const int32_t* wb = w + (size_t)ch.b * N;
  const int mask = (1 << m) - 1;
  int cur = ch.c == ch.K ? ch.sg : ch.c << m;
  int cnt = 0, nx = -1;
  for (;;) {
    const int nxt = (int)((uint32_t)wb[min(max(cur, 0), N - 1)] >> 8);
    ++cnt;
    if ((nxt & mask) == 0 || nxt == ch.sg) {
      nx = nxt == ch.sg ? ch.start_id : nxt >> m;
      break;
    }
    if (cnt > ch.n) break;  // longer than the block: not one cycle
    cur = nxt;
  }
  len[id] = cnt;
  succ[id] = nx;
}

__global__ void __launch_bounds__(kStitchThreads)
    ibwt_stitch(const int32_t* __restrict__ start_g,
                const int32_t* __restrict__ length,
                const int32_t* __restrict__ len,
                const int32_t* __restrict__ succ, int32_t* __restrict__ goff,
                int32_t* __restrict__ flag, int m, int KC) {
  extern __shared__ int32_t s[];
  int32_t* len_s = s;
  int32_t* succ_s = s + KC;
  int32_t* goff_s = s + 2 * KC;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * KC;
  for (int i = threadIdx.x; i < KC; i += blockDim.x) {
    len_s[i] = len[base + i];
    succ_s[i] = succ[base + i];
    goff_s[i] = -1;
  }
  __syncthreads();
  __shared__ int ok_s;
  if (threadIdx.x == 0) {
    const Chain ch = chain_of((long long)b * KC, KC, m, start_g, length);
    bool ok = ch.n >= 1;
    int at = ch.start_id;
    long long acc = 0;
    for (int i = 0; ok && i < ch.n_live; ++i) {
      if (at < 0 || at >= KC || goff_s[at] >= 0) {
        ok = false;
        break;
      }
      goff_s[at] = (int32_t)acc;
      acc += len_s[at];
      at = succ_s[at];
    }
    ok = ok && at == ch.start_id && acc == ch.n;
    flag[b] = ok ? 0 : 1;
    ok_s = ok;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KC; i += blockDim.x)
    goff[base + i] = ok_s ? goff_s[i] : -1;
}

__global__ void __launch_bounds__(kPassThreads)
    ibwt_pass2(const int32_t* __restrict__ w,
               const int32_t* __restrict__ start_g,
               const int32_t* __restrict__ length,
               const int32_t* __restrict__ len,
               const int32_t* __restrict__ goff, uint8_t* __restrict__ out,
               int NB, int N, int m, int KC) {
  const long long id = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= (long long)NB * KC) return;
  const int g = goff[id];
  if (g < 0) return;
  const Chain ch = chain_of(id, KC, m, start_g, length);
  const int32_t* wb = w + (size_t)ch.b * N;
  uint8_t* ob = out + (size_t)ch.b * N + g;
  int cur = ch.c == ch.K ? ch.sg : ch.c << m;
  const int cnt = len[id];
  for (int i = 0; i < cnt; ++i) {
    const uint32_t v = (uint32_t)wb[min(cur, N - 1)];
    ob[i] = (uint8_t)(v & 255);
    cur = (int)(v >> 8);
  }
}

}  // namespace

// w [NB, N] int32, start_g / length [NB] int32, scratch [3, NB, KC] int32
// (chain lengths, successors, offsets), out [NB, N] uint8 zeroed by the
// caller, flag [NB] int32; SEG = 1 << m, KC = N / SEG + 1 chains a block.
// Returns a cudaError_t.
extern "C" int tpz_ibwt_walk(const void* w, const void* start_g,
                             const void* length, void* scratch, void* out,
                             void* flag, int NB, int N, int m, int KC,
                             cudaStream_t cuda_stream) {
  if (NB == 0) return 0;
  int32_t* len = static_cast<int32_t*>(scratch);
  int32_t* succ = len + (size_t)NB * KC;
  int32_t* goff = succ + (size_t)NB * KC;
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* sg = static_cast<const int32_t*>(start_g);
  const auto* ln = static_cast<const int32_t*>(length);
  const long long chains = (long long)NB * KC;
  const int grid = (int)((chains + kPassThreads - 1) / kPassThreads);
  ibwt_pass1<<<grid, kPassThreads, 0, cuda_stream>>>(wp, sg, ln, len, succ,
                                                     goff, NB, N, m, KC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)3 * KC * sizeof(int32_t);
  err = cudaFuncSetAttribute(ibwt_stitch,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ibwt_stitch<<<NB, kStitchThreads, smem, cuda_stream>>>(
      sg, ln, len, succ, goff, static_cast<int32_t*>(flag), m, KC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ibwt_pass2<<<grid, kPassThreads, 0, cuda_stream>>>(
      wp, sg, ln, len, goff, static_cast<uint8_t*>(out), NB, N, m, KC);
  return (int)cudaGetLastError();
}
