// CRC-32 of a byte buffer on Hopper: chunk registers, then a tree of
// GF(2) shift matrices.
//
// Replaces the XLA stage tpz/kernels/checksums.py::_crc_lanes, a
// fori_loop over 32-bit words with one lane per chunk (512 lanes, each
// step 32 select-and-xor vector ops), whose chunk registers the reference
// combines on the host. It is not a Pallas kernel: this is a hand kernel
// for an XLA stage that eager torch would run as ~100 launches a word
// step, ~8 x 10^5 launches at 16 MiB.
//
// CRC-32 is linear over GF(2): the register after A||B from a zero
// register is Shift(|B|) . reg(A) ^ reg(B), where Shift(k) is the 32x32
// matrix that advances the register by k zero bytes. So the buffer is cut
// into L chunks of `chunk` bytes, aligned to its end (chunk 0 is the
// short one: front zero padding leaves a zero register as it is), and
//   P0 chunks (a thread a chunk): the zero-initialised register of the
//      chunk. Bytes come 16 at a time once the address is aligned, and
//      go 4 at a time through the slice-by-4 tables, which the block
//      stages in shared memory: T_k[v] is byte v's register advanced by
//      k more zero bytes, so a word xored into the register leaves it as
//      T3[byte 0] ^ T2[byte 1] ^ T1[byte 2] ^ T0[byte 3] (bytes in
//      stream order), four loads that do not wait on each other. The
//      unaligned head and the tail go a byte at a time through T0.
//   P1 fold (a CUDA block of 1,024 threads per 1,024 registers, run
//      until one register is left): a tree. At level k a pair of
//      neighbours, each the register of s * 2^k bytes (s the bytes one
//      input register covers), becomes Shift(s * 2^k) . left ^ right:
//      five levels by warp shuffles, then five over the 32 warps' results.
//      Groups are aligned to the end as well, with zero registers in
//      front of the first.
// `mats` holds Shift(chunk * 2^l) for l = 0.., one matrix a level, each a
// column per input bit (the host squares the previous one); a fold pass
// over registers of chunk * 1024^p bytes reads levels 10p .. 10p + 9.
//
// What bounds it: the bytes are read once (16 MiB: 5 us at 3.35 TB/s),
// but each thread's chunk is one chain of dependent table loads from
// shared memory. A byte table makes it a load (with bank conflicts) and
// a few ALU ops a byte; slice-by-4 makes it one round of four loads and
// the xors a word. Short chunks give more chains in flight (16 MiB at 1
// KiB: 16,384 threads) and more registers to fold; the fold is ~10
// levels of 32 and-xors per register on a tree, a few us a pass.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunkThreads = 256;
constexpr int kFold = 1024;        // registers one fold block takes
constexpr int kFoldLevels = 10;    // log2(kFold)
constexpr unsigned kFull = 0xffffffffu;

template <bool kReflected>
__device__ __forceinline__ uint32_t step(const uint32_t* t, uint32_t s,
                                         uint32_t b) {
  if (kReflected) return (s >> 8) ^ t[(s ^ b) & 0xffu];
  return (s << 8) ^ t[((s >> 24) ^ b) & 0xffu];
}

// Four bytes at once; t holds T0..T3 of 256 entries each. The word is
// loaded little-endian: its low byte comes first in the stream.
template <bool kReflected>
__device__ __forceinline__ uint32_t step4(const uint32_t* t, uint32_t s,
                                          uint32_t w) {
  if (kReflected) {
    s ^= w;
    return t[768 + (s & 0xffu)] ^ t[512 + ((s >> 8) & 0xffu)] ^
           t[256 + ((s >> 16) & 0xffu)] ^ t[s >> 24];
  }
  s ^= __byte_perm(w, 0, 0x0123);  // the stream's first byte on top
  return t[768 + (s >> 24)] ^ t[512 + ((s >> 16) & 0xffu)] ^
         t[256 + ((s >> 8) & 0xffu)] ^ t[s & 0xffu];
}

// P0: grid ceil(L / 256), 256 threads; table [4, 256].
template <bool kReflected>
__global__ void __launch_bounds__(kChunkThreads)
    crc32_chunks(const uint8_t* __restrict__ data, long long n, int chunk,
                 long long L, const uint32_t* __restrict__ table,
                 uint64_t* __restrict__ regs) {
  __shared__ uint32_t t[4 * 256];
  for (int i = threadIdx.x; i < 4 * 256; i += kChunkThreads) t[i] = table[i];
  __syncthreads();
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= L) return;
  const long long front = L * chunk - n;  // zero bytes before chunk 0
  long long lo = k * chunk - front;
  const long long hi = lo + chunk;
  if (lo < 0) lo = 0;
  uint32_t s = 0;
  long long i = lo;
  for (; i < hi && (reinterpret_cast<uintptr_t>(data + i) & 15); ++i)
    s = step<kReflected>(t, s, data[i]);
  for (; i + 16 <= hi; i += 16) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(data + i));
    s = step4<kReflected>(t, s, w.x);
    s = step4<kReflected>(t, s, w.y);
    s = step4<kReflected>(t, s, w.z);
    s = step4<kReflected>(t, s, w.w);
  }
  for (; i < hi; ++i) s = step<kReflected>(t, s, data[i]);
  regs[k] = s;
}

__device__ __forceinline__ uint32_t apply(const uint32_t* cols, uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) out ^= cols[j] & (0u - ((v >> j) & 1u));
  return out;
}

// Five tree levels across a warp's 32 registers, with the matrices of
// levels lev .. lev + 4; lane 0 ends with the warp's register.
__device__ __forceinline__ uint32_t warp_tree(uint32_t r, const uint32_t* m,
                                              int lev, int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t right = __shfl_down_sync(kFull, r, 1 << k);
    if ((lane & ((2 << k) - 1)) == 0)
      r = apply(m + (lev + k) * 32, r) ^ right;
  }
  return r;
}

// P1: grid ceil(m / 1024) (after `pad` zero registers in front), 1,024
// threads; mats points at the pass's first level.
__global__ void __launch_bounds__(kFold)
    crc32_fold(const uint64_t* __restrict__ x, long long m, int pad,
               const uint32_t* __restrict__ mats, uint64_t* __restrict__ y) {
  __shared__ uint32_t mat[kFoldLevels * 32];
  __shared__ uint32_t warp_reg[32];
  if (threadIdx.x < kFoldLevels * 32) mat[threadIdx.x] = mats[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kFold + threadIdx.x - pad;
  uint32_t r = (i >= 0 && i < m) ? (uint32_t)x[i] : 0u;
  r = warp_tree(r, mat, 0, lane);
  if (lane == 0) warp_reg[warp] = r;
  __syncthreads();
  if (warp == 0) {
    r = warp_tree(warp_reg[lane], mat, 5, lane);
    if (lane == 0) y[blockIdx.x] = r;
  }
}

}  // namespace

// pass 0: chunk registers of data [n] uint8 into regs [L] (L = ceil(n /
// chunk)), msb selecting the bzip2 (MSB-first) variant; pass 1: one fold
// of x [m] into y [ceil((m + pad) / 1024)], pad = (-m) mod 1024, with the
// levels at mats. Registers are 64-bit words holding the 32-bit register
// (the wrapper returns int64 tensors). Returns the launch's cudaError.
extern "C" int tpz_crc32_lanes(const void* data, long long n, int chunk,
                               int msb, const void* table, void* regs,
                               const void* x, long long m, const void* mats,
                               void* y, int pass, cudaStream_t stream) {
  if (pass == 0) {
    if (n == 0) return 0;
    const long long L = (n + chunk - 1) / chunk;
    const unsigned blocks =
        (unsigned)((L + kChunkThreads - 1) / kChunkThreads);
    const auto* d = static_cast<const uint8_t*>(data);
    const auto* t = static_cast<const uint32_t*>(table);
    auto* r = static_cast<uint64_t*>(regs);
    if (msb)
      crc32_chunks<false><<<blocks, kChunkThreads, 0, stream>>>(d, n, chunk,
                                                                L, t, r);
    else
      crc32_chunks<true><<<blocks, kChunkThreads, 0, stream>>>(d, n, chunk,
                                                               L, t, r);
  } else {
    const int pad = (int)((kFold - m % kFold) % kFold);
    const unsigned blocks = (unsigned)((m + pad) / kFold);
    crc32_fold<<<blocks, kFold, 0, stream>>>(
        static_cast<const uint64_t*>(x), m, pad,
        static_cast<const uint32_t*>(mats), static_cast<uint64_t*>(y));
  }
  return (int)cudaGetLastError();
}
