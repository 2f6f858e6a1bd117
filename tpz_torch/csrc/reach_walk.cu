// Greedy reach walk on Hopper: one CUDA thread per row.
//
// Replaces tpz/kernels/parse.py::_parse_pallas: from p = 0, mark p and
// go on at p + step[p] while p < N. The TPU version keeps the row in VMEM
// as [N / 128, 128] tiles and read-modify-writes a 128-lane row per step,
// as Mosaic has no scalar VMEM stores; here a thread reads one int32 and
// stores one int32 per step, into the zeroed output the wrapper hands it.
//
// What bounds it: each step's load address is the previous step's result,
// so a row is one chain of dependent global loads (about N / 3.6 of them
// for the steps of a gzip parse), latency-bound; rows run in parallel, one
// thread each. A step below 1 counts as 1, so the walk always ends.
//
// Layout: step, out [NB, N] int32.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void reach_walk_kernel(const int32_t* __restrict__ step,
                                  int32_t* __restrict__ out, int NB, int N) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= NB) return;
  const int32_t* srow = step + (size_t)b * N;
  int32_t* orow = out + (size_t)b * N;
  int p = 0;
  while (p < N) {
    orow[p] = 1;
    const int s = __ldg(srow + p);
    p = s >= N - p ? N : p + max(s, 1);
  }
}

}  // namespace

extern "C" int tpz_reach_walk(const int32_t* step, int32_t* out, int NB,
                              int N, cudaStream_t stream) {
  if (NB == 0 || N == 0) return 0;
  const int threads = 128;
  reach_walk_kernel<<<(NB + threads - 1) / threads, threads, 0, stream>>>(
      step, out, NB, N);
  return (int)cudaGetLastError();
}
