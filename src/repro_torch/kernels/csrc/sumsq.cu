// Sum of squares of a flat float32 vector, for sm_90a.
//
// Replaces: src/repro/kernels/dp_clip.py, _sumsq_kernel (reached through
// dp_clip.sumsq and core/flat.sumsq; the round's delta_norm metric).
//
// Bound on this card: bytes. Every element is read once (4 bytes) for 2
// flops; at the round's flat size (89,088 f32 = 356 KB) the read takes
// ~0.11 us at 3.35 TB/s, far below one launch, so launch latency is
// what the time shows.
//
// Design: the TPU kernel carries one SMEM accumulator across a
// sequential grid. Hopper's blocks run in parallel and in no order, so
// the sum is a fixed-order two-stage reduction: stage 1 gives each block
// one contiguous chunk (threads stride through it with coalesced loads,
// then a shared-memory tree) and writes one partial; stage 2, one block,
// sums the partials in index order. No float atomics: the result is the
// same bits on every run, which bitwise resume needs. The grid size
// depends on n only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMinChunk = 2048;  // elements per stage-1 block, at least

// Fixed-order tree sum over the block's threads.
__device__ float block_sum(float v, float* smem) {
  smem[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) smem[threadIdx.x] += smem[threadIdx.x + s];
    __syncthreads();
  }
  return smem[0];
}

__global__ void sumsq_partials_kernel(const float* __restrict__ x, int64_t n,
                                      int64_t chunk,
                                      float* __restrict__ partials) {
  __shared__ float smem[kThreads];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = start + chunk < n ? start + chunk : n;
  float acc = 0.f;
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads) {
    const float v = x[i];
    acc = fmaf(v, v, acc);
  }
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    int n, float* __restrict__ out) {
  __shared__ float smem[kThreads];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace

// out[0] = sum(x[i]^2). `partials` is scratch of max_partials floats.
// Returns the CUDA error of the launches (0 on success).
extern "C" int sumsq_f32(const float* x, int64_t n, float* partials,
                         int max_partials, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t grid = (n + kMinChunk - 1) / kMinChunk;
  if (grid > max_partials) grid = max_partials;
  if (grid < 1) grid = 1;
  const int64_t chunk = (n + grid - 1) / grid;
  sumsq_partials_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      x, n, chunk, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, st>>>(partials,
                                              static_cast<int>(grid), out);
  return static_cast<int>(cudaGetLastError());
}
