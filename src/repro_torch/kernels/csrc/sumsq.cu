// Sum of squares of a flat float32 vector, for sm_90a.
//
// Replaces: src/repro/kernels/dp_clip.py, _sumsq_kernel (reached through
// dp_clip.sumsq and core/flat.sumsq; the round's delta_norm metric).
//
// Bound on this card: bytes. Every element is read once (4 bytes) for 2
// flops; at the round's flat size (89,088 f32 = 356 KB) the read takes
// ~0.11 us at 3.35 TB/s, at the FedAvg width (1,695,744) ~2.0 us. At the
// round's size one launch and its chain of latencies (load, CTA tree,
// ticket, the last CTA's read of the partials) is what the time shows.
//
// Design: one launch, deterministic. The TPU kernel carries one SMEM
// accumulator across a sequential grid; Hopper's blocks run in parallel
// and in no order, so the sum is a fixed-order two-stage reduction whose
// second stage runs in the same launch (the last-block pattern):
// - stage 1: CTA b sums the float4 quads [b * chunk, (b + 1) * chunk);
//   thread t takes quads t, t + 256, ... of it with 16-byte loads, each
//   element into one fmaf chain (x, y, z, w in order); the last CTA's
//   thread 0 then adds the n % 4 tail elements. A fixed shuffle tree per
//   warp and one over the 8 warp sums give the CTA's partial;
// - each CTA writes its partial and takes a ticket from an integer
//   arrival counter (one atom.add.acq_rel.gpu: it releases the partial,
//   and the last CTA's acquires all the others); the CTA that draws the
//   last ticket sums the partials in index order (thread t: partials t,
//   t + 256, ...; then the same tree), writes out and sets the counter
//   back to 0 for the next call on this stream.
// Grid: ~one float4 a thread at small n (87 CTAs at 89,088), at most 132
// CTAs (one per SM) at large n; fewer, longer CTAs measured faster there
// than more tickets on the one counter.
// No float atomics: the bits depend on n only (grid and chunk come from
// n, kernels/dp_clip.sumsq_plan), which bitwise resume needs. A base that
// is not 16-byte aligned takes the same order with scalar loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Fixed-order tree sum over the CTA's threads; the result is thread 0's.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0.f;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
  }
  return s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sumsq_one_launch_kernel(const float* __restrict__ x, int64_t n,
                        int64_t chunk, float* __restrict__ partials,
                        unsigned int* __restrict__ counter,
                        float* __restrict__ out) {
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int64_t nq = n >> 2;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t q1 = q0 + chunk < nq ? q0 + chunk : nq;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t q = q0 + threadIdx.x; q < q1; q += kThreads) {
    float4 v;
    if (kVec) {
      v = __ldg(reinterpret_cast<const float4*>(x) + q);
    } else {
      v = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    acc = fmaf(v.w, v.w, acc);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    for (int64_t i = nq << 2; i < n; ++i) acc = fmaf(x[i], x[i], acc);
  }
  const float s = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    // the ticket releases this CTA's partial and acquires the earlier ones
    unsigned int ticket;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(counter) : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();  // thread 0's acquire reaches the CTA
  if (!last) return;
  float p = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    p += __ldcg(partials + i);  // from L2, where the other CTAs wrote
  }
  const float total = block_sum(p, warp_sums);
  if (threadIdx.x == 0) {
    out[0] = total;
    *counter = 0u;
  }
}

}  // namespace

// out[0] = sum(x[i]^2) in one launch of `grid` CTAs, each summing `chunk`
// float4 quads. `partials` holds at least `grid` floats and `counter` is
// 0 on entry (and again on exit); both belong to this stream alone.
// Returns the CUDA error of the launch (0 on success).
extern "C" int sumsq_f32(const float* x, int64_t n, int grid, int64_t chunk,
                         float* partials, unsigned int* counter, float* out,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    sumsq_one_launch_kernel<true><<<grid, kThreads, 0, st>>>(
        x, n, chunk, partials, counter, out);
  } else {
    sumsq_one_launch_kernel<false><<<grid, kThreads, 0, st>>>(
        x, n, chunk, partials, counter, out);
  }
  return static_cast<int>(cudaGetLastError());
}
