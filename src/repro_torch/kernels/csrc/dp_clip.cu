// Per-row L2 clip of flat float32 client deltas, and the clip-and-accumulate
// of one delta into an aggregation buffer, for sm_90a.
//
// Replaces: src/repro/kernels/dp_clip.py, _scale_kernel (clip_flat; the
// async client step's DP clip, reached through core/flat.clip) and
// _scale_add_kernel (clip_accumulate; reached through kernels/ops only),
// together with the _sumsq_kernel stage both of them run first.
//
// Bound on this card: bytes. clip_flat reads every element twice (the norm
// stage, then the scale stage) where the least work reads it once and
// writes it once: 8 * R * N bytes, 1.28 us at the async lane's
// (6, 89,088) at 3.35 TB/s; clip_accumulate 12 * N bytes. Three
// operations per element are far below the card's float32 rate.
//
// Design. The TPU kernel carries the sum of squares in one SMEM cell across
// a sequential grid of 32768-element tiles. Hopper's blocks run in
// parallel and in no order, so the norm is a fixed-order three-launch
// pipeline, with no float atomics (the same bits on every run):
// - stage 1, one CUDA block per (row, align-block): the block's sum of
//   squares in the plain version's order (kernels/ref._sumsq_blocks):
//   thread i takes x[i]^2 + x[i + block/2]^2, then a shared-memory tree
//   halves it. __fmul_rn / __fadd_rn keep nvcc from contracting into fused
//   multiply-adds, so these sums are the plain version's bits. A ragged
//   last block reads zeros past the row's end;
// - stage 2, one CUDA block per row: thread t sums the blocks t, t + T,
//   t + 2T, ... in that order, then a shared-memory tree combines the
//   threads; norm = sqrt(sum) and scale = min(1, C / max(norm, 1e-12))
//   with IEEE division (__fdiv_rn, no fast-math), NaN kept as jnp.minimum
//   and jnp.maximum keep it (fminf / fmaxf would drop it);
// - stage 3: out = x * scale[row] (or acc + x * scale), elementwise. A row
//   whose norm is at most C has scale exactly 1 and comes back bit for bit.
// The combine order differs from the plain version's torch.sum over the
// blocks, so the norms agree within 2 * blocks * 2^-24 relative.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCombineThreads = 256;
constexpr int kScaleThreads = 256;
constexpr int kScaleItems = 4;  // elements per thread in stage 3

// blockDim.x == block / 2 threads per (row, align-block)
__global__ void block_sumsq_kernel(const float* __restrict__ x, int64_t n,
                                   float* __restrict__ bss) {
  extern __shared__ float part[];
  const int h = blockDim.x;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int64_t nb = gridDim.x;
  const int64_t i = b * 2 * h + t;
  const float* xr = x + row * n;
  const float lo = i < n ? xr[i] : 0.f;
  const float hi = i + h < n ? xr[i + h] : 0.f;
  part[t] = __fadd_rn(__fmul_rn(lo, lo), __fmul_rn(hi, hi));
  __syncthreads();
  for (int s = h >> 1; s > 0; s >>= 1) {
    if (t < s) part[t] = __fadd_rn(part[t], part[t + s]);
    __syncthreads();
  }
  if (t == 0) bss[row * nb + b] = part[0];
}

// one CUDA block per row: fixed-order combine of the row's block sums
__global__ void row_scale_kernel(const float* __restrict__ bss, int64_t nb,
                                 float clip, float* __restrict__ norms,
                                 float* __restrict__ scales) {
  __shared__ float part[kCombineThreads];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  float acc = 0.f;
  for (int64_t b = t; b < nb; b += kCombineThreads) {
    acc = __fadd_rn(acc, bss[row * nb + b]);
  }
  part[t] = acc;
  __syncthreads();
  for (int s = kCombineThreads >> 1; s > 0; s >>= 1) {
    if (t < s) part[t] = __fadd_rn(part[t], part[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    const float norm = __fsqrt_rn(part[0]);
    const float den = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
    const float r = __fdiv_rn(clip, den);
    norms[row] = norm;
    scales[row] = isnan(r) ? r : fminf(1.f, r);
  }
}

// out[row, i] = x[row, i] * scale[row] (+ acc[i] when acc is given; one row)
__global__ void scale_kernel(const float* __restrict__ x,
                             const float* __restrict__ acc,
                             const float* __restrict__ scales, int64_t n,
                             float* __restrict__ out) {
  const int64_t row = blockIdx.y;
  const float s = scales[row];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScaleThreads *
                       kScaleItems + threadIdx.x;
  for (int k = 0; k < kScaleItems; ++k) {
    const int64_t i = base + k * kScaleThreads;
    if (i < n) {
      const float v = __fmul_rn(x[row * n + i], s);
      out[row * n + i] = acc != nullptr ? __fadd_rn(acc[i], v) : v;
    }
  }
}

int launch_norms(const float* x, int64_t rows, int64_t n, int block,
                 float clip, float* bss, float* norms, float* scales,
                 cudaStream_t st) {
  const int64_t nb = (n + block - 1) / block;
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(rows));
  const int threads = block / 2;
  block_sumsq_kernel<<<grid, threads, threads * sizeof(float), st>>>(x, n,
                                                                     bss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_scale_kernel<<<static_cast<unsigned>(rows), kCombineThreads, 0, st>>>(
      bss, nb, clip, norms, scales);
  return static_cast<int>(cudaGetLastError());
}

int launch_scale(const float* x, const float* acc, const float* scales,
                 int64_t rows, int64_t n, float* out, cudaStream_t st) {
  const int64_t per_block = static_cast<int64_t>(kScaleThreads) * kScaleItems;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(rows));
  scale_kernel<<<grid, kScaleThreads, 0, st>>>(x, acc, scales, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Clip each of `rows` rows of x (rows, n): out = x * min(1, clip / ||x||),
// norms (rows,) the pre-clip norms. bss (rows, ceil(n / block)) and scales
// (rows,) are scratch. block is a power of two in [64, 2048]; n > 0.
extern "C" int dp_clip_rows_f32(const float* x, int64_t rows, int64_t n,
                                int block, float clip, float* bss,
                                float* norms, float* scales, float* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_norms(x, rows, n, block, clip, bss, norms, scales,
                               st);
  if (err != 0) return err;
  return launch_scale(x, nullptr, scales, rows, n, out, st);
}

// out (n,) = acc + x * min(1, clip / ||x||); norm (1,) the pre-clip norm.
// bss (ceil(n / block),) and scale (1,) are scratch.
extern "C" int dp_clip_accumulate_f32(const float* acc, const float* x,
                                      int64_t n, int block, float clip,
                                      float* bss, float* norm, float* scale,
                                      float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_norms(x, 1, n, block, clip, bss, norm, scale, st);
  if (err != 0) return err;
  return launch_scale(x, acc, scale, 1, n, out, st);
}
