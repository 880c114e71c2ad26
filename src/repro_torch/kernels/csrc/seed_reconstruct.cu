// Deterministic Gaussian tensor from (seed, leaf): FedPT's regeneration of a
// frozen leaf from the scalar seed (Algorithm 1, line 5), for sm_90a.
//
// Replaces: src/repro/kernels/seed_reconstruct.py, _seed_kernel /
// seed_reconstruct. No engine of either package calls it: only
// kernels/ops.seed_reconstruct and the tests reach it.
//
// Bound on this card: bytes. The output is the only traffic, 4 * rows *
// cols_padded bytes in float32: 88 us for NeMo's (5120, 14336) FFN leaf at
// 3.35 TB/s. The work per element (two 7-step integer hashes, the uniform
// maps, a log, a cos, a sqrt and four multiplies: about 32 operations,
// counting each transcendental as one) takes 35 us at 67 T operations/s.
// What the card really spends is instruction issue: the accurate log, cos
// and sqrt take many instructions each, so the kernel runs several times
// its byte bound (chip_smoke.py prints the SASS count of an element and
// the issue-rate estimate).
//
// The bits are the function: each element is a pure function of (seed
// word, element index), so the tiling cannot change it:
// - the counter is the row-major index r * cols + c over the LOGICAL cols,
//   in 32 bits (the padding does not shift the stream of real elements);
// - the seed word is seed * 0x9E3779B9 + int32(leaf_id * 40503), wrapping
//   (the host builds it, as the reference's wrapper does);
// - b1, b2 = squirrel3(2 idx), squirrel3(2 idx + 1); u = ((b >> 8) + 0.5)
//   * 2^-24, exact in float32; z = sqrtf(-2 logf(u1)) * cosf(2 pi u2);
//   out = stddev * z in the output type, and 0 in the padding.
// logf, cosf and sqrtf are CUDA's accurate versions: the build flags leave
// out --use_fast_math.
//
// Design: nothing is read, so what the card does per element is the
// function's own instructions (two hashes, the uniforms, log, cos, sqrt,
// multiplies) plus the bookkeeping; the kernel keeps the bookkeeping out of
// the element loop. A thread writes one run of kRun consecutive elements
// of one row, 16 bytes (4 float32 or 8 bfloat16), with one store; cpad is
// a multiple of 128, so a run never crosses a row and every row starts on
// the 16-byte grid. The 1-D grid walks (row, tile) pairs, tiles of
// kThreads runs along a row: one 32-bit division a thread gives the row
// (any row count; a leaf of any width), the counter of the run's first
// element is uint32(r) * uint32(cols) + c0, wrapping exactly as the 32-bit
// cast of the 64-bit index does, and the run's k-th counter is that plus
// k. The only 64-bit arithmetic is the output pointer's row offset. The
// padding's elements are computed and replaced by 0, so the run has no
// branch. The (b1, b2) check output is a template parameter: the instance
// that writes values only has no branch for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ uint32_t squirrel3(uint32_t n, uint32_t seed) {
  n *= 0xB5297A4Du;
  n += seed;
  n ^= n >> 8;
  n += 0x68E31DA4u;
  n ^= n << 8;
  n *= 0x1B56C4E9u;
  n ^= n >> 8;
  return n;
}

__device__ __forceinline__ float uniform(uint32_t bits) {
  return (__uint2float_rn(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// 16 bytes of output: kRun values
template <typename T>
struct Run;
template <>
struct Run<float> {
  static constexpr int kRun = 4;
  static __device__ __forceinline__ void store(float* p, const float (&z)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(z[0], z[1], z[2], z[3]);
  }
};
template <>
struct Run<__nv_bfloat16> {
  static constexpr int kRun = 8;
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&z)[8]) {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(z[2 * k], z[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// grid rows * tiles, kThreads threads: block (r, tile) = (b / tiles,
// b % tiles), thread t the run at column c0 = (tile * kThreads + t) * kRun.
template <typename T, bool kBits>
__global__ void __launch_bounds__(kThreads)
seed_kernel(T* __restrict__ out, uint32_t rows, uint32_t cols,
            uint32_t cpad, uint32_t tiles, uint32_t seed, float stddev,
            uint32_t* __restrict__ bits) {
  constexpr int kRun = Run<T>::kRun;
  const uint32_t r = blockIdx.x / tiles;
  const uint32_t c0 = ((blockIdx.x - r * tiles) * kThreads + threadIdx.x)
                      * kRun;
  if (c0 >= cpad) return;
  const uint32_t idx0 = r * cols + c0;  // wraps as the 32-bit counter does
  float z[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const uint32_t idx = idx0 + k;
    const uint32_t b1 = squirrel3(idx * 2u, seed);
    const uint32_t b2 = squirrel3(idx * 2u + 1u, seed);
    const float v = stddev * (sqrtf(-2.0f * logf(uniform(b1)))
                              * cosf(kTwoPi * uniform(b2)));
    z[k] = c0 + k < cols ? v : 0.f;
    if (kBits && c0 + k < cols) {
      const int64_t flat = static_cast<int64_t>(r) * cols + c0 + k;
      bits[flat] = b1;
      bits[static_cast<int64_t>(rows) * cols + flat] = b2;
    }
  }
  Run<T>::store(out + static_cast<int64_t>(r) * cpad + c0, z);
}

template <typename T>
int launch(void* out, int64_t rows, int64_t cols, int64_t cpad,
           int64_t tiles, uint32_t seed, float stddev, void* bits,
           cudaStream_t st) {
  constexpr int64_t kMax = 0x7FFFFFFF;
  if (rows < 1 || cols < 1 || cpad < cols || cpad % 128 || cpad > kMax ||
      tiles * kThreads * Run<T>::kRun < cpad || rows * tiles > kMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(rows * tiles);
  T* o = static_cast<T*>(out);
  uint32_t* b = static_cast<uint32_t*>(bits);
  const uint32_t R = static_cast<uint32_t>(rows);
  const uint32_t C = static_cast<uint32_t>(cols);
  const uint32_t P = static_cast<uint32_t>(cpad);
  const uint32_t N = static_cast<uint32_t>(tiles);
  if (b != nullptr) {
    seed_kernel<T, true><<<blocks, kThreads, 0, st>>>(o, R, C, P, N, seed,
                                                      stddev, b);
  } else {
    seed_kernel<T, false><<<blocks, kThreads, 0, st>>>(o, R, C, P, N, seed,
                                                       stddev, b);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (rows, cpad) of dtype 0 float32 or 1 bfloat16, cpad >= cols a
// multiple of 128; bits (2, rows, cols) uint32 or null; tiles the row's
// tiles of 256 runs of 16 bytes (seed_reconstruct.seed_plan), rows * tiles
// < 2^31. Returns the CUDA error of the launch.
extern "C" int seed_reconstruct_fwd(void* out, int dtype, int64_t rows,
                                    int64_t cols, int64_t cpad, int64_t tiles,
                                    uint32_t seed, float stddev, void* bits,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(out, rows, cols, cpad, tiles, seed, stddev, bits,
                           st);
    case 1:
      return launch<__nv_bfloat16>(out, rows, cols, cpad, tiles, seed, stddev,
                                   bits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
