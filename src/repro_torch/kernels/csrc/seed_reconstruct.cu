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
//
// Design: one thread per element of the (rows, cols padded to 128) output,
// as the TPU kernel's (block_rows, 128-lane) tiles hold them; nothing is
// read, so the kernel is one coalesced store per thread. The value of an
// element is a pure function of (seed word, element index), so the tiling
// cannot change it:
// - the counter is the row-major index r * cols + c over the LOGICAL cols,
//   in 32 bits (the padding does not shift the stream of real elements);
// - the seed word is seed * 0x9E3779B9 + int32(leaf_id * 40503), wrapping
//   (the host builds it, as the reference's wrapper does);
// - b1, b2 = squirrel3(2 idx), squirrel3(2 idx + 1); u = ((b >> 8) + 0.5)
//   * 2^-24, exact in float32; z = sqrtf(-2 logf(u1)) * cosf(2 pi u2);
//   out = stddev * z in the output type, and 0 in the padding.
// logf and cosf are CUDA's accurate versions: the build flags leave out
// --use_fast_math. An optional second output holds (b1, b2) of every real
// element, for checking the hash bit for bit.
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void seed_kernel(T* __restrict__ out, int64_t rows, int64_t cols,
                            int64_t cpad, uint32_t seed, float stddev,
                            uint32_t* __restrict__ bits) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= rows * cpad) return;
  const int64_t r = e / cpad;
  const int64_t c = e - r * cpad;
  float z = 0.f;
  if (c < cols) {
    const int64_t flat = r * cols + c;
    const uint32_t idx = static_cast<uint32_t>(flat);
    const uint32_t b1 = squirrel3(idx * 2u, seed);
    const uint32_t b2 = squirrel3(idx * 2u + 1u, seed);
    z = sqrtf(-2.0f * logf(uniform(b1))) * cosf(kTwoPi * uniform(b2));
    if (bits != nullptr) {
      bits[flat] = b1;
      bits[rows * cols + flat] = b2;
    }
  }
  store(out + e, stddev * z);
}

template <typename T>
int launch(void* out, int64_t rows, int64_t cols, int64_t cpad, uint32_t seed,
           float stddev, void* bits, cudaStream_t st) {
  const int64_t n = rows * cpad;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  seed_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(out), rows, cols, cpad, seed, stddev,
      static_cast<uint32_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (rows, cpad) of dtype 0 float32 or 1 bfloat16, cpad >= cols; bits
// (2, rows, cols) uint32 or null. rows * cpad > 0. Returns the CUDA error of
// the launch.
extern "C" int seed_reconstruct_fwd(void* out, int dtype, int64_t rows,
                                    int64_t cols, int64_t cpad, uint32_t seed,
                                    float stddev, void* bits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(out, rows, cols, cpad, seed, stddev, bits, st);
    case 1:
      return launch<__nv_bfloat16>(out, rows, cols, cpad, seed, stddev, bits,
                                   st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
