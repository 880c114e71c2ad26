// Per-leaf int-k fake-quantize of block-aligned flat client deltas, for
// sm_90a: a max-abs kernel and a Q->DQ kernel over the whole (K, N)
// buffer of K client rows.
//
// Replaces: src/repro/kernels/quantize.py, _maxabs_kernel (leaf_maxabs)
// and _qdq_kernel (fake_quantize_flat), which the JAX package maps over
// the K rows one launch each (core/flat.fake_quantize, kernels/ops.py
// _fake_quantize, when RoundConfig.uplink_bits == 8).
//
// Bound on this card: bytes. max-abs reads K*N*4 bytes (3.56 MB at the
// EMNIST round's (10, 89,088): ~1.1 us at 3.35 TB/s); Q->DQ reads and
// writes K*N*4 bytes each (~2.1 us). The few flops per element are far
// below the card's rate.
//
// Design: one launch per kernel for all K rows, grid (blocks, rows), one
// thread block per 1024-element align-block. The TPU kernels get the
// block->leaf map by scalar prefetch and carry per-leaf maxima in SMEM
// across a sequential grid; here each thread block loads its own leaf
// index and the per-leaf maximum crosses blocks through an integer
// atomicMax. That is order-independent (so deterministic) because it
// runs on the float's int32 bit pattern with the sign cleared, which
// orders like |x| and puts every NaN above +Inf: a NaN is kept where
// fmaxf would drop it, as jnp.max(jnp.abs(x)) keeps it. Q->DQ is
// bit-for-bit core/compress.quantize_leaf: IEEE division (no fast-math,
// __fdiv_rn), round half to even (rintf), a clip that lets NaN through,
// and scales max(m, 1e-12)/qmax computed in float32 with a NaN kept.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void leaf_maxabs_kernel(const float* __restrict__ x,
                                   const int32_t* __restrict__ block_leaf,
                                   int64_t n, int block, int n_leaves,
                                   int32_t* __restrict__ out) {
  const int64_t b = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int32_t* xb =
      reinterpret_cast<const int32_t*>(x + row * n + b * block);
  int32_t m = 0;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    m = max(m, xb[i] & 0x7FFFFFFF);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  __shared__ int32_t warp_max[kWarps];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = max(m, warp_max[w]);
    atomicMax(out + row * n_leaves + block_leaf[b], m);
  }
}

__global__ void qdq_kernel(const float* __restrict__ x,
                           const int32_t* __restrict__ block_leaf,
                           const float* __restrict__ maxabs, int64_t n,
                           int block, int n_leaves, float qmax,
                           float* __restrict__ y) {
  const int64_t b = blockIdx.x;
  const int64_t row = blockIdx.y;
  __shared__ float scale;
  if (threadIdx.x == 0) {
    const float m = maxabs[row * n_leaves + block_leaf[b]];
    // jnp.maximum(m, 1e-12) keeps a NaN; fmaxf would drop it
    scale = __fdiv_rn(m != m ? m : fmaxf(m, 1e-12f), qmax);
  }
  __syncthreads();
  const float s = scale;
  const int64_t base = row * n + b * block;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    float q = rintf(__fdiv_rn(x[base + i], s));
    q = q < -qmax ? -qmax : (q > qmax ? qmax : q);  // NaN passes through
    y[base + i] = __fmul_rn(q, s);
  }
}

}  // namespace

// out (rows, n_leaves) int32: the sign-cleared bit pattern of each leaf's
// max|x| (view it as float32). x is (rows, n), n = n_blocks * block.
extern "C" int leaf_maxabs_f32(const float* x, const int32_t* block_leaf,
                               int64_t rows, int64_t n, int block,
                               int n_leaves, int32_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int32_t) * rows * n_leaves, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n / block),
                  static_cast<unsigned>(rows));
  leaf_maxabs_kernel<<<grid, kThreads, 0, st>>>(x, block_leaf, n, block,
                                                n_leaves, out);
  return static_cast<int>(cudaGetLastError());
}

// y = clip(rint(x / s), -qmax, qmax) * s, s = max(maxabs, 1e-12) / qmax per
// (row, leaf). x, y (rows, n); maxabs (rows, n_leaves) float32.
extern "C" int fake_quantize_flat_f32(const float* x, const int32_t* block_leaf,
                                      const float* maxabs, int64_t rows,
                                      int64_t n, int block, int n_leaves,
                                      float qmax, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n / block),
                  static_cast<unsigned>(rows));
  qdq_kernel<<<grid, kThreads, 0, st>>>(x, block_leaf, maxabs, n, block,
                                        n_leaves, qmax, y);
  return static_cast<int>(cudaGetLastError());
}
