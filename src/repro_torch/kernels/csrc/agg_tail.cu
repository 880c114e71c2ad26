// The fused server aggregation tail over block-aligned flat client deltas,
// for sm_90a: a stats kernel, a pack kernel (with a row-sum stage) and an
// apply kernel over the whole (K, N) buffer of K client rows.
//
// Replaces: src/repro/kernels/agg_tail.py, _stats_kernel (block_stats),
// _pack_kernel (pack) and _apply_kernel (apply_coeff), reached through
// kernels/ops.agg_tail -> agg_tail.compose when uplink_bits > 0 and the
// buffer holds at least AGG_FUSE_THRESHOLD elements.
//
// Bound on this card: bytes. At the EMNIST FedAvg round's (10, 1,695,744):
// stats reads K*N*4 bytes (67.8 MB, ~20 us at 3.35 TB/s); pack reads them
// again and writes K*N int8 codes (~25 us); apply reads the codes and the
// noise and writes N floats (~9 us). A few operations per element are far
// below the card's float32 rate.
//
// Design. The TPU grid walks the align-blocks in order, one (K, block)
// tile per step, and the pack kernel carries the per-row quantized sum of
// squares in SMEM across the grid. Hopper's blocks run in parallel and in
// no order, so:
// - stats and pack take one CUDA block per (row, align-block), grid
//   (blocks, rows), with no cross-block combine in stats;
// - max-abs runs on the float's int32 bit pattern with the sign cleared,
//   which orders like |x| and puts every NaN above +Inf, so NaN survives
//   (the screen's row-finite flag is all(isfinite(bmax)));
// - the per-block sum of squares is a shared-memory tree in the plain
//   version's order (kernels/ref._sumsq_blocks): thread i takes
//   x[i]^2 + x[i + block/2]^2, then halve. __fmul_rn / __fadd_rn keep nvcc
//   from contracting a*a + b*b into a fused multiply-add, so the bits are
//   the plain version's;
// - pack sums q^2 per block in int32 (at most 1024 * 127^2 < 2^24: exact in
//   any order), writes s^2 * sum(q^2) per (row, block) to scratch, and a
//   second launch sums each row over its blocks in block-index order, the
//   TPU's sequential order: deterministic, no float atomics;
// - the codes are clip(rint(x / s), -qmax, qmax) with IEEE division
//   (__fdiv_rn, no fast-math) and round half to even, as quantize.cu; the
//   code of a NaN is 0 here (the tail only packs screened rows);
// - apply: each thread owns 4 neighbouring output elements and starts from
//   the noise (or 0), then adds q[k] * coeff[k, block] for k = 0..K-1 in
//   order. That is the plain version's order (kernels/ref.agg_apply_ref,
//   which is what the JAX package runs off the TPU), not the TPU kernel's,
//   which sums over k first and adds the noise last.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // pack and apply

// max of a sign-cleared int32 pattern over the block's threads; every
// thread must call it; the result is valid in thread 0
__device__ int32_t block_max(int32_t m, int32_t* smem) {
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      m = max(m, smem[w]);
    }
  }
  return m;
}

// blockDim.x == block / 2 threads per (row, align-block)
__global__ void block_stats_kernel(const float* __restrict__ x, int64_t n,
                                   float* __restrict__ bmax,
                                   float* __restrict__ bsumsq) {
  extern __shared__ float part[];  // block / 2 partial sums
  __shared__ int32_t warp_max[32];
  const int h = blockDim.x;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int64_t nb = gridDim.x;
  const float* xb = x + row * n + b * 2 * h;
  const float lo = xb[t];
  const float hi = xb[t + h];
  part[t] = __fadd_rn(__fmul_rn(lo, lo), __fmul_rn(hi, hi));
  const int32_t m = block_max(max(__float_as_int(lo) & 0x7FFFFFFF,
                                  __float_as_int(hi) & 0x7FFFFFFF),
                              warp_max);
  __syncthreads();
  for (int s = h >> 1; s > 0; s >>= 1) {
    if (t < s) part[t] = __fadd_rn(part[t], part[t + s]);
    __syncthreads();
  }
  if (t == 0) {
    bmax[row * nb + b] = __int_as_float(m);
    bsumsq[row * nb + b] = part[0];
  }
}

__global__ void pack_kernel(const float* __restrict__ x,
                            const float* __restrict__ sblock, int64_t n,
                            int block, float qmax, int8_t* __restrict__ q,
                            float* __restrict__ bqss) {
  __shared__ int32_t warp_sum[kThreads / 32];
  const int64_t b = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int64_t nb = gridDim.x;
  const float s = sblock[row * nb + b];
  const int64_t base = row * n + b * block;
  int32_t acc = 0;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    float v = rintf(__fdiv_rn(x[base + i], s));
    v = v < -qmax ? -qmax : (v > qmax ? qmax : v);  // NaN passes through
    const int32_t c = __float2int_rz(v);            // ... and becomes 0
    q[base + i] = static_cast<int8_t>(c);
    acc += c * c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) acc += warp_sum[w];
    bqss[row * nb + b] = __fmul_rn(static_cast<float>(acc), __fmul_rn(s, s));
  }
}

// out[row] = sum over b of part[row, b], in block-index order
__global__ void row_sum_kernel(const float* __restrict__ part, int64_t rows,
                               int64_t nb, float* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= rows) return;
  float acc = 0.f;
  for (int64_t b = 0; b < nb; ++b) acc = __fadd_rn(acc, part[row * nb + b]);
  out[row] = acc;
}

// one thread per 4 neighbouring elements (n and block are multiples of 4)
__global__ void apply_kernel(const int8_t* __restrict__ q,
                             const float* __restrict__ coeff,
                             const float* __restrict__ noise, int64_t rows,
                             int64_t n, int block, float* __restrict__ out) {
  const int64_t j = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) * 4;
  if (j >= n) return;
  const int64_t nb = n / block;
  const int64_t blk = j / block;
  float4 acc = noise != nullptr
                   ? *reinterpret_cast<const float4*>(noise + j)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t k = 0; k < rows; ++k) {
    const char4 c = *reinterpret_cast<const char4*>(q + k * n + j);
    const float a = coeff[k * nb + blk];
    acc.x = __fadd_rn(acc.x, __fmul_rn(static_cast<float>(c.x), a));
    acc.y = __fadd_rn(acc.y, __fmul_rn(static_cast<float>(c.y), a));
    acc.z = __fadd_rn(acc.z, __fmul_rn(static_cast<float>(c.z), a));
    acc.w = __fadd_rn(acc.w, __fmul_rn(static_cast<float>(c.w), a));
  }
  *reinterpret_cast<float4*>(out + j) = acc;
}

}  // namespace

// bmax, bsumsq (rows, n / block) float32: per (row, block) max|x| (NaN
// kept) and sum of squares. block is a power of two in [64, 2048].
extern "C" int agg_block_stats_f32(const float* x, int64_t rows, int64_t n,
                                   int block, float* bmax, float* bsumsq,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n / block),
                  static_cast<unsigned>(rows));
  const int threads = block / 2;
  block_stats_kernel<<<grid, threads, threads * sizeof(float), st>>>(
      x, n, bmax, bsumsq);
  return static_cast<int>(cudaGetLastError());
}

// q (rows, n) int8 codes with per-(row, block) scales sblock (rows, n /
// block); bqss (rows, n / block) scratch; qss (rows,) = sum over blocks of
// s^2 * sum(q^2), summed in block order.
extern "C" int agg_pack_f32(const float* x, const float* sblock, int64_t rows,
                            int64_t n, int block, float qmax, int8_t* q,
                            float* bqss, float* qss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb = n / block;
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(rows));
  pack_kernel<<<grid, kThreads, 0, st>>>(x, sblock, n, block, qmax, q, bqss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned row_blocks =
      static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  row_sum_kernel<<<row_blocks, kThreads, 0, st>>>(bqss, rows, nb, qss);
  return static_cast<int>(cudaGetLastError());
}

// out (n,) = noise (or 0) + sum over k, in order, of q[k] * coeff[k, block];
// q (rows, n) int8, coeff (rows, n / block) float32, noise (n,) or null.
extern "C" int agg_apply_coeff_f32(const int8_t* q, const float* coeff,
                                   const float* noise, int64_t rows,
                                   int64_t n, int block, float* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t quads = n / 4;
  const unsigned grid =
      static_cast<unsigned>((quads + kThreads - 1) / kThreads);
  apply_kernel<<<grid, kThreads, 0, st>>>(q, coeff, noise, rows, n, block,
                                          out);
  return static_cast<int>(cudaGetLastError());
}
