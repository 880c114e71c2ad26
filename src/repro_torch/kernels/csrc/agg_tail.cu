// The fused server aggregation tail over block-aligned flat client deltas,
// for sm_90a: a stats kernel, a pack kernel (with a row-combine stage) and
// an apply kernel over the whole (K, N) buffer of K client rows.
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
// no order, so stats and pack give each (row, align-block) tile to one
// warp, 8 warps a CTA, the tiles in row-major order (tile t starts at
// element t * block). A warp's lane t holds the elements 4 t + 128 j + c
// (j < block / 128, c < 4; lanes below block / 4 when block < 128): one
// 16-byte load per j, the warp's 32 loads of a j one contiguous 512-byte
// run, all of a lane's loads issued before any arithmetic. No shared
// memory and no __syncthreads: while one warp reduces, the other resident
// warps' loads are in flight.
// - stats: max-abs runs on the float's int32 bit pattern with the sign
//   cleared, which orders like |x| and puts every NaN above +Inf, so NaN
//   survives (the screen's row-finite flag is all(isfinite(bmax))); a warp
//   shuffle max, in any order. The sum of squares takes the plain version's
//   halving order (kernels/ref._sumsq_blocks: y[i] = x[i]^2 + x[i + w/2]^2,
//   then y[i] + y[i + h] while the width halves), which the lane mapping
//   covers exactly: the levels h >= 128 pair a lane's own registers j and
//   j + h / 128, h = 64 ... 4 are __shfl_down_sync by h / 4 (the pair
//   level too when block <= 128), h = 2 and 1 pair c and c + h in lane 0.
//   __fmul_rn / __fadd_rn keep nvcc from contracting a*a + b*b into a
//   fused multiply-add, so the bits are the plain version's;
// - pack: codes clip(rint(x / s), -qmax, qmax) with IEEE division
//   (__fdiv_rn, no fast-math) and round half to even, as quantize.cu, four
//   a lane stored as one char4; the code of a NaN is 0 (the tail only packs
//   screened rows). Sum q^2 is an int32 warp shuffle sum (at most 1024 *
//   127^2 < 2^24: exact in any order); s^2 * sum(q^2) per tile goes to
//   scratch, and a second launch combines each row's blocks: one CTA per
//   row, thread i summing blocks i, i + 256, ... in order (coalesced), then
//   a fixed shuffle tree and a fixed tree over the 8 warps. The order is
//   fixed whatever order the tiles ran in: deterministic, no float atomics.
//   It is not the plain version's order; both are within (nb - 1) 2^-24 of
//   the exact sum (chip_smoke.qss_rtol);
// - apply: each thread owns 4 neighbouring output elements and starts from
//   the noise (or 0), then adds q[k] * coeff[k, block] for k = 0..K-1 in
//   order. That is the plain version's order (kernels/ref.agg_apply_ref,
//   which is what the JAX package runs off the TPU), not the TPU kernel's,
//   which sums over k first and adds the noise last.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (PERF.md): at
// (10, 1,695,744) stats takes 23.0 us (1.14x its bound; the one-CTA-per-
// block tree before it 66.0 us) and pack 33.4 us (1.32x: 30.5 us of codes
// plus 2.8 us of row combine; the one-thread-per-row sum before it took
// 92.3 us of 139.4).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // combine and apply
constexpr int kWarps = 8;      // tiles (one a warp) per CTA of stats / pack

// The lane mapping of a tile of W elements: kRows 16-byte loads a lane,
// over the first kLanes lanes.
template <int W>
struct Tile {
  static constexpr int kRows = W >= 128 ? W / 128 : 1;
  static constexpr int kLanes = W >= 128 ? 32 : W / 4;
};

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ int32_t abs_bits(float x) {
  return __float_as_int(x) & 0x7FFFFFFF;
}

// one warp per (row, align-block) tile of W elements
template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    block_stats_kernel(const float* __restrict__ x, int64_t tiles,
                       float* __restrict__ bmax, float* __restrict__ bsumsq) {
  using L = Tile<W>;
  const int lane = threadIdx.x & 31;
  const int64_t tile =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // the whole warp
  const float4* xb = reinterpret_cast<const float4*>(x + tile * W);
  float4 v[L::kRows];
#pragma unroll
  for (int j = 0; j < L::kRows; ++j) {
    v[j] = lane < L::kLanes ? __ldg(xb + j * 32 + lane)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int32_t m = 0;
#pragma unroll
  for (int j = 0; j < L::kRows; ++j) {
    m = max(m, max(max(abs_bits(v[j].x), abs_bits(v[j].y)),
                   max(abs_bits(v[j].z), abs_bits(v[j].w))));
  }
  // the levels h >= 128: a lane's own rows j and j + n / 2, the first of
  // them (h = W / 2) the pair of squares
  constexpr int kHalf = L::kRows > 1 ? L::kRows / 2 : 1;
  float y[kHalf][4];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float4 a = v[j];
    y[j][0] = sq(a.x);
    y[j][1] = sq(a.y);
    y[j][2] = sq(a.z);
    y[j][3] = sq(a.w);
    if constexpr (L::kRows > 1) {
      const float4 b = v[j + kHalf];
      y[j][0] = __fadd_rn(y[j][0], sq(b.x));
      y[j][1] = __fadd_rn(y[j][1], sq(b.y));
      y[j][2] = __fadd_rn(y[j][2], sq(b.z));
      y[j][3] = __fadd_rn(y[j][3], sq(b.w));
    }
  }
#pragma unroll
  for (int n = kHalf; n > 1; n /= 2) {
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) y[j][c] = __fadd_rn(y[j][c], y[j + n / 2][c]);
    }
  }
  // h = 64 ... 4 (from W / 2 when W <= 128): lane t + h / 4
#pragma unroll
  for (int off = (W >= 128 ? 128 : W) / 8; off > 0; off /= 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[0][c] = __fadd_rn(y[0][c],
                          __shfl_down_sync(0xffffffffu, y[0][c], off));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (lane == 0) {
    // h = 2 and 1 within the lane's four
    const float y0 = __fadd_rn(y[0][0], y[0][2]);
    const float y1 = __fadd_rn(y[0][1], y[0][3]);
    bmax[tile] = __int_as_float(m);
    bsumsq[tile] = __fadd_rn(y0, y1);
  }
}

__device__ __forceinline__ int32_t code(float x, float s, float qmax) {
  float v = rintf(__fdiv_rn(x, s));
  v = v < -qmax ? -qmax : (v > qmax ? qmax : v);  // NaN passes through
  return __float2int_rz(v);                       // ... and becomes 0
}

// one warp per (row, align-block) tile of W elements
template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    pack_kernel(const float* __restrict__ x,
                const float* __restrict__ sblock, int64_t tiles, float qmax,
                int8_t* __restrict__ q, float* __restrict__ bqss) {
  using L = Tile<W>;
  const int lane = threadIdx.x & 31;
  const int64_t tile =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;  // the whole warp
  const float s = sblock[tile];
  int32_t acc = 0;
  if (lane < L::kLanes) {
    const float4* xb = reinterpret_cast<const float4*>(x + tile * W);
    char4* qb = reinterpret_cast<char4*>(q + tile * W);
    float4 v[L::kRows];
#pragma unroll
    for (int j = 0; j < L::kRows; ++j) v[j] = __ldg(xb + j * 32 + lane);
#pragma unroll
    for (int j = 0; j < L::kRows; ++j) {
      const int32_t a = code(v[j].x, s, qmax), b = code(v[j].y, s, qmax),
                    c = code(v[j].z, s, qmax), d = code(v[j].w, s, qmax);
      qb[j * 32 + lane] = make_char4(static_cast<signed char>(a),
                                     static_cast<signed char>(b),
                                     static_cast<signed char>(c),
                                     static_cast<signed char>(d));
      acc += a * a + b * b + c * c + d * d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    bqss[tile] = __fmul_rn(static_cast<float>(acc), __fmul_rn(s, s));
  }
}

// out[row] = the sum of part[row, 0 .. nb): one CTA of kThreads a row,
// thread i summing blocks i, i + kThreads, ... in order, then a fixed tree
__global__ void __launch_bounds__(kThreads)
    row_combine_kernel(const float* __restrict__ part, int64_t nb,
                       float* __restrict__ out) {
  __shared__ float warp_sum[kThreads / 32];
  const float* p = part + static_cast<int64_t>(blockIdx.x) * nb;
  float acc = 0.f;
  for (int64_t b = threadIdx.x; b < nb; b += kThreads) {
    acc = __fadd_rn(acc, __ldg(p + b));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = kThreads / 64; off > 0; off /= 2) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    if (threadIdx.x == 0) out[blockIdx.x] = acc;
  }
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

unsigned tile_ctas(int64_t tiles) {
  return static_cast<unsigned>((tiles + kWarps - 1) / kWarps);
}

template <int W>
void launch_stats(const float* x, int64_t tiles, float* bmax, float* bsumsq,
                  cudaStream_t st) {
  block_stats_kernel<W><<<tile_ctas(tiles), kWarps * 32, 0, st>>>(
      x, tiles, bmax, bsumsq);
}

template <int W>
void launch_pack(const float* x, const float* sblock, int64_t tiles,
                 float qmax, int8_t* q, float* bqss, cudaStream_t st) {
  pack_kernel<W><<<tile_ctas(tiles), kWarps * 32, 0, st>>>(x, sblock, tiles,
                                                           qmax, q, bqss);
}

}  // namespace

// bmax, bsumsq (rows, n / block) float32: per (row, block) max|x| (NaN
// kept) and sum of squares. block is a power of two in [64, 2048]; x is
// 16-byte aligned.
extern "C" int agg_block_stats_f32(const float* x, int64_t rows, int64_t n,
                                   int block, float* bmax, float* bsumsq,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = rows * (n / block);
  switch (block) {
    case 64: launch_stats<64>(x, tiles, bmax, bsumsq, st); break;
    case 128: launch_stats<128>(x, tiles, bmax, bsumsq, st); break;
    case 256: launch_stats<256>(x, tiles, bmax, bsumsq, st); break;
    case 512: launch_stats<512>(x, tiles, bmax, bsumsq, st); break;
    case 1024: launch_stats<1024>(x, tiles, bmax, bsumsq, st); break;
    case 2048: launch_stats<2048>(x, tiles, bmax, bsumsq, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (rows, n) int8 codes with per-(row, block) scales sblock (rows, n /
// block); bqss (rows, n / block) scratch; qss (rows,) = the sum over blocks
// of s^2 * sum(q^2), in the combine's fixed order. x is 16-byte aligned.
extern "C" int agg_pack_f32(const float* x, const float* sblock, int64_t rows,
                            int64_t n, int block, float qmax, int8_t* q,
                            float* bqss, float* qss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb = n / block;
  const int64_t tiles = rows * nb;
  switch (block) {
    case 64: launch_pack<64>(x, sblock, tiles, qmax, q, bqss, st); break;
    case 128: launch_pack<128>(x, sblock, tiles, qmax, q, bqss, st); break;
    case 256: launch_pack<256>(x, sblock, tiles, qmax, q, bqss, st); break;
    case 512: launch_pack<512>(x, sblock, tiles, qmax, q, bqss, st); break;
    case 1024: launch_pack<1024>(x, sblock, tiles, qmax, q, bqss, st); break;
    case 2048: launch_pack<2048>(x, sblock, tiles, qmax, q, bqss, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_combine_kernel<<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
      bqss, nb, qss);
  return static_cast<int>(cudaGetLastError());
}

// qss (rows,) = the sum of each row of part (rows, nb), in pack's combine
// order: a mesh's per-block sums gathered whole give the whole call's qss
extern "C" int agg_row_combine_f32(const float* part, int64_t rows,
                                   int64_t nb, float* qss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_combine_kernel<<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
      part, nb, qss);
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
