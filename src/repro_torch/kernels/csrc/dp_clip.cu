// Per-row L2 clip of flat float32 client deltas, and the clip-and-accumulate
// of one delta into an aggregation buffer, for sm_90a.
//
// Replaces: src/repro/kernels/dp_clip.py, _scale_kernel (clip_flat; the
// async client step's DP clip, reached through core/flat.clip) and
// _scale_add_kernel (clip_accumulate; reached through kernels/ops only),
// together with the _sumsq_kernel stage both of them run first.
//
// Bound on this card: bytes. The least work reads every element once and
// writes it once: 8 * R * N bytes for clip_flat, 1.28 us at the async
// lane's (6, 89,088) at 3.35 TB/s; clip_accumulate 12 * N bytes. Three
// operations per element are far below the card's float32 rate.
//
// The TPU kernel carries the sum of squares in one SMEM cell across a
// sequential grid of 32768-element tiles. Hopper's blocks run in parallel
// and in no order, so the norm takes a fixed order, with no float atomics
// (the same bits on every run), on either of two routes that give the
// same bits:
// - each align-block's sum of squares in the plain version's order
//   (kernels/ref._sumsq_blocks): y[i] = x[i]^2 + x[i + block/2]^2, then
//   halving. __fmul_rn / __fadd_rn keep nvcc from contracting into fused
//   multiply-adds, so these sums are the plain version's bits. A ragged
//   last block reads zeros past the row's end;
// - the row combine: thread t of 256 sums the blocks t, t + 256, ... from
//   0 in that order, then a 256-wide halving tree; norm = sqrt(sum) and
//   scale = min(1, C / max(norm, 1e-12)) with IEEE division (__fdiv_rn,
//   no fast-math), NaN kept as jnp.minimum and jnp.maximum keep it (fminf
//   / fmaxf would drop it);
// - out = x * scale (or acc + x * scale). A row whose norm is at most C
//   has scale exactly 1 and comes back bit for bit.
// The combine order differs from the plain version's torch.sum over the
// blocks, so the norms agree within dp_clip.norm_rtol.
//
// Cluster route (clip_cluster_kernel; rows of n % 4 == 0 and at most
// C * 32 blocks): one launch, x read once. A thread-block cluster of C <=
// 16 CTAs owns one row; each warp of a CTA holds one 1024-block of the
// CTA's contiguous share in registers, lane t the elements 4 t + 128 j + c
// (eight 16-byte loads), so every halving level of the block pairs a
// lane's own registers, lanes (a shuffle) or the four floats of one load,
// as agg_tail.cu's block_stats does. Each warp pushes its block's sum, by
// block index, into every CTA's shared array (remote DSMEM stores); one
// cluster barrier later every warp holds all the row's block sums and
// takes the row combine itself (its lane l stands for the combine's
// threads l + 32 k, so the tree's first three levels pair a lane's own
// values and the last five are shuffles), scales its registers and
// stores them 16 bytes at a time. The barrier that lets a CTA write into
// its peers is split as in quantize.cu: arrived at entry, waited on after
// the loads.
//
// Three-launch route (every other row, and clip_accumulate): stage 1, one
// CUDA block per (row, align-block), the block sums through a shared-
// memory tree; stage 2, one CUDA block per row, the row combine; stage 3,
// the scale, elementwise, reading x again.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// norm = sqrt(total), scale = min(1, clip / max(norm, 1e-12)), a NaN kept
__device__ __forceinline__ float clip_scale(float norm, float clip) {
  const float den = isnan(norm) ? norm : fmaxf(norm, 1e-12f);
  const float r = __fdiv_rn(clip, den);
  return isnan(r) ? r : fminf(1.f, r);
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
    norms[row] = norm;
    scales[row] = clip_scale(norm, clip);
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

// --- the cluster route -----------------------------------------------------

constexpr int kBlock = 1024;     // elements of an align-block
constexpr int kMaxCtas = 16;     // CTAs a cluster (past 8: non-portable)
constexpr int kMaxWarps = 32;    // warps a CTA, one block each
constexpr int kMaxBlocks = kMaxCtas * kMaxWarps;

// The two halves of a cluster barrier (every thread of every CTA of the
// cluster arrives; a wait returns once all have arrived): arrive relaxed
// or with release semantics, wait with acquire semantics.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float sq(float v) { return __fmul_rn(v, v); }

// One 1024-block's sum of squares in the plain halving order, from the
// warp's registers (lane t holds v[j] = x[4 t + 128 j + c]); lane 0 gets it.
__device__ __forceinline__ float warp_block_sumsq(const float4 (&v)[8]) {
  float y[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // h = 512: registers j and j + 4
    y[j][0] = __fadd_rn(sq(v[j].x), sq(v[j + 4].x));
    y[j][1] = __fadd_rn(sq(v[j].y), sq(v[j + 4].y));
    y[j][2] = __fadd_rn(sq(v[j].z), sq(v[j + 4].z));
    y[j][3] = __fadd_rn(sq(v[j].w), sq(v[j + 4].w));
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // h = 256, 128
    y[0][c] = __fadd_rn(y[0][c], y[2][c]);
    y[1][c] = __fadd_rn(y[1][c], y[3][c]);
    y[0][c] = __fadd_rn(y[0][c], y[1][c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {  // h = 64 ... 4: lane t + h / 4
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[0][c] = __fadd_rn(y[0][c],
                          __shfl_down_sync(0xffffffffu, y[0][c], off));
    }
  }
  // h = 2 and 1 within the lane's four
  return __fadd_rn(__fadd_rn(y[0][0], y[0][2]), __fadd_rn(y[0][1], y[0][3]));
}

// row_scale_kernel's combine of nb block sums, by one warp: lane l holds
// the combine's threads l + 32 k (k < 8); the total is in every lane.
__device__ __forceinline__ float warp_row_total(const float* bsum, int nb) {
  const int lane = threadIdx.x & 31;
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = 0.f;
    for (int b = lane + 32 * k; b < nb; b += kCombineThreads) {
      a[k] = __fadd_rn(a[k], bsum[b]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __fadd_rn(a[k], a[k + 4]);  // s = 128
  a[0] = __fadd_rn(a[0], a[2]);                                  // s = 64
  a[1] = __fadd_rn(a[1], a[3]);
  a[0] = __fadd_rn(a[0], a[1]);                                  // s = 32
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {                       // s = 16 ... 1
    a[0] = __fadd_rn(a[0], __shfl_down_sync(0xffffffffu, a[0], off));
  }
  return __shfl_sync(0xffffffffu, a[0], 0);
}

// grid (C, rows), cluster (C, 1, 1), kWarps * 32 threads a CTA. CTA r of
// row blockIdx.y holds the blocks [r * nb / C, (r + 1) * nb / C); its warp
// w the CTA's block w. n % 4 == 0, nb <= C * kWarps.
template <int kWarps, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
clip_cluster_kernel(const float* __restrict__ x, int n, float clip,
                    float* __restrict__ norms, float* __restrict__ out) {
  __shared__ float bsum[kMaxBlocks];  // every block sum of the row
  // phase 1 of the cluster barrier: this CTA runs (a peer may write into
  // its shared memory once every CTA has arrived); waited on below
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = (n + kBlock - 1) / kBlock;
  const int b0 = rank * nb / ctas;
  const int count = (rank + 1) * nb / ctas - b0;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool mine = w < count;  // uniform over the warp
  const int64_t row = static_cast<int64_t>(blockIdx.y) * n;
  const int e0 = (b0 + w) * kBlock + 4 * lane;  // element of v[0].x
  const float* xr = x + row;
  float* yr = out + row;

  float4 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = e0 + 128 * j;
    if (mine && e < n) {  // n % 4 == 0: a float4 is whole or past the end
      v[j] = kVec ? __ldg(reinterpret_cast<const float4*>(xr + e))
                  : make_float4(xr[e], xr[e + 1], xr[e + 2], xr[e + 3]);
    } else {
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float s = warp_block_sumsq(v);
  cluster_wait();  // every CTA of the cluster runs
  if (mine) {
    // push: lane r stores the block's sum into CTA r's array
    const float total = __shfl_sync(0xffffffffu, s, 0);
    if (lane < ctas) cluster.map_shared_rank(bsum, lane)[b0 + w] = total;
  }
  // phase 2: every block sum is in every CTA. No CTA touches another's
  // shared memory after this barrier, so each may run on and exit alone.
  cluster_arrive_release();
  cluster_wait();
  if (!mine) return;
  const float norm = __fsqrt_rn(warp_row_total(bsum, nb));
  const float scale = clip_scale(norm, clip);
  if (rank == 0 && w == 0 && lane == 0) norms[blockIdx.y] = norm;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = e0 + 128 * j;
    if (e < n) {
      const float4 o = make_float4(__fmul_rn(v[j].x, scale),
                                   __fmul_rn(v[j].y, scale),
                                   __fmul_rn(v[j].z, scale),
                                   __fmul_rn(v[j].w, scale));
      if (kVec) {
        *reinterpret_cast<float4*>(yr + e) = o;
      } else {
        yr[e] = o.x;
        yr[e + 1] = o.y;
        yr[e + 2] = o.z;
        yr[e + 3] = o.w;
      }
    }
  }
}

struct ClusterArgs {
  const float* x;
  int64_t rows;
  int n, ctas;
  float clip;
  float* norms;
  float* out;
  cudaStream_t st;
};

template <int kWarps, bool kVec>
cudaError_t launch_cluster(const ClusterArgs& a) {
  auto kernel = clip_cluster_kernel<kWarps, kVec>;
  if (a.ctas > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.ctas),
                     static_cast<unsigned>(a.rows), 1);
  cfg.blockDim = dim3(kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.x, a.n, a.clip, a.norms, a.out);
}

template <int kWarps>
cudaError_t launch_cluster_vec(const ClusterArgs& a) {
  const bool vec = ((reinterpret_cast<uintptr_t>(a.x)
                     | reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
  return vec ? launch_cluster<kWarps, true>(a)
             : launch_cluster<kWarps, false>(a);
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

// The cluster route: out = x * min(1, clip / ||x||) of each of `rows` rows
// of x (rows, n), norms (rows,) the pre-clip norms, in one launch with one
// cluster of `ctas` CTAs (at most 16; past 8 a non-portable size) a row
// and `warps` (4, 8, 16 or 32) warps a CTA, one 1024-block a warp. n > 0,
// n % 4 == 0, ctas <= ceil(n / 1024) <= ctas * warps (so every CTA holds a
// block, rank 0 the row's first). The same bits as
// dp_clip_rows_f32 at block 1024.
extern "C" int dp_clip_cluster_f32(const float* x, int64_t rows, int64_t n,
                                   int ctas, int warps, float clip,
                                   float* norms, float* out, void* stream) {
  const int64_t nb = (n + kBlock - 1) / kBlock;
  if (n <= 0 || n % 4 || ctas < 1 || ctas > kMaxCtas || ctas > nb ||
      nb > static_cast<int64_t>(ctas) * warps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClusterArgs a{x, rows, static_cast<int>(n), ctas, clip, norms, out,
                      static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (warps) {
    case 4: err = launch_cluster_vec<4>(a); break;
    case 8: err = launch_cluster_vec<8>(a); break;
    case 16: err = launch_cluster_vec<16>(a); break;
    case 32: err = launch_cluster_vec<32>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
