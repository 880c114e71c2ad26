// Per-leaf int-k fake-quantize of block-aligned flat client deltas, for
// sm_90a, over the whole (K, N) buffer of K client rows: the one-launch
// cluster route, and the two-pass route (a max-abs kernel, then a Q->DQ
// kernel).
//
// Replaces: src/repro/kernels/quantize.py, _maxabs_kernel (leaf_maxabs)
// and _qdq_kernel (fake_quantize_flat), which the JAX package maps over
// the K rows one launch each (core/flat.fake_quantize, kernels/ops.py
// _fake_quantize, when RoundConfig.uplink_bits == 8).
//
// Bound on this card: bytes. Q->DQ reads and writes K*N*4 bytes each
// (~2.1 us at the EMNIST round's (10, 89,088) at 3.35 TB/s); max-abs
// alone reads K*N*4. The few flops per element are far below the card's
// rate.
//
// Both routes are bit-for-bit core/compress.quantize_leaf: the per-leaf
// maximum runs on the float's int32 bit pattern with the sign cleared,
// which orders like |x| and puts every NaN above +Inf (a NaN is kept where
// fmaxf would drop it, as jnp.max(jnp.abs(x)) keeps it), and an integer
// max is order-free, so deterministic; Q->DQ uses IEEE division (no
// fast-math, __fdiv_rn), round half to even (rintf), a clip that lets NaN
// through, __fmul_rn, and scales max(m, 1e-12)/qmax computed in float32
// with a NaN kept.
//
// Cluster route (qdq_cluster_kernel): a thread-block cluster of C CTAs
// owns one row, so x is read once and nothing crosses launches. Each CTA
// holds a contiguous share of the row's 1024-element blocks in registers
// (one 16-byte load a thread per block), folds each block's max into a
// per-leaf table in its shared memory (shared atomicMax), and pushes the
// table into every peer's shared memory over DSMEM (remote stores, which
// do not wait, where remote loads would wait C times in a row); one
// cluster barrier later every CTA holds all C tables and takes the row's
// per-leaf maxima locally: no memset, no global atomics, no second
// launch. The barrier that lets a CTA write into its peers (all of them
// running) is split: arrived at entry, waited on after the loads. After
// the last barrier no CTA touches another's shared memory, so none can
// leave while a peer reads it. Then Q->DQ from the registers, 16-byte
// stores. The TPU kernels get the
// block->leaf map by scalar prefetch and carry per-leaf maxima in SMEM
// across a sequential grid; here any map with values in [0, L) works.
//
// Two-pass route (rows longer than C CTAs' registers hold, or more leaves
// than the shared table): the max-abs kernel below, then the Q->DQ kernel
// (grid (blocks, rows), one thread block per block) reads x again.
//
// Max-abs (maxabs_fold_kernel, the first pass; leaf_maxabs). Bound: bytes,
// K*N*4 read once (20.25 us at the FedAvg (10, 1,695,744), 1.06 us at
// (10, 89,088)). What would keep it from the bound, and the answer here:
// - setting up and retiring a CTA costs more than a 4 KB read: a warp
//   takes whole pieces (a 1024-block; a block of at most 1024 elements, or
//   a 1024-element slice of a longer one) of the flattened (row, piece)
//   index space, piece t at x + t * piece, lane l the elements
//   4 l + 128 j + c (j < 8), eight 16-byte __ldg loads in flight; a warp
//   takes `per_warp` consecutive pieces and loads piece t + 1 into a second
//   register set before it reduces piece t, so each warp keeps 8 KB in
//   flight. The grid (kernels/quantize.maxabs_plan, from the shape alone)
//   is at most 264 CTAs of 8 warps, two an SM, 128 KB in flight an SM,
//   and no more CTAs than one piece a warp needs at small sizes;
// - an atomic per block lands on one word per leaf (1,568 a row at the
//   FedAvg width), serialized in L2: a warp's consecutive pieces of one
//   (row, leaf) fold their maxima in registers, and only when the run ends
//   does a shuffle max and one atomicMax follow. Any block->leaf map with
//   values in [0, L) works; a map that changes leaf at every block costs
//   one atomic a piece;
// - the table must start at zero: a memset of out, then this kernel. A
//   one-launch variant (a per-stream workspace kept at zero, an arrival
//   ticket, the last CTA copying the maxima out and zeroing it again) was
//   slower a call on the H100 than the memset and this kernel (PERF.md
//   section 6, row 2), so the memset stays;
// - 4-byte loads keep too few bytes in flight: 16-byte loads; a base that
//   is not 16-byte aligned takes scalar loads in the same order (kVec
//   false).
// The pieces' offsets are pointer steps from the warp's first piece (one
// 64-bit product a warp); row, block and leaf index math is 32-bit. An
// integer max is order-free, so any grid gives the same bits.
// A leaf index outside [0, L) in the map is skipped (its pieces fold into
// no leaf), so a bad map never writes outside out.
// Times against the bound: PERF.md section 6, row 2 (chip_smoke.py
// --kernel-times).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// cluster route: a thread group of 256 holds one float4 each of a block
constexpr int kBlock = 4 * kThreads;
constexpr int kMaxLeaves = 256;
constexpr int kMaxCtas = 16;

__device__ __forceinline__ float qdq(float x, float s, float qmax) {
  float q = rintf(__fdiv_rn(x, s));
  q = q < -qmax ? -qmax : (q > qmax ? qmax : q);  // NaN passes through
  return __fmul_rn(q, s);
}

__device__ __forceinline__ int32_t abs_bits(float v) {
  return __float_as_int(v) & 0x7FFFFFFF;
}

// s = max(m, 1e-12) / qmax; jnp.maximum keeps a NaN, fmaxf would drop it
__device__ __forceinline__ float leaf_scale_of(float m, float qmax) {
  return __fdiv_rn(m != m ? m : fmaxf(m, 1e-12f), qmax);
}

// max-abs: warps a CTA, and CTAs an SM the registers allow (two register
// sets of eight float4 a lane)
constexpr int kFoldWarps = 8;
constexpr int kFoldThreads = 32 * kFoldWarps;

// One piece of `rows128` x 128 elements (rows128 <= 8): lane l loads the
// elements 4 l + 128 j + c, j < rows128, all issued before any use.
template <bool kVec>
__device__ __forceinline__ void load_piece(float4 (&v)[8],
                                           const float* __restrict__ p,
                                           int lane, int rows128) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < rows128) {
      const float* q = p + 128 * j + 4 * lane;
      v[j] = kVec ? __ldg(reinterpret_cast<const float4*>(q))
                  : make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2),
                                __ldg(q + 3));
    } else {
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ int32_t piece_max(const float4 (&v)[8]) {
  int32_t m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m = max(m, max(max(abs_bits(v[j].x), abs_bits(v[j].y)),
                   max(abs_bits(v[j].z), abs_bits(v[j].w))));
  }
  return m;
}

// The fold of a warp's run over its consecutive pieces: the (row, leaf)
// key of the run, the lane's max over it, and the cursor (row, block,
// piece of the block) of the next piece to reduce.
struct Run {
  int key;
  int32_t m;
  int row, b, sub;
};

// Ends the warp's run (a shuffle max, one atomicMax from lane 0); a run
// of a leaf outside [0, L) (key < 0) writes nothing.
__device__ __forceinline__ void end_run(int32_t* table, const Run& r) {
  if (r.key < 0) return;
  int32_t m = r.m;
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0) atomicMax(table + r.key, m);
}

// Folds the next piece (its loads in v) into the run, ending the run
// first when the piece starts another (row, leaf); all branches are
// uniform over the warp. A leaf outside [0, L) gets the key -2, no word.
__device__ __forceinline__ void fold_piece(
    Run& r, const float4 (&v)[8], const int32_t* __restrict__ block_leaf,
    int nb, int per_block, int n_leaves, int32_t* table) {
  const int leaf = __ldg(block_leaf + r.b);
  const int key = static_cast<unsigned>(leaf) < static_cast<unsigned>(n_leaves)
                      ? r.row * n_leaves + leaf
                      : -2;
  if (key != r.key) {
    end_run(table, r);
    r.key = key;
    r.m = 0;
  }
  r.m = max(r.m, piece_max(v));
  if (++r.sub == per_block) {
    r.sub = 0;
    if (++r.b == nb) {
      r.b = 0;
      ++r.row;
    }
  }
}

// grid (maxabs_plan), kFoldThreads threads. Warp w of the grid takes the
// pieces [w * per_warp, min((w + 1) * per_warp, pieces)) of the flattened
// (row, piece) space, piece t at x + t * piece (piece = rows128 * 128
// elements, per_block pieces a block, nb blocks a row) and folds their
// maxima into the zeroed table (rows, L).
template <bool kVec>
__global__ void __launch_bounds__(kFoldThreads, 2)
maxabs_fold_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ block_leaf, int nb,
                   int per_block, int rows128, int n_leaves, int pieces,
                   int per_warp, int32_t* table) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kFoldWarps + (threadIdx.x >> 5);
  const int t0 = w * per_warp;
  const int t1 = min(t0 + per_warp, pieces);
  if (t0 >= t1) return;
  const int step = rows128 * 128;
  const float* p = x + static_cast<int64_t>(t0) * step;
  const int per_row = nb * per_block;
  Run r;
  r.key = -1;
  r.m = 0;
  r.row = t0 / per_row;
  const int in_row = t0 - r.row * per_row;
  r.b = in_row / per_block;
  r.sub = in_row - r.b * per_block;
  // two register sets: the next piece's loads are in flight while this
  // one is reduced (a copy between the sets would wait for them)
  float4 va[8], vb[8];
  load_piece<kVec>(va, p, lane, rows128);
  for (int t = t0; t < t1; t += 2) {
    if (t + 1 < t1) load_piece<kVec>(vb, p + step, lane, rows128);
    fold_piece(r, va, block_leaf, nb, per_block, n_leaves, table);
    if (t + 1 >= t1) break;
    if (t + 2 < t1) load_piece<kVec>(va, p + 2 * step, lane, rows128);
    fold_piece(r, vb, block_leaf, nb, per_block, n_leaves, table);
    p += 2 * step;
  }
  end_run(table, r);
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
    scale = leaf_scale_of(maxabs[row * n_leaves + block_leaf[b]], qmax);
  }
  __syncthreads();
  const float s = scale;
  const int64_t base = row * n + b * block;
  for (int i = threadIdx.x; i < block; i += kThreads) {
    y[base + i] = qdq(x[base + i], s, qmax);
  }
}

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

// Folds a warp's max for one leaf into the CTA's table: a shuffle tree,
// then one shared atomicMax (order-free) from lane 0.
__device__ __forceinline__ void fold_leaf_max(int32_t* table, int leaf,
                                              int32_t m) {
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((threadIdx.x & 31) == 0) atomicMax(table + leaf, m);
}

// grid (C, rows), cluster (C, 1, 1), kGroups * 256 threads a CTA. CTA r of
// row blockIdx.y holds the blocks [r * nb / C, (r + 1) * nb / C); its
// thread group g (256 threads, one float4 each of a block) takes the
// CTA's blocks g, g + kGroups, ..., at most kPerThread of them.
template <int kGroups, int kPerThread, bool kVec>
__global__ void __launch_bounds__(kGroups * kThreads)
qdq_cluster_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ block_leaf, int64_t n,
                   int n_leaves, float qmax, float* __restrict__ y) {
  constexpr int kCtaThreads = kGroups * kThreads;
  __shared__ int32_t leaf_bits[kMaxLeaves];           // this CTA's maxima
  __shared__ int32_t peer_bits[kMaxCtas * kMaxLeaves];  // every CTA's, by rank
  __shared__ float leaf_scale[kMaxLeaves];
  // phase 1 of the cluster barrier: this CTA runs (a peer may write into
  // its shared memory once every CTA has arrived); waited on below
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = static_cast<int>(n / kBlock);
  const int b0 = rank * nb / ctas;
  const int count = (rank + 1) * nb / ctas - b0;
  const int g = threadIdx.x / kThreads;
  const int64_t base = blockIdx.y * n
                       + static_cast<int64_t>(b0 + g) * kBlock
                       + 4 * (threadIdx.x % kThreads);

  for (int l = threadIdx.x; l < n_leaves; l += kCtaThreads) leaf_bits[l] = 0;
  float4 v[kPerThread];
  int leaf[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (g + j * kGroups < count) {
      const float* p = x + base + static_cast<int64_t>(j) * kGroups * kBlock;
      v[j] = kVec ? __ldg(reinterpret_cast<const float4*>(p))
                  : make_float4(p[0], p[1], p[2], p[3]);
      leaf[j] = __ldg(block_leaf + b0 + g + j * kGroups);
    }
  }
  __syncthreads();  // the table is zeroed
  // a run of blocks of one leaf shares one fold (the branches are uniform
  // over each warp: a warp lies in one thread group)
  int run_leaf = -1;
  int32_t run = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (g + j * kGroups < count) {
      const int32_t m = max(max(abs_bits(v[j].x), abs_bits(v[j].y)),
                            max(abs_bits(v[j].z), abs_bits(v[j].w)));
      if (leaf[j] == run_leaf) {
        run = max(run, m);
      } else {
        if (run_leaf >= 0) fold_leaf_max(leaf_bits, run_leaf, run);
        run_leaf = leaf[j];
        run = m;
      }
    }
  }
  if (run_leaf >= 0) fold_leaf_max(leaf_bits, run_leaf, run);
  __syncthreads();  // this CTA's table is complete
  cluster_wait();   // every CTA of the cluster runs
  // push: this CTA's table into every CTA's peer_bits, row `rank`
  for (int i = threadIdx.x; i < ctas * n_leaves; i += kCtaThreads) {
    const int r = i / n_leaves;
    const int l = i - r * n_leaves;
    cluster.map_shared_rank(peer_bits, r)[rank * n_leaves + l] = leaf_bits[l];
  }
  // phase 2: every table is in every CTA. No CTA touches another's shared
  // memory after this barrier, so each may run on and exit alone.
  cluster_arrive_release();
  cluster_wait();
  for (int l = threadIdx.x; l < n_leaves; l += kCtaThreads) {
    int32_t m = 0;
    for (int r = 0; r < ctas; ++r) m = max(m, peer_bits[r * n_leaves + l]);
    leaf_scale[l] = leaf_scale_of(__int_as_float(m), qmax);
  }
  __syncthreads();  // leaf_scale is complete
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (g + j * kGroups < count) {
      const float s = leaf_scale[leaf[j]];
      const float4 o = make_float4(qdq(v[j].x, s, qmax), qdq(v[j].y, s, qmax),
                                   qdq(v[j].z, s, qmax), qdq(v[j].w, s, qmax));
      float* p = y + base + static_cast<int64_t>(j) * kGroups * kBlock;
      if (kVec) {
        *reinterpret_cast<float4*>(p) = o;
      } else {
        p[0] = o.x;
        p[1] = o.y;
        p[2] = o.z;
        p[3] = o.w;
      }
    }
  }
}

struct ClusterArgs {
  const float* x;
  const int32_t* block_leaf;
  int64_t rows, n;
  int ctas, n_leaves;
  float qmax;
  float* y;
  cudaStream_t st;
};

template <int kGroups, int kPerThread, bool kVec>
cudaError_t launch_cluster(const ClusterArgs& a) {
  auto kernel = qdq_cluster_kernel<kGroups, kPerThread, kVec>;
  if (a.ctas > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.ctas),
                     static_cast<unsigned>(a.rows), 1);
  cfg.blockDim = dim3(kGroups * kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.x, a.block_leaf, a.n, a.n_leaves,
                            a.qmax, a.y);
}

template <int kGroups, int kPerThread>
cudaError_t launch_cluster_vec(const ClusterArgs& a) {
  const bool vec = ((reinterpret_cast<uintptr_t>(a.x)
                     | reinterpret_cast<uintptr_t>(a.y)) & 15) == 0;
  return vec ? launch_cluster<kGroups, kPerThread, true>(a)
             : launch_cluster<kGroups, kPerThread, false>(a);
}

template <int kGroups>
cudaError_t launch_cluster_groups(int per_thread, const ClusterArgs& a) {
  switch (per_thread) {
    case 1: return launch_cluster_vec<kGroups, 1>(a);
    case 2: return launch_cluster_vec<kGroups, 2>(a);
    case 4: return launch_cluster_vec<kGroups, 4>(a);
    case 8: return launch_cluster_vec<kGroups, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (rows, n_leaves) int32: the sign-cleared bit pattern of each leaf's
// max|x| (view it as float32). x is (rows, n), n = nb * block; block a
// multiple of 128, at most 1024 or a multiple of 1024 (the piece is the
// block, or a 1024-element slice of it); `grid` CTAs, `per_warp` pieces a
// warp (kernels/quantize.maxabs_plan), covering every piece. A memset of
// out, then the fold kernel into it.
extern "C" int leaf_maxabs_f32(const float* x, const int32_t* block_leaf,
                               int64_t rows, int64_t n, int block,
                               int n_leaves, int grid, int per_warp,
                               int32_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int piece = block <= 1024 ? block : 1024;
  const int64_t nb = n / block;
  const int64_t pieces = rows * (n / piece);
  const int64_t words = rows * n_leaves;
  if (block < 128 || block % 128 || block % piece || n % block ||
      n_leaves < 1 || grid < 1 || per_warp < 1 || words >= (1LL << 31) ||
      static_cast<int64_t>(grid) * kFoldWarps * per_warp < pieces ||
      static_cast<int64_t>(grid) * kFoldWarps * per_warp >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * words, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = (reinterpret_cast<uintptr_t>(x) & 15) == 0
                    ? maxabs_fold_kernel<true>
                    : maxabs_fold_kernel<false>;
  kernel<<<grid, kFoldThreads, 0, st>>>(x, block_leaf, static_cast<int>(nb),
                                        block / piece, piece / 128, n_leaves,
                                        static_cast<int>(pieces), per_warp,
                                        out);
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

// The cluster route: y = Q->DQ(x) with per-(row, leaf) scales, one launch
// with one cluster of `ctas` CTAs (at most 16; past 8 a non-portable size)
// a row, `groups` x 256 threads a CTA (1 or 2), each thread holding at
// most `per_thread` (1, 2, 4 or 8) float4s. x, y (rows, n), n a multiple of 1024; n_leaves <=
// 256; block_leaf values in [0, n_leaves).
extern "C" int fake_quantize_cluster_f32(const float* x,
                                         const int32_t* block_leaf,
                                         int64_t rows, int64_t n, int ctas,
                                         int groups, int per_thread,
                                         int n_leaves, float qmax, float* y,
                                         void* stream) {
  const int64_t nb = n / kBlock;
  if (n % kBlock || n_leaves > kMaxLeaves || ctas < 1 || ctas > 16 ||
      (nb + ctas - 1) / ctas > static_cast<int64_t>(groups) * per_thread) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClusterArgs a{x, block_leaf, rows, n, ctas, n_leaves, qmax, y,
                      static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (groups) {
    case 1: err = launch_cluster_groups<1>(per_thread, a); break;
    case 2: err = launch_cluster_groups<2>(per_thread, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
