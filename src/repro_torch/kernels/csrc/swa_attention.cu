// Causal, optionally sliding-window, flash attention for sm_90a.
//
// Replaces: src/repro/kernels/swa_attention.py, _swa_kernel / swa_attention,
// the TPU kernel behind the long_500k serving shape. On the card it runs in
// every attention layer of models/decoder_lm.forward (prefill), through
// nn/attention.flash_attention and kernels/ops.swa_attention.
//
// q and k have one head dim (DK), v and the output another (DV): MLA
// (DeepSeek-V2) attends with 192-wide q / k heads (128 + a 64-wide rope
// part) and 128-wide v heads; the other models have DK = DV (PaliGemma:
// 256).
//
// The mask is the reference's (nn/attention._attend_chunk): causal, with an
// optional bidirectional prefix of P keys that every row sees (PaliGemma's
// 256 image positions), and an optional window (q - k < window); or
// non-causal, where q may have other rows than k and v (Sq != Skv:
// Whisper's cross-attention, decoder tokens against 1,500 frames).
//
// Bound on this card: operations. Each (q, k) pair that the mask lets
// through costs 2 * (DK + DV) flops (q.k and p.v); at B = 1, H = 32,
// DK = DV = 128, S = 32768 the causal pairs (536.9 M per head) need
// 8.8 TFLOP, 8.9 ms at the 989 TFLOP/s of the bf16 tensor cores, and a
// window of 8192 (234.9 M pairs per head) 3.9 ms; MLA's 128 heads at
// (192, 128) need 44.0 TFLOP, 44.5 ms. The bytes (q and o with 32 heads, k
// and v with 8 kv heads, each read or written once: 0.67 GB in bf16) take
// 0.2 ms.
//
// The function (the reference's arithmetic, every dtype): s = (q.k) * scale
// in float32, masked to NEG_INF = -1e30; m_new = max(m, rowmax(s));
// p = expf(s - m_new); corr = expf(m - m_new); l = l * corr + sum(p);
// acc = acc * corr + p @ v; out = acc / max(l, 1e-30), rounded once to q's
// type. Two modes for bf16 / fp16:
// - p at float32 accuracy (round_p = 0), as in the TPU kernel, which
//   upcasts q, k and v: ops.swa_attention's default;
// - p rounded once to v's type before p @ v (round_p = 1), l still summing
//   the float32 p: the reference's nn/attention.flash_attention over 64-key
//   tiles (kernels/ref.chunked_attention_ref(..., chunk=64) is its plain
//   version), which the card's flash_attention runs.
// For float32 the two are the same function.
// A row whose first tile is wholly masked adds exp(0) rubbish that the next
// live score wipes out (corr = exp(-1e30 - m) = 0), as in the reference.
//
// bf16 and fp16: swa_kernel_tc, on the tensor cores.
// - One block of 384 threads per (batch * head, 128-row q tile), the tiles
//   with the most KV work (the last, under a causal mask) launched first.
//   Warpgroups 0 and 1 each own 64 q rows; one warp of warpgroup 2 loads
//   (setmaxnreg moves registers from it to the two consumers).
// - The block walks the 64-key KV tiles that intersect its mask, in
//   ascending order; the tiles outside the window are never read. The
//   formulas are kernels/swa_attention.tile_plan's: the block's range is
//   tile_plan(bq=128, bk=64)'s; each warpgroup masks element by element
//   only the tiles that are not whole and visible from all its rows, those
//   that straddle the diagonal, the prefix's edge, the window's edge or Skv
//   (tile_plan(bq=64)). Row r sees keys [key_lo(r), key_hi(r)], key_hi(r) =
//   max(r, P - 1) under the causal mask, Skv - 1 otherwise: both
//   nondecreasing in r, so the prefix and Skv change only key_hi.
//   Both warpgroups compute every tile of the block: a wgmma under a
//   per-warpgroup condition is serialized by ptxas. A tile that none of a
//   warpgroup's rows sees is masked whole, which changes no output bit
//   (p = exp(-1e30 - m) = 0 and corr = 1 after a live score, the rubbish
//   above before one).
// - q (once) and each K and V tile arrive in shared memory as bf16 / fp16
//   through TMA (4-d tensor maps over the strided (B, H, S, D) views,
//   128-byte swizzle, out-of-range rows and columns filled with zeros),
//   into a ring of 3 stages with separate K and V buffers, completion
//   through mbarriers; the consumers release each buffer as soon as their
//   product has read it. A view that TMA refuses (a base or a stride that
//   is not a multiple of 16 bytes, e.g. a contiguous D = 100) is copied by
//   the loading warp itself into the same swizzled ring.
// - S = q k^T: wgmma m64n64k16, both operands from shared memory, float32
//   accumulators (a bf16 * bf16 product is exact in float32; only the order
//   of the float32 sums differs from the plain version).
// - p.v at float32-p accuracy: p = p_hi + p_lo with p_hi = T(p) and
//   p_lo = T(p - p_hi) (kernels/ref.split_p), |p - p_hi - p_lo| <= 2^-16 p
//   in bf16 (2^-22 p in fp16); acc += p_hi v + p_lo v by two register-A
//   wgmmas m64nDVk16 per 16 keys, V read transposed through its
//   descriptor. The score accumulators' layout is the A fragments' layout,
//   so p never goes through shared memory. 2 * DK + 4 * DV flops per pair
//   are issued where the bound counts 2 * (DK + DV). In the round_p mode
//   (template flag kRoundP) only p_hi is formed and multiplied: one wgmma
//   per 16 keys, 2 * (DK + DV) flops a pair, and no p_lo registers.
// - The two consumer warpgroups take turns through two named barriers:
//   one issues acc += p_i v_i and s = q k_{i+1}^T, lets the other issue
//   its own, then waits for its products and runs tile i + 1's softmax
//   while the other's products hold the tensor cores.
// - Instances (DK, DV): (64, 64), (128, 128), (192, 128) and (256, 128),
//   the first that holds a call's head dims; smaller head dims are
//   zero-filled. A v head dim above 128 runs in 128-wide column slices of v
//   and the output, one a blockIdx.z: each slice recomputes the block's
//   float32 scores, so m and l are the same bits in every slice and the
//   output is a single pass's (2 * DK + 2 * DV flops a pair become
//   4 * DK + 2 * DV at DK = DV = 256). q and each K stage hold DK / 64
//   swizzled 64-column blocks, each V stage DV / 64, each with its own TMA
//   byte count; q.k^T takes DK / 16 k-steps and acc holds DV / 2 floats a
//   thread, so (192, 128) and (256, 128) keep (128, 128)'s registers and
//   take 168 and 209 KiB of shared memory. Accurate expf; a ragged Sq or
//   Skv is masked in the kernel.
// - What holds it back (PERF.md): at the prefill's shape the card runs at
//   its 700 W power limit with the clock lowered, and the float32 softmax
//   (accurate expf, the split, the rescale: ~25 instructions per score)
//   costs about as much energy as the products.
//
// float32 (the reduced tests only; no serving config): swa_kernel, on the
// CUDA cores: one block of 256 threads per 64-row q tile, q, K and V staged
// as float32 in shared memory (a K tile and then its V tile in one buffer),
// float32 FMAs, each thread holding a 4 x 4 block of scores and a
// 4 x DV/16 block of the accumulator; the same (DK, DV) instances and v
// slices, two blocks an SM but one at (256, 128) (145 KiB of tiles).
// cuda.h: CUtensorMap, header only (the encoder is fetched at run time)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // q rows and KV columns per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

struct Strides {
  int64_t b, h, s;  // in elements; the head dim is contiguous
};

// The visible keys of query row r are [key_lo(r), key_hi(r)]
// (kernels/swa_attention.tile_plan uses the same formulas): the causal mask
// with a bidirectional prefix of P keys sees up to max(r, P - 1), a
// non-causal call every one of its Skv keys; a window cuts below.
__device__ __forceinline__ int key_lo(int r, int window) {
  return window > 0 ? max(r - window + 1, 0) : 0;
}
__device__ __forceinline__ int key_hi(int r, int skv, int causal,
                                      int prefix) {
  return causal ? max(r, prefix - 1) : skv - 1;
}
// The reference's mask (nn/attention._attend_chunk): kpos < Skv, and
// (kpos <= qpos or kpos < P) under the causal mask, and qpos - kpos <
// window with a window.
__device__ __forceinline__ bool visible(int qpos, int kpos, int skv,
                                        int window, int causal, int prefix) {
  bool vis = kpos < skv;
  if (causal) vis = vis && (qpos >= kpos || kpos < prefix);
  if (window > 0) vis = vis && qpos - kpos < window;
  return vis;
}

// kTile rows of one head from seq position row0 into a float tile of pitch
// ld; rows past S and columns past d are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, int ld, const T* base,
                                          int64_t s_stride, int row0, int S,
                                          int d) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S && c < d) {
      x = to_float(base[static_cast<int64_t>(row) * s_stride + c]);
    }
    tile[r * ld + c] = x;
  }
}

// Two blocks an SM, but one at DK 256, whose tiles take 145 KiB.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, DK > 192 ? 1 : 2)
    swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int H, int rep,
               int sq, int skv, int dk, int dv, Strides qs, Strides ks,
               Strides vs, Strides os, int window, int causal, int prefix,
               float scale) {
  constexpr int kLdK = DK + 1;
  constexpr int kLdV = DV + 1;
  constexpr int kLdKv = kLdK > kLdV ? kLdK : kLdV;
  constexpr int kPLd = kTile + 1;
  constexpr int kCols = DV / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                // kTile x kLdK
  float* kvt = qt + kTile * kLdK;  // a K tile (pitch kLdK), then its V tile
                                   // (pitch kLdV)
  float* pt = kvt + kTile * kLdKv; // kTile x kPLd: the tile's p

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int64_t b = blockIdx.y / H;
  const int64_t h = blockIdx.y % H;
  const int64_t hk = h / rep;
  // blockIdx.z: the DV-wide column slice of v and the output
  const int vc0 = blockIdx.z * DV;
  const int dvh = min(dv - vc0, DV);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h + vc0;
  T* ob = o + b * os.b + h * os.h + vc0;

  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j; the 16
  // threads of a row are the lanes of one half-warp
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  load_tile<T, DK>(qt, kLdK, qb, qs.s, q0, sq, dk);

  // the KV tiles that intersect the mask of rows [q0, q0 + kTile)
  const int q_last = min(q0 + kTile, sq) - 1;
  const int kt_hi = key_hi(q_last, skv, causal, prefix) / kTile;
  const int kt_lo = key_lo(q0, window) / kTile;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's V and p reads are done
    load_tile<T, DK>(kvt, kLdK, kb, ks.s, k0, skv, dk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[(ty + 16 * i) * kLdK + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvt[(tx + 16 * j) * kLdK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(qpos, kpos, skv, window, causal, prefix)
                      ? s[i][j] * scale
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      // a butterfly: every lane of the half-warp ends with the same bits
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) pt[(ty + 16 * i) * kPLd + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // every K read is done and p is written
    load_tile<T, DV>(kvt, kLdV, vb, vs.s, k0, skv, dvh);
    __syncthreads();

    float pv[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[i][j] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pr[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = pt[(ty + 16 * i) * kPLd + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = kvt[kk * kLdV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) pv[i][j] = fmaf(pr[i], vv[j], pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = acc[i][j] * corr[i] + pv[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < dvh) {
        ob[static_cast<int64_t>(row) * os.s + c] = from_float<T>(acc[i][j] / den);
      }
    }
  }
}

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int sq, int skv, int dk, int dv, Strides qs, Strides ks,
           Strides vs, Strides os, int window, int causal, int prefix,
           float scale, cudaStream_t st) {
  constexpr int kLdKv = (DK > DV ? DK : DV) + 1;
  const int smem = static_cast<int>(sizeof(float)) *
                   (kTile * (DK + 1) + kTile * kLdKv + kTile * (kTile + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kTile - 1) / kTile),
                  static_cast<unsigned>(B * H),
                  static_cast<unsigned>((dv + DV - 1) / DV));
  swa_kernel<T, DK, DV><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KVH, sq, skv, dk,
      dv, qs, ks, vs, os, window, causal, prefix, scale);
  return static_cast<int>(cudaGetLastError());
}

// --- bf16 / fp16: the tensor-core kernel ------------------------------------

constexpr int kBq = 128;   // q rows per block: two consumer warpgroups of 64
constexpr int kBk = 64;    // keys per KV tile
constexpr int kStages = 3;
constexpr int kTcThreads = 384;
// one 64-column block of a tile: its rows of 128 bytes, the width of the
// 128-byte swizzle; a tile of head dim D holds D / 64 of them
constexpr int kQBlk = kBq * 128;
constexpr int kKvBlk = kBk * 128;
constexpr int kBars = 1 + 4 * kStages;   // q full; K / V full and empty
// named barriers (0 is __syncthreads's): the consumer warpgroups' turns
constexpr int kTurn0 = 1;
constexpr uint64_t kStallNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of this parity to complete. A pipeline that stalls
// for seconds (a fault, never a slow tile) traps: the launch then fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > kStallNs) __trap();
  }
}

// a box of 64 columns at (column c0, row c1, head c2, batch c3)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma matrix descriptor: a matrix in shared memory as 128-byte swizzled
// rows, 8-row groups 1024 bytes apart (SBO); lbo: the distance of the next
// 64-column block, read only for a transposed (MN-major) operand wider than
// 64. Only the low word varies: the wgmma wrappers pair it with kDescHi.
__device__ __forceinline__ uint32_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (((lbo & 0x3FFFF) >> 4) << 16);
}
// SBO = 1024 bytes in bits 32-45, the 128-byte swizzle (1) in bits 62-63
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

// the two consumer warpgroups (256 threads) take turns through these
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving register reads and writes across the
// asynchronous products that use these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// the accumulator operands of a wgmma: 32 or 64 floats
#define ACC32_REGS \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define ACC64_REGS \
  ACC32_REGS ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63"
#define ACC32_OPS(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define ACC64_OPS(d) \
  ACC32_OPS(d), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
  "+f"(d[62]), "+f"(d[63])

// What depends on T (bf16 or fp16): its tensor-map type; split2, which
// splits two neighbouring p into p_hi = T(p) and p_lo = T(p - p_hi) (exact
// in float32), each pair packed as an A fragment register (the lower key in
// the lower half), and round2, which forms p_hi alone; and the wgmma
// products: ss64 S (64 x 64) = A (64 x 16)
// B (16 x 64), both from shared memory, B K-major (acc = 0 overwrites S);
// rs128 / rs64 O (64 x 128 | 64) += A (64 x 16, registers) B (16 x 128 |
// 64, shared memory, MN-major: V as stored).
template <typename T>
struct Mma;

// The wgmma wrappers. A and B's descriptors come as their low words (the
// high word is kDescHi); P: the operand of the predicate that keeps (1) or
// overwrites (0) the accumulator; DA, DB: of the descriptors' words, A_FRAG
// of the four A fragment registers.
#define SWA_SS(N, ACC_REGS, ACC_OPS, DA, DB, P, TY)                          \
  static __device__ __forceinline__ void ss##N(float (&d)[N / 2], uint32_t a, \
                                               uint32_t b, int acc) {       \
    asm volatile("{\n.reg .pred p;\n.reg .b64 da, db;\n"                    \
                 "setp.ne.b32 p, " P ", 0;\n"                               \
                 "mov.b64 da, " DA ";\nmov.b64 db, " DB ";\n"               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " {" ACC_REGS "}, da, db, p, 1, 1, 0, 0;\n}\n"             \
                 : ACC_OPS(d)                                               \
                 : "r"(a), "r"(b), "r"(acc), "r"(kDescHi));                 \
  }
#define SWA_RS(N, ACC_REGS, ACC_OPS, A_FRAG, DB, P, TY)                      \
  static __device__ __forceinline__ void rs##N(                             \
      float (&d)[N / 2], const uint32_t* a, uint32_t b) {                   \
    asm volatile("{\n.reg .pred p;\n.reg .b64 db;\n"                        \
                 "setp.ne.b32 p, " P ", 0;\nmov.b64 db, " DB ";\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
                 " {" ACC_REGS "}, " A_FRAG ", db, p, 1, 1, 1;\n}\n"        \
                 : ACC_OPS(d)                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b),      \
                   "r"(1), "r"(kDescHi));                                   \
  }

#define SWA_MMA(CTYPE, PAIR, CVT, TY, MAP_TYPE)                               \
  template <>                                                                \
  struct Mma<CTYPE> {                                                        \
    static constexpr CUtensorMapDataType kMapType = MAP_TYPE;                \
    static __device__ __forceinline__ void split2(float x0, float x1,        \
                                                  uint32_t& hi,              \
                                                  uint32_t& lo) {            \
      const PAIR h = __floats2##CVT##2_rn(x0, x1);                           \
      const float2 hf = __##CVT##22float2(h);                                \
      const PAIR l = __floats2##CVT##2_rn(x0 - hf.x, x1 - hf.y);             \
      hi = *reinterpret_cast<const uint32_t*>(&h);                           \
      lo = *reinterpret_cast<const uint32_t*>(&l);                           \
    }                                                                        \
    static __device__ __forceinline__ uint32_t round2(float x0, float x1) {  \
      const PAIR h = __floats2##CVT##2_rn(x0, x1);                           \
      return *reinterpret_cast<const uint32_t*>(&h);                         \
    }                                                                        \
    SWA_SS(64, ACC32_REGS, ACC32_OPS, "{%32, %35}", "{%33, %35}", "%34", TY)  \
    SWA_RS(128, ACC64_REGS, ACC64_OPS, "{%64, %65, %66, %67}",              \
           "{%68, %70}", "%69", TY)                                          \
    SWA_RS(64, ACC32_REGS, ACC32_OPS, "{%32, %33, %34, %35}", "{%36, %38}",  \
           "%37", TY)                                                        \
  };

SWA_MMA(__nv_bfloat16, __nv_bfloat162, bfloat16, "bf16",
        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
SWA_MMA(__half, __half2, half, "f16", CU_TENSOR_MAP_DATA_TYPE_FLOAT16)

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t x) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"(x) : "memory");
}

// The fallback for views TMA refuses: ROWS rows from row0 (a row of the
// head at src, `stride` elements apart) into a tile at dst in the layout
// TMA writes (64-column blocks of 128-byte rows, 16-byte chunks swizzled by
// row % 8), zeros past S and d; then made visible to the tensor cores.
template <int ROWS, int D>
__device__ __forceinline__ void copy_tile(uint32_t dst, const void* src,
                                          int64_t stride, int row0, int S,
                                          int d, int lane) {
  const uint16_t* s16 = static_cast<const uint16_t*>(src);
#pragma unroll 8
  for (int e = lane; e < ROWS * D; e += 32) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    uint16_t x = 0;
    if (row < S && c < d) x = s16[static_cast<int64_t>(row) * stride + c];
    const uint32_t off = (c / 64) * (ROWS * 128) + r * 128 + (c % 64) * 2;
    st_shared_u16(dst + (off ^ (((off >> 7) & 7) << 4)), x);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One KV tile's online softmax for a thread's two rows (row_a, row_a + 8):
// scale s (keys k0 + 8 j + 2 t4 + e % 2 in s[4 j + e], row row_a + 8 (e / 2))
// and mask it unless the tile is wholly visible (full), update m and l,
// rescale acc, and split p (kRoundP: round it) into the A fragments of the
// p.v product: fragment register i over keys 16 (i / 4) ... holds s[2 i],
// s[2 i + 1]. l sums the float32 p in both modes.
template <typename T, int DV, bool kRoundP>
__device__ __forceinline__ void tile_softmax(
    float (&s)[kBk / 2], float (&acc)[DV / 2], uint32_t (&p_hi)[kBk / 4],
    uint32_t (&p_lo)[kBk / 4], float (&m)[2], float (&l)[2], bool full,
    int row_a, int k0, int t4, int skv, int window, int causal, int prefix,
    float scale) {
  if (full) {
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) s[i] *= scale;
  } else {
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row_a + 8 * (e / 2);
        const int kpos = k0 + 8 * j + 2 * t4 + e % 2;
        s[4 * j + e] = visible(qpos, kpos, skv, window, causal, prefix)
                           ? s[4 * j + e] * scale
                           : kNegInf;
      }
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row's keys lie with the 4 lanes of a quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < kBk / 2; ++i) {
    s[i] = expf(s[i] - m[(i / 2) % 2]);
    sum[(i / 2) % 2] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a butterfly: the 4 lanes end with the same bits
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i / 2) % 2];
#pragma unroll
  for (int i = 0; i < kBk / 4; ++i) {
    if constexpr (kRoundP) {
      p_hi[i] = Mma<T>::round2(s[2 * i], s[2 * i + 1]);
    } else {
      Mma<T>::split2(s[2 * i], s[2 * i + 1], p_hi[i], p_lo[i]);
    }
  }
}

template <typename T, int DK, int DV, bool kRoundP>
__global__ void __launch_bounds__(kTcThreads, 1)
    swa_kernel_tc(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int rep,
                  int sq, int skv, int dk, int dv, Strides qs, Strides ks,
                  Strides vs, Strides os, int window, int causal, int prefix,
                  float scale, int use_tma) {
  // 64-column blocks of a q or K tile (head dim DK) and of a V tile (DV)
  constexpr int kNbK = DK / 64;
  constexpr int kNbV = DV / 64;
  constexpr int kQTile = kNbK * kQBlk;
  constexpr int kKTile = kNbK * kKvBlk;
  constexpr int kVTile = kNbV * kKvBlk;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + kQTile;                 // + stage * kKTile
  const uint32_t v_s = k_s + kStages * kKTile;       // + stage * kVTile
  const uint32_t bar = v_s + kStages * kVTile;       // kBars x 8 bytes
  const uint32_t q_full = bar;
  const uint32_t k_full = bar + 8;                   // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / rep;
  // blockIdx.z: the DV-wide column slice of v and the output (a v head
  // dim of 256 in the DV = 128 instances: each slice recomputes the same
  // float32 scores, so m and l, and every output bit, are a single pass's)
  const int vc0 = blockIdx.z * DV;
  const int dvh = min(dv - vc0, DV);
  // the block's KV tiles: tile_plan(sq, window, causal, kBq, kBk, prefix,
  // skv)
  const int kt_lo = key_lo(q0, window) / kBk;
  const int kt_hi = key_hi(min(q0 + kBq, sq) - 1, skv, causal, prefix) / kBk;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    const uint32_t loaders = use_tma ? 1 : 32;
    mbar_init(q_full, loaders);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, loaders);
      mbar_init(v_full + 8 * st, loaders);
      mbar_init(k_empty + 8 * st, 8);   // each consumer warp arrives
      mbar_init(v_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    // --- the loader: warp 8 fills the ring; warps 9-11 leave ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x / 32 != 8) return;
    if (use_tma) {
      if (lane != 0) return;
      mbar_expect_tx(q_full, kQTile);
      for (int c = 0; c < kNbK; ++c) {
        tma_load(q_s + c * kQBlk, &qmap, q_full, 64 * c, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kBk;
        mbar_wait(k_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(k_full + 8 * st, kKTile);
        for (int c = 0; c < kNbK; ++c) {
          tma_load(k_s + st * kKTile + c * kKvBlk, &kmap, k_full + 8 * st,
                   64 * c, k0, hk, b);
        }
        mbar_wait(v_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(v_full + 8 * st, kVTile);
        for (int c = 0; c < kNbV; ++c) {
          tma_load(v_s + st * kVTile + c * kKvBlk, &vmap, v_full + 8 * st,
                   vc0 + 64 * c, k0, hk, b);
        }
      }
    } else {
      const T* qb = q + b * qs.b + h * qs.h;
      const T* kb = k + b * ks.b + hk * ks.h;
      const T* vb = v + b * vs.b + hk * vs.h + vc0;
      copy_tile<kBq, DK>(q_s, qb, qs.s, q0, sq, dk, lane);
      mbar_arrive(q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kBk;
        mbar_wait(k_empty + 8 * st, ph ^ 1);
        copy_tile<kBk, DK>(k_s + st * kKTile, kb, ks.s, k0, skv, dk, lane);
        mbar_arrive(k_full + 8 * st);
        mbar_wait(v_empty + 8 * st, ph ^ 1);
        copy_tile<kBk, DV>(v_s + st * kVTile, vb, vs.s, k0, skv, dvh, lane);
        mbar_arrive(v_full + 8 * st);
      }
    }
    return;
  }

  // --- the consumers: warpgroup wg owns q rows [r0, r0 + 64) --------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t4 = lane % 4;
  // this thread's accumulator rows: row_a and row_a + 8
  const int row_a = q0 + wg * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
  const int r0 = q0 + wg * 64;
  const int r1 = min(r0 + 63, sq - 1);
  // Both warpgroups compute every tile of the block (no condition around a
  // wgmma, or ptxas serializes them); a warpgroup masks a tile unless it
  // is whole and visible from all its rows, tile_plan(sq, window, causal,
  // 64, kBk, prefix, skv): k0 >= full_lo, k0 + kBk - 1 <= full_hi,
  // k0 + kBk <= skv. A
  // tile that none of its rows sees is then masked whole, which changes no
  // output bit (see the note at the top).
  const int full_lo = key_lo(r1, window);
  const int full_hi = key_hi(r0, skv, causal, prefix);

  float s[kBk / 2];
  float acc[DV / 2];
  uint32_t p_hi[kBk / 4], p_lo[kBk / 4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBk / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBk / 4; ++i) p_hi[i] = 0u;
  if constexpr (!kRoundP) {
#pragma unroll
    for (int i = 0; i < kBk / 4; ++i) p_lo[i] = 0u;
  }

  const uint32_t q_wg = q_s + wg * 64 * 128;   // its rows in each block
  // s = q k^T over the K tile at k_st (issued, not waited for): DK / 16
  // k-steps, four a 64-column block
  auto issue_qk = [&](uint32_t k_st) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      Mma<T>::ss64(s, sw128_desc(q_wg + (kk / 4) * kQBlk + off, 0),
                   sw128_desc(k_st + (kk / 4) * kKvBlk + off, 0), kk > 0);
    }
  };
  // acc += p_hi v + p_lo v (kRoundP: p_hi v) over the V tile at v_st:
  // keys 16 kk ... 16 kk + 15 are two 8-row groups, 2048 bytes a step
  auto issue_pv = [&](uint32_t v_st) {
#pragma unroll
    for (int t = 0; t < (kRoundP ? 1 : 2); ++t) {
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        const uint32_t vd = sw128_desc(v_st + kk * 2048, kKvBlk);
        const uint32_t* a = t == 0 ? &p_hi[4 * kk] : &p_lo[4 * kk];
        if constexpr (DV == 128) {
          Mma<T>::rs128(acc, a, vd);
        } else {
          Mma<T>::rs64(acc, a, vd);
        }
      }
    }
  };
  auto softmax = [&](int kt) {
    const int k0 = kt * kBk;
    tile_softmax<T, DV, kRoundP>(s, acc, p_hi, p_lo, m, l,
                       k0 >= full_lo && k0 + kBk - 1 <= full_hi &&
                           k0 + kBk <= skv,
                       row_a, k0, t4, skv, window, causal, prefix, scale);
  };

  mbar_wait(q_full, 0);
  // the first tile's scores
  mbar_wait(k_full, 0);
  fence_regs(s);
  wg_fence();
  issue_qk(k_s);
  wg_commit();
  wg_wait_all();
  fence_regs(s);
  __syncwarp();
  if (lane == 0) mbar_arrive(k_empty);
  softmax(kt_lo);
  // Then per tile i: the products of the two warpgroups take turns (warp-
  // group 0 first): one issues acc += p_i v_i and s = q k_{i+1}^T, lets the
  // other issue its own, then waits for its products; its softmax of tile
  // i + 1 runs while the other's products hold the tensor cores.
  if (wg == 1) named_arrive(kTurn0);
#pragma unroll 1
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int st = i % kStages;
    const int st_n = (i + 1) % kStages;
    mbar_wait(v_full + 8 * st, (i / kStages) & 1);
    mbar_wait(k_full + 8 * st_n, ((i + 1) / kStages) & 1);
    named_sync(kTurn0 + wg);
    fence_regs(acc);
    fence_regs(s);
    fence_regs(p_hi);
    if constexpr (!kRoundP) fence_regs(p_lo);
    wg_fence();
    issue_pv(v_s + st * kVTile);
    issue_qk(k_s + st_n * kKTile);
    wg_commit();
    named_arrive(kTurn0 + 1 - wg);
    wg_wait_all();
    fence_regs(acc);
    fence_regs(s);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(v_empty + 8 * st);
      mbar_arrive(k_empty + 8 * st_n);
    }
    softmax(kt_lo + i + 1);
  }
  // the last tile's p.v; warpgroup 1's last turn has no successor
  {
    const int i = n_tiles - 1;
    const int st = i % kStages;
    mbar_wait(v_full + 8 * st, (i / kStages) & 1);
    named_sync(kTurn0 + wg);
    fence_regs(acc);
    fence_regs(p_hi);
    if constexpr (!kRoundP) fence_regs(p_lo);
    wg_fence();
    issue_pv(v_s + st * kVTile);
    wg_commit();
    if (wg == 0) named_arrive(kTurn0 + 1);
    wg_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty + 8 * st);
  }

  // acc[4 j + e]: row row_a + 8 * (e / 2), column 8 j + 2 t4 + e % 2
  T* ob = o + b * os.b + h * os.h + vc0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        if (c < dvh) {
          ob[static_cast<int64_t>(row) * os.s + c] =
              from_float<T>(acc[4 * j + 2 * r + e] / den);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the shared
// nvcc flags link no libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// TMA's rules for a (B, heads, S, d) view of 2-byte elements: a 16-byte
// aligned base, positive strides that are multiples of 16 bytes (a dim of
// extent 1 is never stepped, so its stride does not matter)
bool tma_view(const void* p, int B, int heads, Strides st) {
  auto ok = [](int64_t e) {
    return e > 0 && (e * 2) % 16 == 0 && e * 2 < (int64_t{1} << 40);
  };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ok(st.s) &&
         (heads == 1 || ok(st.h)) && (B == 1 || ok(st.b));
}

// A 4-d map (d, S, heads, B) with boxes of 64 columns x `rows` rows,
// swizzled by 128 bytes, zeros outside the view. Returns a CUDA error code.
int encode_view(CUtensorMap* map, CUtensorMapDataType ty, const void* p,
                int d, int S, int heads, int B, Strides st, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int64_t sh = heads > 1 ? st.h : st.s * S;
  const int64_t sb = B > 1 ? st.b : sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s * 2),
                                 static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, ty, 4, const_cast<void*>(p), dims, strides, box,
                         unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DK, int DV, bool kRoundP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int KVH, int sq, int skv, int dk, int dv, Strides qs,
              Strides ks, Strides vs, Strides os, int window, int causal,
              int prefix, float scale, cudaStream_t st) {
  // the q tile, kStages K and kStages V tiles, the mbarriers, 1024 bytes
  // to align: at (192, 128) 48 + 72 + 48 KiB, at (256, 128) 64 + 96 + 48
  const int smem = DK / 64 * (kQBlk + kStages * kKvBlk) +
                   DV / 64 * kStages * kKvBlk + 8 * kBars + 1024;
  const CUtensorMapDataType ty = Mma<T>::kMapType;
  CUtensorMap maps[3] = {};
  const int use_tma = tma_view(q, B, H, qs) && tma_view(k, B, KVH, ks) &&
                      tma_view(v, B, KVH, vs);
  if (use_tma) {
    int err = encode_view(&maps[0], ty, q, dk, sq, H, B, qs, kBq);
    if (!err) err = encode_view(&maps[1], ty, k, dk, skv, KVH, B, ks, kBk);
    if (!err) err = encode_view(&maps[2], ty, v, dv, skv, KVH, B, vs, kBk);
    if (err) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel_tc<T, DK, DV, kRoundP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + kBq - 1) / kBq),
                  static_cast<unsigned>(B * H),
                  static_cast<unsigned>((dv + DV - 1) / DV));
  swa_kernel_tc<T, DK, DV, kRoundP><<<grid, kTcThreads, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      H, H / KVH, sq, skv, dk, dv, qs, ks, vs, os, window, causal, prefix,
      scale, use_tma);
  return static_cast<int>(cudaGetLastError());
}

// The instance for head dims (dk, dv): (64, 64), (128, 128), (192, 128) or
// (256, 128), the first whose DK holds dk and whose DV holds dv or, in the
// DV = 128 instances, a 128-wide slice of it (blockIdx.z picks the slice:
// v heads up to 256); a smaller head dim is zero-filled. The wrapper
// refuses dk > 256 and dv > 256.
enum class Dims { k64, k128, k192, k256 };

inline Dims pick_dims(int dk, int dv) {
  if (dk <= 64 && dv <= 64) return Dims::k64;
  if (dk <= 128) return Dims::k128;
  if (dk <= 192) return Dims::k192;
  return Dims::k256;
}

// The arguments every launcher passes on as they are.
#define SWA_ARGS                                                        \
  q, k, v, o, B, H, KVH, sq, skv, dk, dv, qs, ks, vs, os, window, causal, \
      prefix, scale, st
#define SWA_PARAMS                                                         \
  const void *q, const void *k, const void *v, void *o, int B, int H,      \
      int KVH, int sq, int skv, int dk, int dv, Strides qs, Strides ks,    \
      Strides vs, Strides os, int window, int causal, int prefix,          \
      float scale, cudaStream_t st

template <typename T>
int launch_d(SWA_PARAMS) {
  switch (pick_dims(dk, dv)) {
    case Dims::k64:
      return launch<T, 64, 64>(SWA_ARGS);
    case Dims::k128:
      return launch<T, 128, 128>(SWA_ARGS);
    case Dims::k192:
      return launch<T, 192, 128>(SWA_ARGS);
    default:
      return launch<T, 256, 128>(SWA_ARGS);
  }
}

template <typename T, bool kRoundP>
int launch_tc_d(SWA_PARAMS) {
  switch (pick_dims(dk, dv)) {
    case Dims::k64:
      return launch_tc<T, 64, 64, kRoundP>(SWA_ARGS);
    case Dims::k128:
      return launch_tc<T, 128, 128, kRoundP>(SWA_ARGS);
    case Dims::k192:
      return launch_tc<T, 192, 128, kRoundP>(SWA_ARGS);
    default:
      return launch_tc<T, 256, 128, kRoundP>(SWA_ARGS);
  }
}

template <typename T>
int launch_tc_p(SWA_PARAMS, int round_p) {
  if (round_p) return launch_tc_d<T, true>(SWA_ARGS);
  return launch_tc_d<T, false>(SWA_ARGS);
}

}  // namespace

// o = softmax(mask(q k^T * scale)) v per (batch, head); q (B, H, sq, dk),
// k (B, KVH, skv, dk), v (B, KVH, skv, dv), o (B, H, sq, dv), H a multiple
// of KVH, 0 < dk <= 256, 0 < dv <= 256, every tensor with a contiguous head
// dim and the given (batch, head, seq) element strides; sq != skv only for
// a non-causal call without a window.
// dtype: 0 float32, 1 bfloat16, 2 float16 (all four tensors alike).
// window <= 0: no sliding window. prefix: the causal mask's bidirectional
// prefix, keys [0, prefix) visible from every row (0 <= prefix <= skv).
// round_p: round p to the input's type before p @ v (bf16 / fp16; float32
// ignores it). Returns the CUDA error of the launch.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int B, int H, int KVH,
                                 int sq, int skv, int dk, int dv, int64_t qsb,
                                 int64_t qsh, int64_t qss, int64_t ksb,
                                 int64_t ksh, int64_t kss, int64_t vsb,
                                 int64_t vsh, int64_t vss, int64_t osb,
                                 int64_t osh, int64_t oss, int window,
                                 int causal, int prefix, float scale,
                                 int round_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (dk <= 0 || dv <= 0 || dk > 256 || dv > 256 || skv <= 0 ||
      prefix < 0 || prefix > skv ||
      (sq != skv && (causal || window > 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return launch_d<float>(SWA_ARGS);
    case 1:
      return launch_tc_p<__nv_bfloat16>(SWA_ARGS, round_p);
    case 2:
      return launch_tc_p<__half>(SWA_ARGS, round_p);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
