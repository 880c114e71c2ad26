// Causal, optionally sliding-window, flash attention for sm_90a.
//
// Replaces: src/repro/kernels/swa_attention.py, _swa_kernel / swa_attention,
// the TPU kernel behind the long_500k serving shape. On the card it runs in
// every attention layer of models/decoder_lm.forward (prefill), through
// nn/attention.flash_attention and kernels/ops.swa_attention.
//
// Bound on this card: operations. Each (q, k) pair that the mask lets
// through costs 4 * D flops (q.k and p.v); at B = 1, H = 32, D = 128,
// S = 32768 the causal pairs (536.9 M per head) need 8.8 TFLOP, 8.9 ms at
// the 989 TFLOP/s of the bf16 tensor cores, and a window of 8192 (234.9 M
// pairs per head) 3.9 ms. The bytes (q and o with 32 heads, k and v with
// 8 kv heads, each read or written once: 0.67 GB in bf16) take 0.2 ms.
//
// Design (a first kernel, right and simple; speed is later work):
// - one CUDA block of 256 threads per (batch * head, 64-row q tile), the
//   tiles with the most KV work (the last, under a causal mask) launched
//   first;
// - the block loops over only the 64-wide KV tiles that intersect the
//   mask of its q tile, in ascending order. The loop takes the place of
//   the TPU grid's sequential KV axis, and the tiles outside the window
//   are never read: a structural skip, not a mask;
// - q head h reads kv head h / (H / KVH) in place (GQA without a repeat),
//   and every tensor is addressed through its (batch, head, seq) strides,
//   so the model's (B, S, H, D) layout needs no transposed copy;
// - the q tile, then each K tile and V tile, are staged in shared memory
//   as float32 (rows padded by one float, so column reads hit 16 banks);
//   scores, the online softmax and the PV product are float32 FMAs on
//   the CUDA cores, each thread holding a 4 x 4 block of scores and a
//   4 x D/16 block of the accumulator (no tensor cores yet);
// - the reference's arithmetic: s = (q.k) * scale, masked to
//   NEG_INF = -1e30; m_new = max(m, rowmax(s)); p = exp(s - m_new);
//   corr = exp(m - m_new); l = l * corr + sum(p); acc = acc * corr + p @ v;
//   out = acc / max(l, 1e-30), written in q's type. p stays float32 (the
//   TPU kernel does not cast it either). A row whose first tile is wholly
//   masked adds exp(0) rubbish that the next live score wipes out
//   (corr = exp(-1e30 - m) = 0), as in the reference;
// - a ragged S is masked in the kernel (rows and keys past S); D <= 128.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // q rows and KV columns per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int H, int rep,
               int S, int d, Strides qs, Strides ks, Strides vs, Strides os,
               int window, int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kPLd = kTile + 1;
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qt = smem;               // kTile x kLd
  float* kvt = qt + kTile * kLd;  // kTile x kLd: a K tile, then its V tile
  float* pt = kvt + kTile * kLd;  // kTile x kPLd: the tile's p

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int64_t b = blockIdx.y / H;
  const int64_t h = blockIdx.y % H;
  const int64_t hk = h / rep;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

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

  load_tile<T, D>(qt, kLd, qb, qs.s, q0, S, d);

  // the KV tiles that intersect the mask of rows [q0, q0 + kTile)
  const int q_last = min(q0 + kTile, S) - 1;
  const int kt_hi = (causal ? q_last : S - 1) / kTile;
  const int kt_lo = (window > 0 ? max(q0 - window + 1, 0) : 0) / kTile;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's V and p reads are done
    load_tile<T, D>(kvt, kLd, kb, ks.s, k0, S, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[(ty + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvt[(tx + 16 * j) * kLd + c];
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
        bool live = kpos < S;
        if (causal) live = live && qpos >= kpos;
        if (window > 0) live = live && qpos - kpos < window;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
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
    load_tile<T, D>(kvt, kLd, vb, vs.s, k0, S, d);
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
      for (int j = 0; j < kCols; ++j) vv[j] = kvt[kk * kLd + tx + 16 * j];
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
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        ob[static_cast<int64_t>(row) * os.s + c] = from_float<T>(acc[i][j] / den);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int S, int d, Strides qs, Strides ks, Strides vs,
           Strides os, int window, int causal, float scale, cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * kTile * (D + 1) + kTile * (kTile + 1));
  cudaError_t err = cudaFuncSetAttribute(
      swa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((S + kTile - 1) / kTile),
                  static_cast<unsigned>(B * H));
  swa_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KVH, S, d, qs, ks,
      vs, os, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KVH, int S, int d, Strides qs, Strides ks, Strides vs,
             Strides os, int window, int causal, float scale,
             cudaStream_t st) {
  if (d <= 64) {
    return launch<T, 64>(q, k, v, o, B, H, KVH, S, d, qs, ks, vs, os, window,
                         causal, scale, st);
  }
  return launch<T, 128>(q, k, v, o, B, H, KVH, S, d, qs, ks, vs, os, window,
                        causal, scale, st);
}

}  // namespace

// o = softmax(mask(q k^T * scale)) v per (batch, head); q, o (B, H, S, d),
// k, v (B, KVH, S, d), H a multiple of KVH, 0 < d <= 128, every tensor with
// a contiguous head dim and the given (batch, head, seq) element strides.
// dtype: 0 float32, 1 bfloat16, 2 float16 (all four tensors alike).
// window <= 0: no sliding window. Returns the CUDA error of the launch.
extern "C" int swa_attention_fwd(const void* q, const void* k, const void* v,
                                 void* o, int dtype, int B, int H, int KVH,
                                 int S, int d, int64_t qsb, int64_t qsh,
                                 int64_t qss, int64_t ksb, int64_t ksh,
                                 int64_t kss, int64_t vsb, int64_t vsh,
                                 int64_t vss, int64_t osb, int64_t osh,
                                 int64_t oss, int window, int causal,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, B, H, KVH, S, d, qs, ks, vs, os,
                             window, causal, scale, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, H, KVH, S, d, qs, ks, vs,
                                     os, window, causal, scale, st);
    case 2:
      return launch_d<__half>(q, k, v, o, B, H, KVH, S, d, qs, ks, vs, os,
                              window, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
