// Single-block attention for Hopper (sm_90a), f32 and bf16, f32 sums: a
// forward kernel and its recompute backward, one launch each.
//
// Replaces the TPU kernels `_attention_kernel` and `_attention_bwd_kernel`
// in tinydiffusionmodels_tpu/ops/pallas_kernels.py (custom VJP
// `_attention_diffable`). Both take q, k, v of one (batch, head) whole, with
// no mask and no dropout, and compute, with s = (q k^T) * scale in f32 and
// p = exp(s - rowmax) / rowsum(exp(s - rowmax)):
//
//   forward    O  = round(p) V, in q's dtype
//   backward   O  = round(p) V in f32 (recomputed; not the stored output)
//              D  = rowsum(dO * O)
//              ds = p (dO V^T - D)
//              dq = round(ds) K scale, dk = round(ds)^T Q scale,
//              dv = round(p)^T dO, each in q's dtype
//
// where round() is a round trip through the operand dtype (a no-op in f32,
// bf16 round-to-nearest-even in bf16), at the points where the TPU kernels
// cast with astype. No logsumexp is written or read: the backward's
// residuals are q, k and v alone, as on the TPU. This is why the pair is not
// the one-tile case of the flash kernels, whose backward reads the forward's
// lse and forms D from the stored output.
//
// Design. The TPU kernels hold a whole (b, h) in VMEM, scores included. Here
// the forward runs one CTA of 128 threads per (batch*head, 16 query rows),
// so the text sampler's shape (B 8, H 4, L 64) gives 128 CTAs; each stages
// the whole of K and V of its (b, h) and its 16 rows of Q in shared memory
// as float, forms the 16 x L scores there, one warp per row takes the
// softmax in one pass (a single KV tile: no online rescaling), and the
// threads form O. The backward runs one CTA of 256 threads per
// (batch*head), because dk and dv sum over every query row: it keeps K, V
// and the f32 dk and dv sums in shared memory and walks the queries in
// chunks of 16 rows, recomputing s, p, O and D for each chunk and adding the
// chunk's dsT Q and pT dO to the sums; it needs no atomics and no second
// pass. K and V rows are padded by one word, so the threads of a warp, which
// read neighbouring key rows at one column, hit distinct banks. Operands and
// results are addressed through element strides over (batch, head, row);
// the last dim is contiguous.
//
// Domain. The shared memory a CTA can have (227 KB, above 48 KB only after
// cudaFuncSetAttribute) bounds it: L from 1 to 128 and Dh in {32, 64, 128}
// for the forward; the backward holds four L x Dh float arrays, so it takes
// L up to 128 at Dh 32 and 64 and up to 96 at Dh 128 (221 KB). A shape
// outside is refused here with cudaErrorInvalidValue, and the wrapper
// (ops/single_block.py) raises before it launches.
//
// What bounds it. At the sampler shape in f32 the forward moves 2 MB and
// does 34 MFLOP, so the card's bound is bytes (0.6 us at 3.35 TB/s); the
// backward's function needs five L x L x Dh products (s, dp, dq, dk, dv:
// 84 MFLOP), bound by operations (1.25 us at 67 TFLOP/s FP32). This kernel
// does a sixth, the recomputed O, which D does not need: since
// O = round(p) V, D = rowsum(round(p) * dp) exactly, from the dp it already
// holds. Both kernels are plain FP32 FMA with two shared-memory loads per
// FMA and no tensor cores, so they sit far above those bounds. Known limits
// for the redesign: the O recompute; the backward grid is B*H CTAs (32 on
// 132 SMs at the sampler shape), each a serial walk of L / 16 chunks;
// splitting the key rows across CTAs, and mma.sync or wgmma for the
// products, are later work.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

using flash::kFullMask;
using flash::load_f32;
using flash::store_f32;

constexpr int kMaxLen = 128;
constexpr int kMaxLenBwdDh128 = 96;
constexpr int kRows = 16;  // query rows per forward CTA and backward chunk
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kWarp = 32;

// Order of the (batch, head, row) stride triples passed from the host.
enum Operand { kQ, kK, kV, kDO, kDQ, kDK, kDV, kOperands };
constexpr int kO = kDO;  // the forward's output takes the fourth triple

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // backward only
  void* out;         // forward: O; backward: dq
  void* dk;          // backward only
  void* dv;          // backward only
  int64_t sb[kOperands], sh[kOperands], sl[kOperands];
  int heads, len;
  float scale;
};

// x rounded to T and widened back to float.
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

template <typename T>
__device__ __forceinline__ const T* at(const Params& p, const void* base,
                                       int op, int b, int h) {
  return static_cast<const T*>(base) + b * p.sb[op] + h * p.sh[op];
}

template <typename T>
__device__ __forceinline__ T* at_mut(const Params& p, void* base, int op,
                                     int b, int h) {
  return static_cast<T*>(base) + b * p.sb[op] + h * p.sh[op];
}

// Rows [0, rows) of a (row, Dh) operand into shared memory as float, with
// row stride `stride`.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int64_t src_stride, int rows,
                                      int threads) {
  for (int e = threadIdx.x; e < rows * DH; e += threads) {
    const int r = e / DH, c = e % DH;
    dst[r * stride + c] = load_f32(src + r * src_stride + c);
  }
}

// Each row of the rows x len matrix `s` replaced by its softmax, one warp
// per row: exp(s - max) / sum, in f32.
__device__ __forceinline__ void softmax_rows(float* s, int rows, int len,
                                             int warps) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int i = warp; i < rows; i += warps) {
    float* row = s + i * len;
    float m = -FLT_MAX;
    for (int j = lane; j < len; j += kWarp) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < len; j += kWarp) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < len; j += kWarp) row[j] = row[j] / sum;
  }
}

template <int DH>
size_t fwd_smem_floats(int len) {
  return size_t(len) * (DH + 1) + size_t(len) * DH + size_t(kRows) * DH +
         size_t(kRows) * len;
}

template <int DH>
size_t bwd_smem_floats(int len) {
  return 2 * size_t(len) * (DH + 1) + 2 * size_t(len) * DH +
         2 * size_t(kRows) * DH + 2 * size_t(kRows) * len + kRows;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kFwdThreads)
    single_block_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int kKStride = DH + 1;
  const int len = p.len;
  float* sk = smem;                // len x (DH + 1)
  float* sv = sk + len * kKStride;  // len x DH
  float* sq = sv + len * DH;        // kRows x DH
  float* ss = sq + kRows * DH;      // kRows x len: scores, then p

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * kRows;
  const int rows = min(kRows, len - q0);
  stage<T, DH>(sk, kKStride, at<T>(p, p.k, kK, b, h), p.sl[kK], len,
               kFwdThreads);
  stage<T, DH>(sv, DH, at<T>(p, p.v, kV, b, h), p.sl[kV], len, kFwdThreads);
  stage<T, DH>(sq, DH, at<T>(p, p.q, kQ, b, h) + q0 * p.sl[kQ], p.sl[kQ],
               rows, kFwdThreads);
  __syncthreads();

  for (int e = threadIdx.x; e < rows * len; e += kFwdThreads) {
    const int i = e / len, j = e % len;
    const float* qi = sq + i * DH;
    const float* kj = sk + j * kKStride;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) s = fmaf(qi[d], kj[d], s);
    ss[e] = s * p.scale;
  }
  __syncthreads();
  softmax_rows(ss, rows, len, kFwdThreads / kWarp);
  __syncthreads();

  T* o = at_mut<T>(p, p.out, kO, b, h) + q0 * p.sl[kO];
  for (int e = threadIdx.x; e < rows * DH; e += kFwdThreads) {
    const int i = e / DH, c = e % DH;
    const float* pi = ss + i * len;
    float acc = 0.f;
    for (int j = 0; j < len; ++j) {
      acc = fmaf(round_as<T>(pi[j]), sv[j * DH + c], acc);
    }
    store_f32(o + i * p.sl[kO] + c, acc);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
    single_block_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int kStride = DH + 1;
  const int len = p.len;
  float* sk = smem;                // len x (DH + 1)
  float* sv = sk + len * kStride;   // len x (DH + 1)
  float* sdk = sv + len * kStride;  // len x DH: sum of ds^T Q
  float* sdv = sdk + len * DH;      // len x DH: sum of p^T dO
  float* sq = sdv + len * DH;       // kRows x DH
  float* sdo = sq + kRows * DH;     // kRows x DH
  float* sp = sdo + kRows * DH;     // kRows x len: s, then p, then round(p)
  float* sds = sp + kRows * len;    // kRows x len: dp, then round(ds)
  float* sd = sds + kRows * len;    // kRows: D

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const T* q = at<T>(p, p.q, kQ, b, h);
  const T* dout = at<T>(p, p.dout, kDO, b, h);
  T* dq = at_mut<T>(p, p.out, kDQ, b, h);
  stage<T, DH>(sk, kStride, at<T>(p, p.k, kK, b, h), p.sl[kK], len,
               kBwdThreads);
  stage<T, DH>(sv, kStride, at<T>(p, p.v, kV, b, h), p.sl[kV], len,
               kBwdThreads);
  for (int e = threadIdx.x; e < len * DH; e += kBwdThreads) {
    sdk[e] = 0.f;
    sdv[e] = 0.f;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  constexpr int kWarps = kBwdThreads / kWarp;

  for (int q0 = 0; q0 < len; q0 += kRows) {
    const int rows = min(kRows, len - q0);
    __syncthreads();  // the previous chunk is consumed
    stage<T, DH>(sq, DH, q + q0 * p.sl[kQ], p.sl[kQ], rows, kBwdThreads);
    stage<T, DH>(sdo, DH, dout + q0 * p.sl[kDO], p.sl[kDO], rows,
                 kBwdThreads);
    __syncthreads();

    // s = Q K^T scale and dp = dO V^T, one (row, key) pair per step.
    for (int e = threadIdx.x; e < rows * len; e += kBwdThreads) {
      const int i = e / len, j = e % len;
      const float* qi = sq + i * DH;
      const float* doi = sdo + i * DH;
      const float* kj = sk + j * kStride;
      const float* vj = sv + j * kStride;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qi[d], kj[d], s);
        dp = fmaf(doi[d], vj[d], dp);
      }
      sp[e] = s * p.scale;
      sds[e] = dp;
    }
    __syncthreads();
    softmax_rows(sp, rows, len, kWarps);
    __syncthreads();

    // D = rowsum(dO * O) with O = round(p) V in f32, one warp per row.
    for (int i = warp; i < rows; i += kWarps) {
      const float* pi = sp + i * len;
      float d = 0.f;
      for (int c = lane; c < DH; c += kWarp) {
        float o = 0.f;
        for (int j = 0; j < len; ++j) {
          o = fmaf(round_as<T>(pi[j]), sv[j * kStride + c], o);
        }
        d = fmaf(sdo[i * DH + c], o, d);
      }
      d = warp_sum(d);
      if (lane == 0) sd[i] = d;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < rows * len; e += kBwdThreads) {
      const float pe = sp[e];
      sds[e] = round_as<T>(pe * (sds[e] - sd[e / len]));
      sp[e] = round_as<T>(pe);
    }
    __syncthreads();

    // dq of the chunk's rows: round(ds) K scale.
    for (int e = threadIdx.x; e < rows * DH; e += kBwdThreads) {
      const int i = e / DH, c = e % DH;
      const float* dsi = sds + i * len;
      float acc = 0.f;
      for (int j = 0; j < len; ++j) {
        acc = fmaf(dsi[j], sk[j * kStride + c], acc);
      }
      store_f32(dq + (q0 + i) * p.sl[kDQ] + c, acc * p.scale);
    }
    // The chunk's share of dk and dv: round(ds)^T Q and round(p)^T dO.
    for (int e = threadIdx.x; e < len * DH; e += kBwdThreads) {
      const int j = e / DH, c = e % DH;
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < rows; ++i) {
        ak = fmaf(sds[i * len + j], sq[i * DH + c], ak);
        av = fmaf(sp[i * len + j], sdo[i * DH + c], av);
      }
      sdk[e] += ak;
      sdv[e] += av;
    }
  }
  __syncthreads();

  T* dk = at_mut<T>(p, p.dk, kDK, b, h);
  T* dv = at_mut<T>(p, p.dv, kDV, b, h);
  for (int e = threadIdx.x; e < len * DH; e += kBwdThreads) {
    const int j = e / DH, c = e % DH;
    store_f32(dk + j * p.sl[kDK] + c, sdk[e] * p.scale);
    store_f32(dv + j * p.sl[kDV] + c, sdv[e]);
  }
}

template <typename T, int DH, bool kBackward>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBackward ? bwd_smem_floats<DH>(p.len)
                                                 : fwd_smem_floats<DH>(p.len));
  auto kernel = kBackward ? single_block_bwd_kernel<T, DH>
                          : single_block_fwd_kernel<T, DH>;
  // Above 48 KB only after this attribute; a refusal (above the device's
  // limit) is returned, never worked around.
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const unsigned bh = unsigned(batch) * unsigned(p.heads);
  const dim3 grid =
      kBackward ? dim3(bh) : dim3(bh, (p.len + kRows - 1) / kRows);
  kernel<<<grid, kBackward ? kBwdThreads : kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBackward, typename T>
cudaError_t launch_dh(const Params& p, int batch, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32, kBackward>(p, batch, s);
    case 64: return launch<T, 64, kBackward>(p, batch, s);
    case 128: return launch<T, 128, kBackward>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBackward>
int run(Params& p, int dtype, int batch, int heads, int len, int dh,
        const long long* strides, float scale, void* stream) {
  const int max_len = kBackward && dh == 128 ? kMaxLenBwdDh128 : kMaxLen;
  if (batch <= 0 || heads <= 0 || len <= 0 || len > max_len ||
      (long long)batch * heads > 0x7fffffffLL) {
    return int(cudaErrorInvalidValue);
  }
  const int operands = kBackward ? kOperands : kO + 1;
  for (int o = 0; o < operands; ++o) {
    p.sb[o] = strides[3 * o];
    p.sh[o] = strides[3 * o + 1];
    p.sl[o] = strides[3 * o + 2];
  }
  p.heads = heads;
  p.len = len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_dh<kBackward, float>(p, batch, dh, s));
    case 1: return int(launch_dh<kBackward, __nv_bfloat16>(p, batch, dh, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v and out are (batch, heads, len, dh) arrays addressed through
// `strides`: 12 element strides, (batch, head, row) for q, k, v and out in
// that order. dtype: 0 = float32, 1 = bfloat16; `scale` is 1/sqrt(dh).
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream` and allocates nothing.
extern "C" int tdm_attention_single_block_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int len, int dh, const long long* strides,
    float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  return run<false>(p, dtype, batch, heads, len, dh, strides, scale, stream);
}

// As the forward, with the output's cotangent dout in and dq, dk, dv out;
// `strides` holds 21 element strides, (batch, head, row) for q, k, v, dout,
// dq, dk and dv in that order.
extern "C" int tdm_attention_single_block_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int dtype, int batch, int heads, int len, int dh,
    const long long* strides, float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  return run<true>(p, dtype, batch, heads, len, dh, strides, scale, stream);
}
