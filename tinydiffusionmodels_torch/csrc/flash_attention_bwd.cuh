// Flash-attention recompute backward for Hopper (sm_90a), f32 and bf16,
// f32 accumulation: two kernels, dq and dk/dv. Each has its own source that
// instantiates it (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu),
// so the two compile in parallel.
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (host side
// `_flash_bwd_impl`). Both recompute the forward's scores s = (q * scale) k^T
// from q and k, exactly as flash_attention_fwd.cu forms them, and the
// normalized weights p = exp(s - lse) from the forward's saved logsumexp, so
// no (L, L) matrix is stored between the passes. With dO the output's
// gradient and D = rowsum(dO * O) - g_lse (computed by the caller; g_lse is
// the lse's own gradient, zero when only O is used):
//
//   dp = dO V^T, times the dropout factor where dropout is on
//   ds = p (dp - D), zero where the causal or ragged-edge predicate masks
//   dq = ds K scale           (dq kernel)
//   dv = (mask p)^T dO        (dkv kernel)
//   dk = ds^T Q scale         (dkv kernel)
//
// D already holds the dropout mask through O, so only dp takes the factor.
// The mask is regenerated from coordinates by dropout_hash.cuh, identical to
// the forward's. A query row that sees no key (causal, q_off + i < k_off) has
// the forward's uniform weights 1/Lk over the Lk keys, so it gets
// dv = mask / Lk * dO and no ds, which is what autograd of the plain version
// (masked_fill with float32's lowest value, ops/reference.py) gives. The TPU
// kernel zeroes such rows' p instead; the port follows its plain version.
//
// Design. The TPU kernels' grid runs in order on one core; here one CTA of
// 256 threads takes one (batch*head, 64-row tile) and walks the other
// operand's tiles with a loop inside the block, as the forward does. The dq
// kernel owns 64 query rows and walks the key tiles; the dkv kernel owns 64
// key rows and walks the query tiles. Each CTA owns the rows it writes, so
// neither needs atomics or a second pass. Four threads share one owned row:
// each forms the scores of 16 of the 64 partner rows of the tile, and the
// row's accumulators (dq; or dk and dv) are split by column across the four,
// fed by width-4 warp shuffles of p and ds. Tiles are staged in shared memory
// as float with rows padded by one word against bank conflicts. Ragged edges
// of Lq and Lk are masked here, not padded by the host, and every operand and
// gradient is addressed through element strides over (batch, head, row), so
// the (B, L, H, Dh) views of a fused QKV projection and their gradients need
// no copy.
//
// What bounds it. Plain FP32 FMA (no tensor cores), as the forward. At the
// training shape (B=8, H=4, L=64, Dh=Dv=64) each kernel runs 32 CTAs on 132
// SMs, and each CTA does 0.8 M (dq) or 1 M (dkv) FMAs in one serial tile
// walk: launch and walk latency bound it, not FLOPs or bytes. mma.sync or
// wgmma, TMA and more CTAs are later work.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_common.cuh"

namespace flash_bwd {

using flash::kBlockK;
using flash::kBlockQ;
using flash::kFullMask;
using flash::kLanesPerRow;
using flash::kThreads;
using flash::load_f32;
using flash::store_f32;

constexpr int kTile = kBlockQ;  // both kernels tile queries and keys by 64
static_assert(kBlockQ == kBlockK, "one tile size for queries and keys");

// Strides are in elements over (batch, head, row); the last dim is
// contiguous. Order of the stride array passed from the host.
enum Operand { kQ, kK, kV, kDO, kDQ, kDK, kDV, kOperands };

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (batch*heads, lq), contiguous
  const float* delta;  // D = rowsum(dO * O) - g_lse, (batch*heads, lq)
  void* dq;
  void* dk;
  void* dv;
  int64_t sb[kOperands], sh[kOperands], sl[kOperands];
  int heads, lq, lk;
  int q_off, k_off;
  int causal;
  float scale;
  const int* seed;  // null: no dropout
  uint32_t drop_thresh;
  float drop_scale;
};

template <typename T>
__device__ __forceinline__ const T* operand(const BwdParams& p, const void* x,
                                            Operand o, int b, int h) {
  return static_cast<const T*>(x) + b * p.sb[o] + h * p.sh[o];
}

// rows [r0, r0 + kTile) of a (row, D) operand into shared memory with row
// stride STRIDE, times `mul`; rows at or past `limit` load zeros.
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0,
                                          int limit, float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = r0 + r;
    dst[r * STRIDE + c] = gr < limit ? load_f32(src + gr * row_stride + c) * mul
                                     : 0.f;
  }
}

template <int DH, int DV>
constexpr size_t bwd_smem_bytes() {
  // Two (64, DH + 1) tiles, two (64, DV + 1) tiles, and lse and D of 64 rows.
  return sizeof(float) * (2 * size_t(kTile) * (DH + 1) +
                          2 * size_t(kTile) * (DV + 1) + 2 * size_t(kTile));
}

// dq for one (batch*head, 64-row query tile).
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int kQS = DH + 1;                 // row stride of Q and K tiles
  constexpr int kVS = DV + 1;                 // row stride of dO and V tiles
  constexpr int kCols = kTile / kLanesPerRow; // keys per thread per tile
  constexpr int kOut = DH / kLanesPerRow;     // dq columns per thread
  float* sq = smem;               // q * scale
  float* sdo = sq + kTile * kQS;
  float* sk = sdo + kTile * kVS;
  float* sv = sk + kTile * kQS;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.y * kTile;
  const T* k = operand<T>(p, p.k, kK, b, h);
  const T* v = operand<T>(p, p.v, kV, b, h);
  T* dq = static_cast<T*>(p.dq) + b * p.sb[kDQ] + h * p.sh[kDQ];

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;

  load_tile<T, DH, kQS>(sq, operand<T>(p, p.q, kQ, b, h), p.sl[kQ], q0, p.lq,
                        p.scale);
  load_tile<T, DV, kVS>(sdo, operand<T>(p, p.dout, kDO, b, h), p.sl[kDO], q0,
                        p.lq, 1.f);

  const int qr = q0 + row;
  const bool q_in = qr < p.lq;
  const int q_pos = p.q_off + qr;
  const float lse = q_in ? p.lse[int64_t(bh) * p.lq + qr] : 0.f;
  const float delta = q_in ? p.delta[int64_t(bh) * p.lq + qr] : 0.f;
  const bool dropout = p.seed != nullptr;
  const uint32_t drop_row =
      dropout ? dropout_row_base(uint32_t(*p.seed), uint32_t(bh), q_pos) : 0u;

  float acc[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < p.lk; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Q, dO are stored)
    load_tile<T, DH, kQS>(sk, k, p.sl[kK], k0, p.lk, 1.f);
    load_tile<T, DV, kVS>(sv, v, p.sl[kV], k0, p.lk, 1.f);
    __syncthreads();

    // Scores and dp of this thread's keys: key j*4 + sub of the tile.
    float s[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = sq[row * kQS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] = fmaf(qd, sk[(j * kLanesPerRow + sub) * kQS + d], s[j]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      const float g = sdo[row * kVS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dp[j] = fmaf(g, sv[(j * kLanesPerRow + sub) * kVS + c], dp[j]);
      }
    }

    // ds, in place of s. Only visible weights carry a gradient, and a row
    // with a visible key has p = exp(s - lse).
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kj = k0 + j * kLanesPerRow + sub;
      const bool visible =
          q_in && kj < p.lk && (!p.causal || q_pos >= p.k_off + kj);
      float dpj = dp[j];
      if (dropout) {
        dpj *= dropout_factor(drop_row, p.k_off + kj, p.drop_thresh,
                              p.drop_scale);
      }
      s[j] = visible ? expf(s[j] - lse) * (dpj - delta) : 0.f;
    }

    // dq += ds K. Lane t of the row holds ds of keys j*4 + t; each thread
    // owns dq columns c*4 + sub.
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int t = 0; t < kLanesPerRow; ++t) {
        const float dst = __shfl_sync(kFullMask, s[j], t, kLanesPerRow);
        const float* krow = sk + (j * kLanesPerRow + t) * kQS;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          acc[c] = fmaf(dst, krow[c * kLanesPerRow + sub], acc[c]);
        }
      }
    }
  }

  if (q_in) {
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      store_f32(dq + qr * p.sl[kDQ] + c * kLanesPerRow + sub,
                acc[c] * p.scale);
    }
  }
}

// dk and dv for one (batch*head, 64-row key tile).
template <typename T, int DH, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int kKS = DH + 1;                 // row stride of K and Q tiles
  constexpr int kVS = DV + 1;                 // row stride of V and dO tiles
  constexpr int kRows = kTile / kLanesPerRow; // queries per thread per tile
  constexpr int kOutK = DH / kLanesPerRow;    // dk columns per thread
  constexpr int kOutV = DV / kLanesPerRow;    // dv columns per thread
  float* sk = smem;
  float* sv = sk + kTile * kKS;
  float* sq = sv + kTile * kVS;   // q * scale
  float* sdo = sq + kTile * kKS;
  float* slse = sdo + kTile * kVS;
  float* sdelta = slse + kTile;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * kTile;
  const T* q = operand<T>(p, p.q, kQ, b, h);
  const T* dout = operand<T>(p, p.dout, kDO, b, h);
  T* dk = static_cast<T*>(p.dk) + b * p.sb[kDK] + h * p.sh[kDK];
  T* dv = static_cast<T*>(p.dv) + b * p.sb[kDV] + h * p.sh[kDV];

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;

  load_tile<T, DH, kKS>(sk, operand<T>(p, p.k, kK, b, h), p.sl[kK], k0, p.lk,
                        1.f);
  load_tile<T, DV, kVS>(sv, operand<T>(p, p.v, kV, b, h), p.sl[kV], k0, p.lk,
                        1.f);

  const int kr = k0 + row;
  const bool k_in = kr < p.lk;
  const int k_pos = p.k_off + kr;
  const float inv_lk = 1.f / float(p.lk);
  const bool dropout = p.seed != nullptr;
  const uint32_t seed = dropout ? uint32_t(*p.seed) : 0u;

  float acc_k[kOutK], acc_v[kOutV];
#pragma unroll
  for (int c = 0; c < kOutK; ++c) acc_k[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kOutV; ++c) acc_v[c] = 0.f;

  for (int q0 = 0; q0 < p.lq; q0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and K, V are stored)
    load_tile<T, DH, kKS>(sq, q, p.sl[kQ], q0, p.lq, p.scale);
    load_tile<T, DV, kVS>(sdo, dout, p.sl[kDO], q0, p.lq, 1.f);
    if (tid < kTile) {
      const int qr = q0 + tid;
      const bool in = qr < p.lq;
      slse[tid] = in ? p.lse[int64_t(bh) * p.lq + qr] : 0.f;
      sdelta[tid] = in ? p.delta[int64_t(bh) * p.lq + qr] : 0.f;
    }
    __syncthreads();

    // Scores and dp of this thread's queries: query i*4 + sub of the tile.
    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float kd = sk[row * kKS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        s[i] = fmaf(sq[(i * kLanesPerRow + sub) * kKS + d], kd, s[i]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      const float vc = sv[row * kVS + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        dp[i] = fmaf(sdo[(i * kLanesPerRow + sub) * kVS + c], vc, dp[i]);
      }
    }

    // The forward's weight p, its dropped form (into s, for dv) and ds
    // (into dp, for dk).
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int ti = i * kLanesPerRow + sub;
      const int qi = q0 + ti;
      const int q_pos = p.q_off + qi;
      const bool both_in = qi < p.lq && k_in;
      const bool visible = both_in && (!p.causal || q_pos >= k_pos);
      float pij;
      if (p.causal && q_pos < p.k_off) {
        pij = both_in ? inv_lk : 0.f;  // a row with no visible key
      } else {
        pij = visible ? expf(s[i] - slse[ti]) : 0.f;
      }
      float factor = 1.f;
      if (dropout) {
        factor = dropout_factor(dropout_row_base(seed, uint32_t(bh), q_pos),
                                k_pos, p.drop_thresh, p.drop_scale);
      }
      s[i] = pij * factor;
      dp[i] = visible ? pij * (dp[i] * factor - sdelta[ti]) : 0.f;
    }

    // dv += (mask p)^T dO and dk += ds^T (q * scale). Lane t of the row holds
    // the values of queries i*4 + t; each thread owns columns c*4 + sub.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int t = 0; t < kLanesPerRow; ++t) {
        const float pt = __shfl_sync(kFullMask, s[i], t, kLanesPerRow);
        const float dst = __shfl_sync(kFullMask, dp[i], t, kLanesPerRow);
        const int ti = i * kLanesPerRow + t;
        const float* dorow = sdo + ti * kVS;
        const float* qrow = sq + ti * kKS;
#pragma unroll
        for (int c = 0; c < kOutV; ++c) {
          acc_v[c] = fmaf(pt, dorow[c * kLanesPerRow + sub], acc_v[c]);
        }
#pragma unroll
        for (int c = 0; c < kOutK; ++c) {
          acc_k[c] = fmaf(dst, qrow[c * kLanesPerRow + sub], acc_k[c]);
        }
      }
    }
  }

  if (k_in) {
#pragma unroll
    for (int c = 0; c < kOutK; ++c) {
      store_f32(dk + kr * p.sl[kDK] + c * kLanesPerRow + sub, acc_k[c]);
    }
#pragma unroll
    for (int c = 0; c < kOutV; ++c) {
      store_f32(dv + kr * p.sl[kDV] + c * kLanesPerRow + sub, acc_v[c]);
    }
  }
}

enum Kernel { kDqKernel, kDkvKernel };

// Only the kernel named by `which` is instantiated, so each source that
// includes this header compiles one of the two.
template <Kernel which, typename T, int DH, int DV>
cudaError_t launch(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<DH, DV>();
  void (*kernel)(const BwdParams);
  int rows;
  if constexpr (which == kDqKernel) {
    kernel = flash_bwd_dq_kernel<T, DH, DV>;
    rows = p.lq;
  } else {
    kernel = flash_bwd_dkv_kernel<T, DH, DV>;
    rows = p.lk;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(unsigned(batch) * unsigned(p.heads),
                  unsigned((rows + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <Kernel which, typename T, int DH>
cudaError_t launch_dv(const BwdParams& p, int batch, int dv, cudaStream_t s) {
  switch (dv) {
    case 32: return launch<which, T, DH, 32>(p, batch, s);
    case 64: return launch<which, T, DH, 64>(p, batch, s);
    case 128: return launch<which, T, DH, 128>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Kernel which, typename T>
cudaError_t launch_dh(const BwdParams& p, int batch, int dh, int dv,
                      cudaStream_t s) {
  switch (dh) {
    case 32: return launch_dv<which, T, 32>(p, batch, dv, s);
    case 64: return launch_dv<which, T, 64>(p, batch, dv, s);
    case 128: return launch_dv<which, T, 128>(p, batch, dv, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Kernel which>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int dtype, int batch, int heads, int lq, int lk, int dh, int dv_dim,
        const long long* strides, float scale, int causal, int q_off,
        int k_off, const void* seed, unsigned drop_thresh, float drop_scale,
        void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0) {
    return int(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int o = 0; o < kOperands; ++o) {
    p.sb[o] = strides[3 * o];
    p.sh[o] = strides[3 * o + 1];
    p.sl[o] = strides[3 * o + 2];
  }
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  p.seed = static_cast<const int*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dh<which, float>(p, batch, dh, dv_dim, s); break;
    case 1: err = launch_dh<which, __nv_bfloat16>(p, batch, dh, dv_dim, s);
      break;
    default: err = cudaErrorInvalidValue; break;
  }
  return int(err);
}

}  // namespace flash_bwd

// Both entry points (one in each source) take the same arguments. dtype:
// 0 = float32, 1 = bfloat16. `strides` holds 21 element strides, (batch,
// head, row) for q, k, v, dO, dq, dk, dv in that order. lse and delta are
// contiguous (batch*heads, lq) float32. `seed` is a device int32 (null: no
// dropout). The dq kernel writes dq only; the dkv kernel writes dk and dv
// only. Returns the launch's cudaError_t (0 on success); the kernels run on
// `stream` and allocate nothing.
#define TDM_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *delta, void *dq, void *dk, void *dv,     \
      int dtype, int batch, int heads, int lq, int lk, int dh, int dv_dim,  \
      const long long *strides, float scale, int causal, int q_off,         \
      int k_off, const void *seed, unsigned drop_thresh, float drop_scale,  \
      void *stream
#define TDM_BWD_PASS                                                        \
  q, k, v, dout, lse, delta, dq, dk, dv, dtype, batch, heads, lq, lk, dh,   \
      dv_dim, strides, scale, causal, q_off, k_off, seed, drop_thresh,      \
      drop_scale, stream
