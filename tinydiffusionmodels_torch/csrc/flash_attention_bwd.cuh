// Flash-attention recompute backward for Hopper (sm_90a), f32 and bf16,
// f32 accumulation: the parameters both backward kernels take, and the dq
// kernel. The dq kernel is instantiated by flash_attention_bwd_dq.cu; the
// dk/dv kernel has its own design in flash_attention_bwd_dkv.cu. Each source
// compiles in parallel with the other.
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (host side
// `_flash_bwd_impl`). Both recompute the forward's scores s = q k^T scale
// from q and k, as flash_attention_fwd.cu forms them, and the normalized
// weights p = exp(s - lse) from the forward's saved logsumexp, so no (L, L)
// matrix is stored between the passes. With dO the output's gradient and
// D = rowsum(dO * O) - g_lse (computed by the caller; g_lse is the lse's own
// gradient, zero when only O is used):
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
// The dq kernel. The TPU kernel's grid runs in order on one core; here one
// CTA of 256 threads takes one (batch*head, 64-row query tile) and walks the
// key tiles with a loop inside the block. It owns the rows it writes, so it
// needs no atomics. Four threads share one owned row: each forms the scores
// of 16 of the 64 keys of the tile, and the row's dq is split by column
// across the four, fed by width-4 warp shuffles of ds. Tiles are staged in
// shared memory as float with rows padded by one word against bank
// conflicts. Ragged edges of Lq and Lk are masked here, not padded by the
// host, and every operand and gradient is addressed through element strides
// over (batch, head, row), so the (B, L, H, Dh) views of a fused QKV
// projection and their gradients need no copy. Head widths: any Dh and Dv
// from 1 to 128, on instances at D = 16, 32, 64 and 128 (the padded
// max(Dh, Dv)); columns past the true widths load as zeros and are not
// stored.
//
// What bounds the dq kernel. Plain FP32 FMA (no tensor cores). At the
// training shape (B=8, H=4, L=64, Dh=Dv=64) it runs 32 CTAs on 132 SMs, and
// each CTA does 0.8 M FMAs in one serial tile walk: launch and walk latency
// bound it, not FLOPs or bytes. Adopting flash_mma.cuh, as the dk/dv kernel
// does, is the next step (ROADMAP).

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

constexpr int kTile = kBlockQ;  // the dq kernel tiles queries and keys by 64
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
  int heads, lq, lk, dh, dv_dim;
  int vec;  // bytes per copy of q, k, v and dO into shared memory
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

// rows [r0, r0 + kTile) of a (row, cols) operand into shared memory with row
// stride STRIDE and D columns, times `mul`; rows at or past `limit` and
// columns at or past `cols` load zeros.
template <typename T, int D, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0,
                                          int limit, int cols, float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = r0 + r;
    dst[r * STRIDE + c] = gr < limit && c < cols
                              ? load_f32(src + gr * row_stride + c) * mul
                              : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Four (64, D + 1) tiles: q, dO, k and v.
  return sizeof(float) * 4 * size_t(kTile) * (D + 1);
}

// dq for one (batch*head, 64-row query tile), D the padded head width.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const BwdParams p) {
  extern __shared__ float smem[];
  constexpr int kS = D + 1;                   // row stride of every tile
  constexpr int kCols = kTile / kLanesPerRow; // keys per thread per tile
  constexpr int kOut = D / kLanesPerRow;      // dq columns per thread
  float* sq = smem;               // q * scale
  float* sdo = sq + kTile * kS;
  float* sk = sdo + kTile * kS;
  float* sv = sk + kTile * kS;

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

  load_tile<T, D, kS>(sq, operand<T>(p, p.q, kQ, b, h), p.sl[kQ], q0, p.lq,
                      p.dh, p.scale);
  load_tile<T, D, kS>(sdo, operand<T>(p, p.dout, kDO, b, h), p.sl[kDO], q0,
                      p.lq, p.dv_dim, 1.f);

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
    load_tile<T, D, kS>(sk, k, p.sl[kK], k0, p.lk, p.dh, 1.f);
    load_tile<T, D, kS>(sv, v, p.sl[kV], k0, p.lk, p.dv_dim, 1.f);
    __syncthreads();

    // Scores and dp of this thread's keys: key j*4 + sub of the tile.
    float s[kCols], dp[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sq[row * kS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] = fmaf(qd, sk[(j * kLanesPerRow + sub) * kS + d], s[j]);
      }
    }
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float g = sdo[row * kS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        dp[j] = fmaf(g, sv[(j * kLanesPerRow + sub) * kS + c], dp[j]);
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
        const float* krow = sk + (j * kLanesPerRow + t) * kS;
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
      const int col = c * kLanesPerRow + sub;
      if (col < p.dh) store_f32(dq + qr * p.sl[kDQ] + col, acc[c] * p.scale);
    }
  }
}

// The padded width of an instance: 16, 32, 64 or 128 (0: above 128).
inline int padded_width(int dh, int dv) {
  const int d = dh > dv ? dh : dv;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0;
}

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // Once per instance.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(unsigned(batch) * unsigned(p.heads),
                  unsigned((p.lq + kTile - 1) / kTile));
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Checks the arguments and fills `p`; false on arguments no kernel takes.
inline bool make_params(BwdParams& p, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, void* dq, void* dk, void* dv,
                        int dtype, int batch, int heads, int lq, int lk,
                        int dh, int dv_dim, int vec, const long long* strides,
                        float scale, int causal, int q_off, int k_off,
                        const void* seed, unsigned drop_thresh,
                        float drop_scale) {
  const int min_vec = dtype == 1 ? 2 : 4;
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || dh <= 0 ||
      dv_dim <= 0 || padded_width(dh, dv_dim) == 0 || (dtype != 0 && dtype != 1) ||
      vec < min_vec || vec > 16 || (vec & (vec - 1)) != 0) {
    return false;
  }
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
  p.dh = dh;
  p.dv_dim = dv_dim;
  p.vec = vec;
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  p.seed = static_cast<const int*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  return true;
}

}  // namespace flash_bwd

// Both entry points (one in each source) take the same arguments. dtype:
// 0 = float32, 1 = bfloat16. dh, dv_dim: 1 to 128. vec: bytes per copy of
// q, k, v and dO into shared memory (16, 8, 4; 2 for bf16 only), which their
// addresses and strides must be multiples of (the dk/dv kernel reads it).
// `strides` holds 21 element strides, (batch, head, row) for q, k, v, dO,
// dq, dk, dv in that order. lse and delta are contiguous (batch*heads, lq)
// float32. `seed` is a device int32 (null: no dropout). The dq kernel writes
// dq only; the dkv kernel writes dk and dv only. Returns the launch's
// cudaError_t (0 on success); the kernels run on `stream` and allocate
// nothing.
#define TDM_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *delta, void *dq, void *dk, void *dv,     \
      int dtype, int batch, int heads, int lq, int lk, int dh, int dv_dim,  \
      int vec, const long long *strides, float scale, int causal,           \
      int q_off, int k_off, const void *seed, unsigned drop_thresh,         \
      float drop_scale, void *stream
#define TDM_BWD_PARAMS(p)                                                   \
  flash_bwd::make_params(p, q, k, v, dout, lse, delta, dq, dk, dv, dtype,   \
                         batch, heads, lq, lk, dh, dv_dim, vec, strides,    \
                         scale, causal, q_off, k_off, seed, drop_thresh,    \
                         drop_scale)
