// Flash-attention recompute backward for Hopper (sm_90a), f32 and bf16,
// f32 accumulation: what the backward kernels compute, and the parameters
// and argument checks they share. The dq kernel is flash_attention_bwd_dq.cu
// (max(Dh, Dv) up to 256) and flash_attention_wide_bwd_dq.cu (above 256),
// the dk/dv kernel flash_attention_bwd_dkv.cu and
// flash_attention_wide_bwd_dkv.cu; each source compiles in parallel with
// the others.
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
// Head widths: every Dh and Dv from 1 up to 4096, on instances at D = 16,
// 32, 64, 128 and 256 (the padded max(Dh, Dv)); above 256 both are the
// wide kernels' (flash_wide.cuh).
// Columns past the true widths load as zeros and are not stored. The
// kernels are on the tensor cores (flash_mma.cuh); each source's header
// says how it is laid out.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_bwd {

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
  // The hashed head: (b + batch_off) * heads_total + head_off + h.
  int head_off, heads_total, batch_off;
  int causal;
  float scale;
  const int* seed;  // null: no dropout
  uint32_t drop_thresh;
  float drop_scale;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ const T* operand(const BwdParams& p, const void* x,
                                            Operand o, int b, int h) {
  return static_cast<const T*>(x) + b * p.sb[o] + h * p.sh[o];
}

// The padded width of an instance: 16, 32, 64, 128 or 256 (0: above 256,
// the wide kernels').
inline int padded_width(int dh, int dv) {
  const int d = dh > dv ? dh : dv;
  return d <= 16    ? 16
         : d <= 32  ? 32
         : d <= 64  ? 64
         : d <= 128 ? 128
         : d <= 256 ? 256
                    : 0;
}

// Checks the arguments and fills `p`; false on arguments no kernel takes.
inline bool make_params(BwdParams& p, const void* q, const void* k,
                        const void* v, const void* dout, const void* lse,
                        const void* delta, void* dq, void* dk, void* dv,
                        int dtype, int batch, int heads, int lq, int lk,
                        int dh, int dv_dim, int vec, const long long* strides,
                        float scale, int causal, int q_off, int k_off,
                        int head_off, int heads_total, int batch_off,
                        const void* seed,
                        unsigned drop_thresh, float drop_scale) {
  const int min_vec = dtype == 1 ? 2 : 4;
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || dh <= 0 ||
      dv_dim <= 0 || (dtype != 0 && dtype != 1) || head_off < 0 ||
      heads_total < head_off + heads || batch_off < 0 ||
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
  p.head_off = head_off;
  p.heads_total = heads_total;
  p.batch_off = batch_off;
  p.causal = causal;
  p.scale = scale;
  p.seed = static_cast<const int*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  return true;
}

}  // namespace flash_bwd

// The entry points (one in each source) take the same arguments. dtype:
// 0 = float32, 1 = bfloat16. dh, dv_dim: 1 or more. vec: bytes per copy of
// q, k, v and dO into shared memory (16, 8, 4; 2 for bf16 only), which their
// addresses and strides must be multiples of.
// `strides` holds 21 element strides, (batch, head, row) for q, k, v, dO,
// dq, dk, dv in that order. lse and delta are contiguous (batch*heads, lq)
// float32. head_off, heads_total and batch_off place the launch's heads and
// rows among those the dropout mask is hashed over, as in the forward.
// `seed` is a device int32 (null: no dropout). The dq kernel writes
// dq only; the dkv kernels write dk and dv only. Returns the launch's
// cudaError_t (0 on success); the kernels run on `stream` and allocate
// nothing.
#define TDM_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *delta, void *dq, void *dk, void *dv,     \
      int dtype, int batch, int heads, int lq, int lk, int dh, int dv_dim,  \
      int vec, const long long *strides, float scale, int causal,           \
      int q_off, int k_off, int head_off, int heads_total, int batch_off,   \
      const void *seed, unsigned drop_thresh, float drop_scale, void *stream
#define TDM_BWD_PARAMS(p)                                                   \
  flash_bwd::make_params(p, q, k, v, dout, lse, delta, dq, dk, dv, dtype,   \
                         batch, heads, lq, lk, dh, dv_dim, vec, strides,    \
                         scale, causal, q_off, k_off, head_off,             \
                         heads_total, batch_off, seed, drop_thresh,         \
                         drop_scale)
