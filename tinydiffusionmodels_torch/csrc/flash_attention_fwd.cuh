// Flash-attention forward for Hopper (sm_90a): the parameters and argument
// checks of the two forward kernels, flash_attention_fwd.cu (head widths up
// to 256) and flash_attention_wide_fwd.cu (above 256). Each source compiles
// in parallel with the other; what the kernels compute is in the first's
// header.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_fwd {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (batch*heads, lq), contiguous
  // Element strides over (batch, head, row); the last dim is contiguous.
  int64_t q_sb, q_sh, q_sl;
  int64_t k_sb, k_sh, k_sl;
  int64_t v_sb, v_sh, v_sl;
  int64_t o_sb, o_sh, o_sl;
  int heads, lq, lk, dh, dv;
  int vec;  // bytes per copy of q, k and v into shared memory
  int q_off, k_off;
  // The hashed head: (b + batch_off) * heads_total + head_off + h.
  int head_off, heads_total, batch_off;
  int causal;
  float scale;
  // Dropout: off when seed is null; else keep where hash >= drop_thresh and
  // scale kept weights by drop_scale.
  const int* seed;
  uint32_t drop_thresh;
  float drop_scale;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Checks the arguments and fills `p`; false on arguments no kernel takes.
inline bool make_params(
    Params& p, const void* q, const void* k, const void* v, void* o,
    void* lse, int dtype, int batch, int heads, int lq, int lk, int dh,
    int dv, int vec, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, long long o_sb, long long o_sh,
    long long o_sl, float scale, int causal, int q_off, int k_off,
    int head_off, int heads_total, int batch_off, const void* seed,
    unsigned drop_thresh, float drop_scale) {
  const int min_vec = dtype == 1 ? 2 : 4;
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0 || dh <= 0 || dv <= 0 ||
      (dtype != 0 && dtype != 1) || head_off < 0 ||
      heads_total < head_off + heads || batch_off < 0 || vec < min_vec ||
      vec > 16 || (vec & (vec - 1)) != 0) {
    return false;
  }
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.dh = dh;
  p.dv = dv;
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

}  // namespace flash_fwd

// Both entry points (one in each source) take the same arguments. dtype:
// 0 = float32, 1 = bfloat16. dh, dv: 1 or more (the first entry point takes
// max(dh, dv) up to 256, the wide one above). vec: bytes per copy of q, k
// and v into shared memory (16, 8, 4; 2 for bf16 only), which their
// addresses and (batch, head, row) strides must be multiples of. Strides
// are in elements. head_off and heads_total place the launch's heads among
// the heads the dropout mask is hashed over (0 and `heads` for a whole
// layer), batch_off its batch rows among the global batch's (0 for the
// whole). `seed` is a device int32 (null: no dropout). Returns the launch's
// cudaError_t (0 on success); the kernels run on `stream` and allocate
// nothing.
#define TDM_FWD_ARGS                                                        \
  const void *q, const void *k, const void *v, void *o, void *lse,          \
      int dtype, int batch, int heads, int lq, int lk, int dh, int dv,      \
      int vec, long long q_sb, long long q_sh, long long q_sl,              \
      long long k_sb, long long k_sh, long long k_sl, long long v_sb,       \
      long long v_sh, long long v_sl, long long o_sb, long long o_sh,       \
      long long o_sl, float scale, int causal, int q_off, int k_off,        \
      int head_off, int heads_total, int batch_off, const void *seed,       \
      unsigned drop_thresh, float drop_scale, void *stream
#define TDM_FWD_PARAMS(p)                                                   \
  flash_fwd::make_params(p, q, k, v, o, lse, dtype, batch, heads, lq, lk,   \
                         dh, dv, vec, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,   \
                         v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, scale, causal, \
                         q_off, k_off, head_off, heads_total, batch_off,    \
                         seed, drop_thresh, drop_scale)
