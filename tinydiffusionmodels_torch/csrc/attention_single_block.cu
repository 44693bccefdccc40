// Single-block attention for Hopper (sm_90a), f32 and bf16, f32 sums on the
// tensor cores: a forward kernel and its recompute backward, one launch
// each.
//
// Replaces the TPU kernels `_attention_kernel` and `_attention_bwd_kernel`
// in tinydiffusionmodels_tpu/ops/pallas_kernels.py (custom VJP
// `_attention_diffable`). Both take q, k, v of one (batch, head) whole, with
// no mask and no dropout, and compute, with s = (q k^T) * scale in f32 and
// p = exp(s - rowmax) / rowsum(exp(s - rowmax)):
//
//   forward    O  = round(p) V, in q's dtype
//   backward   dp = dO V^T
//              D  = rowsum(round(p) * dp)
//              ds = p (dp - D)
//              dq = round(ds) K scale, dk = round(ds)^T Q scale,
//              dv = round(p)^T dO, each in q's dtype
//
// where round() is a round trip through the operand dtype (a no-op in f32,
// bf16 round-to-nearest-even in bf16), at the points where the TPU kernels
// cast with astype. The TPU kernel forms D = rowsum(dO * O) from an O =
// round(p) V recomputed in f32; rowsum(round(p) * dp) is the same sum taken
// in another order, from the dp the kernel holds anyway, so no O is
// recomputed. p is normalised before it is rounded, so neither kernel may
// rescale a running sum (an online softmax would round another p): each
// holds a query row's scores over all its keys, which L <= 128 allows. No
// logsumexp is written or read: the backward's residuals are q, k and v
// alone, as on the TPU. This is why the pair is not the one-tile case of
// the flash kernels, whose backward reads the forward's lse and forms D
// from the stored output.
//
// Domain: L from 1 to 128 and Dh from 1 to 256, on instances at the padded
// D = 16, 32, 64, 128 and 256 (columns past Dh load as zeros and are not
// stored). A shape outside is refused here with cudaErrorInvalidValue, and
// the wrapper (ops/single_block.py) raises before it launches. Operands and
// results are addressed through element strides over (batch, head, row);
// the last dim is contiguous, and the host picks the widest copy the
// strides allow.
//
// Forward. One CTA per (batch*head, 16 query rows, 64 output columns), so
// the text sampler's shape (B 8, H 4, L 64, Dh 64) gives 128 CTAs. The L
// keys go to ceil(L / 16) warps, 16 each. Q and K arrive by cp.async in one
// group and V in a second, which lands while S = Q K^T is formed. Each warp
// forms its 16 x 16 block of scores, the warps' row maxima and sums meet
// through shared memory at one barrier, each warp normalises its p and
// multiplies it into its keys' rows of V, and the warps' partial O are
// summed in shared memory, each warp taking whole 8-column blocks.
// Every cross-warp sum is taken in warp order, so a call's bits repeat. At
// Dh above 64 further CTAs (grid z) take columns 64-127, ... and form the
// same scores: 128 columns of O per thread's accumulator crowd the
// registers enough that ptxas spills the bf16 instances.
//
// Backward. One CTA per (batch*head, chunk of 16): it writes dq of the
// chunk's 16 query rows and dk and dv of its 16 keys, so the sampler's shape
// again gives 128 CTAs, and every output element has one writer (no
// atomics, no second pass). dk and dv of a key sum over every query row and
// need each row's max, sum and D, so each CTA recomputes them from full
// rows, cheap at L <= 128: its ceil(L / 16) warps take 16 query rows each
// and form S and dP against all L keys from Q, K, V and dO staged in shared
// memory (64 columns at a time in f32, 128 in bf16, so that four 128-row
// tiles fit), then p, D and ds in registers. The chunk's rows of round(ds),
// and its keys' columns of round(ds) and round(p), transposed, go to shared
// memory as the left factors of dq = dS K, dk = dS^T Q and dv = P^T dO,
// whose 16-column blocks the warps share out. The work beyond the
// function's is S and dP of the other rows, (L/16 - 1) x 4 L^2 Dh FLOP.
//
// Tensor cores (flash_mma.cuh): bf16 on m16n8k16 with ldmatrix fragments,
// f32 as 3xTF32 on m16n8k8 (each operand split into a TF32 big and small
// part), which keeps float32's accuracy; sums in f32. The C fragments of
// p are the A fragments of P V (rounded to bf16 there in bf16).
//
// What bounds it. At the sampler shape in f32 the forward moves 2 MB and
// does 34 MFLOP (bytes bound it on the card: 0.63 us at 3.35 TB/s); the
// backward's function moves 3.7 MB and needs five L x L x Dh products, 84
// MFLOP (1.1 us by bytes; 0.51 us as 3xTF32). Both are smaller than a
// launch: the latency of one CTA's chain of copies, products, reductions
// through shared memory and stores bounds them.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxLen = 128;
constexpr int kMaxWidth = 256;
constexpr int kMaxWarps = kMaxLen / 16;  // 16 keys or query rows per warp

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
  int heads, len, dh;
  int vec;  // bytes per copy of the operands into shared memory
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ void store(T* p, float x) {
  *p = from_f32<T>(x);
}

// The max and the sum of x over the four threads of a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
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

// ---- forward ---------------------------------------------------------------

// Output columns per forward CTA.
template <int D>
__host__ __device__ constexpr int fwd_out_cols() {
  return D < 64 ? D : 64;
}

// Q (16 rows) and K (lp rows), D wide; V (lp rows), the CTA's output
// columns; the warps' row maxima and sums.
template <typename T, int D>
size_t fwd_smem_bytes(int lp) {
  constexpr int DO = fwd_out_cols<D>();
  return sizeof(T) * (size_t(fmma::stride<T, D>()) * (16 + lp) +
                      size_t(fmma::stride<T, DO>()) * lp) +
         sizeof(float) * 2 * kMaxWarps * 16;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
    single_block_fwd_kernel(const Params p) {
  constexpr int S = fmma::stride<T, D>();
  constexpr int DO = fwd_out_cols<D>();
  constexpr int SO = fmma::stride<T, DO>();
  constexpr int kOutBlocks = DO / 8;
  constexpr int kStash = 4 * kOutBlocks * 32;  // floats of one warp's O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int lp = 16 * warps;  // keys, padded to 16 per warp
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + 16 * S;
  T* sv = sk + lp * S;
  float* row_max = reinterpret_cast<float*>(sv + lp * SO);  // [warp][row]
  float* row_sum = row_max + kMaxWarps * 16;                 // [warp][row]

  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * 16;
  const int col0 = blockIdx.z * DO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = 16 * warp;  // the warp's keys: key0 .. key0 + 15

  fmma::load_tile<T, D>(sq, at<T>(p, p.q, kQ, b, h), p.sl[kQ], q0, 16, p.len,
                        p.dh, p.vec);
  fmma::load_tile<T, D>(sk, at<T>(p, p.k, kK, b, h), p.sl[kK], 0, lp, p.len,
                        p.dh, p.vec);
  fmma::cp_async_commit();
  fmma::load_tile<T, DO>(sv, at<T>(p, p.v, kV, b, h) + col0, p.sl[kV], 0, lp,
                         p.len, p.dh - col0, p.vec);
  fmma::cp_async_commit();
  fmma::cp_async_wait<1>();
  __syncthreads();

  // Scores of the 16 query rows against the warp's keys. Element c of block
  // j is row g + 8 (c / 2), key key0 + 8 j + 2 t + c % 2.
  float s[2][4] = {};
  fmma::mma_abt<2, D>(s, sq, sk + key0 * S, p.dh);
  // The warp's row maxima m_w and sums l_w of exp(s - m_w), published
  // together: one barrier gives every warp the row's m = max_w m_w and
  // l = sum_w l_w exp(m_w - m). Every warp has a key below L.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = key0 + 8 * j + 2 * t + c % 2 < p.len;
      s[j][c] = in ? s[j][c] * p.scale : -FLT_MAX;
      m[c / 2] = fmaxf(m[c / 2], s[j][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = key0 + 8 * j + 2 * t + c % 2 < p.len;
      l[c / 2] += in ? expf(s[j][c] - m[c / 2]) : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (t == 0) {
      row_max[warp * 16 + g + 8 * r] = m[r];
      row_sum[warp * 16 + g + 8 * r] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = row_max[g + 8 * r];
    for (int w = 1; w < warps; ++w) {
      m[r] = fmaxf(m[r], row_max[w * 16 + g + 8 * r]);
    }
    l[r] = 0.f;
    for (int w = 0; w < warps; ++w) {
      const int i = w * 16 + g + 8 * r;
      l[r] += row_sum[i] * expf(row_max[i] - m[r]);
    }
  }
  // p = exp(s - m) / l, normalised before P V rounds it to the operand
  // dtype.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = key0 + 8 * j + 2 * t + c % 2 < p.len;
      s[j][c] = in ? expf(s[j][c] - m[c / 2]) / l[c / 2] : 0.f;
    }
  }

  fmma::cp_async_wait<0>();
  __syncthreads();  // V has landed
  float acc[kOutBlocks][4] = {};
  const int k_blocks = min(2, (p.len - key0 + 7) / 8);
  fmma::mma_cx<2, DO, DO>(acc, s, sv + key0 * SO, p.dh - col0, k_blocks);
  __syncthreads();  // K and V are consumed: the warps' O go where they were
  float* partial = reinterpret_cast<float*>(sk);
  fmma::stash(partial + warp * kStash, acc);
  __syncthreads();

  // Warp w sums the output blocks n = w, w + warps, ... of every warp's
  // stash, in its own fragment layout (a lane reads its own words: no bank
  // conflict), and stores them.
  T* o = at_mut<T>(p, p.out, kO, b, h);
  for (int n = warp; n < kOutBlocks; n += warps) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < warps; ++w) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sum[c] += fmma::stashed(partial + w * kStash, n, c);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = q0 + g + 8 * (c / 2);
      const int col = col0 + 8 * n + 2 * t + c % 2;
      if (row < p.len && col < p.dh) {
        store(o + int64_t(row) * p.sl[kO] + col, sum[c]);
      }
    }
  }
}

// ---- backward --------------------------------------------------------------

// Columns of Q, K, V and dO staged at a time: shared memory holds all four
// at 128 rows.
template <typename T, int D>
__host__ __device__ constexpr int bwd_chunk() {
  constexpr int kMost = sizeof(T) == 4 ? 64 : 128;
  return D < kMost ? D : kMost;
}

// Q, K, V and dO (8 NB rows, a chunk of columns each); the left factors
// round(dS) of the chunk's query rows and round(dS)^T and round(P)^T of its
// keys (16 rows, 8 NB columns each).
template <typename T, int D, int NB>
constexpr size_t bwd_smem_bytes() {
  return sizeof(T) *
         (4 * size_t(8 * NB) * fmma::stride<T, bwd_chunk<T, D>()>() +
          3 * 16 * size_t(fmma::stride<T, 8 * NB>()));
}

// NB: key blocks of 8 held per query row (8 for L <= 64, 16 for L <= 128).
template <typename T, int D, int NB>
__global__ void __launch_bounds__(32 * kMaxWarps)
    single_block_bwd_kernel(const Params p) {
  constexpr int C = bwd_chunk<T, D>();
  constexpr int SC = fmma::stride<T, C>();
  constexpr int R = 8 * NB;  // key rows staged: L padded to NB blocks
  constexpr int SL = fmma::stride<T, R>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + R * SC;
  T* sv = sk + R * SC;
  T* sdo = sv + R * SC;
  T* ds_rows = sdo + R * SC;    // round(dS), the chunk's query rows
  T* ds_keys = ds_rows + 16 * SL;  // round(dS)^T, the chunk's keys
  T* p_keys = ds_keys + 16 * SL;   // round(P)^T, the chunk's keys

  const int warps = blockDim.x / 32;
  const int lp = 16 * warps;  // query rows, padded to 16 per warp
  const int b = blockIdx.x / p.heads, h = blockIdx.x % p.heads;
  const int chunk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const T* q = at<T>(p, p.q, kQ, b, h);
  const T* k = at<T>(p, p.k, kK, b, h);
  const T* v = at<T>(p, p.v, kV, b, h);
  const T* dout = at<T>(p, p.dout, kDO, b, h);
  const bool staged = p.dh > C;  // more than one chunk of columns

  // S and dP of the warp's 16 query rows against every key, C columns of
  // the head at a time. Element c of block j is query row 16 warp + g +
  // 8 (c / 2), key 8 j + 2 t + c % 2.
  float s[NB][4] = {}, dp[NB][4] = {};
  for (int c0 = 0; c0 < p.dh; c0 += C) {
    if (c0 > 0) __syncthreads();  // the previous chunk is consumed
    fmma::load_tile<T, C>(sq, q + c0, p.sl[kQ], 0, lp, p.len, p.dh - c0,
                          p.vec);
    fmma::load_tile<T, C>(sk, k + c0, p.sl[kK], 0, R, p.len, p.dh - c0,
                          p.vec);
    fmma::cp_async_commit();
    fmma::load_tile<T, C>(sdo, dout + c0, p.sl[kDO], 0, lp, p.len,
                          p.dh - c0, p.vec);
    fmma::load_tile<T, C>(sv, v + c0, p.sl[kV], 0, R, p.len, p.dh - c0,
                          p.vec);
    fmma::cp_async_commit();
    fmma::cp_async_wait<1>();
    __syncthreads();
    fmma::mma_abt<NB, C>(s, sq + 16 * warp * SC, sk, p.dh - c0);
    fmma::cp_async_wait<0>();
    __syncthreads();
    fmma::mma_abt<NB, C>(dp, sdo + 16 * warp * SC, sv, p.dh - c0);
  }

  // The rows' max, sum and D, then p and ds, each in f32.
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = 8 * j + 2 * t + c % 2 < p.len;
      s[j][c] = in ? s[j][c] * p.scale : -FLT_MAX;
      m[c / 2] = fmaxf(m[c / 2], s[j][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = 8 * j + 2 * t + c % 2 < p.len;
      s[j][c] = in ? expf(s[j][c] - m[c / 2]) : 0.f;
      l[c / 2] += s[j][c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[j][c] = s[j][c] / l[c / 2];
      d[c / 2] += round_as<T>(s[j][c]) * dp[j][c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) d[r] = quad_sum(d[r]);

  // The left factors, in the operand dtype: rows of query rows or keys past
  // L hold zeros, so they add nothing to any product.
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = g + 8 * (c / 2);  // the query row within the warp's 16
      const int i = 16 * warp + r;
      const int key = 8 * j + 2 * t + c % 2;
      const bool in = i < p.len && key < p.len;
      const float pij = in ? s[j][c] : 0.f;
      const float dsij = in ? pij * (dp[j][c] - d[c / 2]) : 0.f;
      if (warp == chunk) ds_rows[r * SL + key] = from_f32<T>(dsij);
      if (j / 2 == chunk) {
        const int kr = key - 16 * chunk;
        ds_keys[kr * SL + i] = from_f32<T>(dsij);
        p_keys[kr * SL + i] = from_f32<T>(pij);
      }
    }
  }

  // dq = round(dS) K scale, dk = round(dS)^T Q scale and dv = round(P)^T dO:
  // 16 rows each, C columns at a time, their 16-column blocks shared out
  // among the warps.
  T* dq = at_mut<T>(p, p.out, kDQ, b, h);
  T* dk = at_mut<T>(p, p.dk, kDK, b, h);
  T* dv = at_mut<T>(p, p.dv, kDV, b, h);
  for (int c0 = 0; c0 < p.dh; c0 += C) {
    __syncthreads();  // the left factors are written; a chunk is consumed
    if (staged) {
      fmma::load_tile<T, C>(sq, q + c0, p.sl[kQ], 0, lp, p.len, p.dh - c0,
                            p.vec);
      fmma::load_tile<T, C>(sk, k + c0, p.sl[kK], 0, R, p.len, p.dh - c0,
                            p.vec);
      fmma::load_tile<T, C>(sdo, dout + c0, p.sl[kDO], 0, lp, p.len,
                            p.dh - c0, p.vec);
      fmma::cp_async_commit();
      fmma::cp_async_wait<0>();
      __syncthreads();
    }
    for (int u = warp; u < 3 * (C / 16); u += warps) {
      const int which = u % 3;  // 0: dq, 1: dk, 2: dv
      const int n0 = 16 * (u / 3);
      if (c0 + n0 >= p.dh) continue;
      const T* a = which == 0 ? ds_rows : which == 1 ? ds_keys : p_keys;
      const T* x = which == 0 ? sk : which == 1 ? sq : sdo;
      float acc[2][4] = {};
      fmma::mma_ab<2, SL, SC>(acc, a, x, n0, lp);
      T* out = which == 0 ? dq : which == 1 ? dk : dv;
      const int64_t ld = p.sl[kDQ + which];
      const float scale = which == 2 ? 1.f : p.scale;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = 16 * chunk + g + 8 * (c / 2);
          const int col = c0 + n0 + 8 * n + 2 * t + c % 2;
          if (row < p.len && col < p.dh) {
            store(out + row * ld + col, acc[n][c] * scale);
          }
        }
      }
    }
  }
}

// ---- launches --------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, unsigned bh, cudaStream_t stream) {
  // Once per instance: the most shared memory any launch of it asks for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      single_block_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(fwd_smem_bytes<T, D>(kMaxLen)));
  if (attr != cudaSuccess) return attr;
  constexpr int DO = fwd_out_cols<D>();
  const int warps = (p.len + 15) / 16;
  const dim3 grid(bh, unsigned(warps), unsigned((p.dh + DO - 1) / DO));
  single_block_fwd_kernel<T, D><<<grid, 32 * warps,
                                  fwd_smem_bytes<T, D>(16 * warps),
                                  stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int NB>
cudaError_t launch_bwd(const Params& p, unsigned bh, cudaStream_t stream) {
  constexpr size_t kSmem = bwd_smem_bytes<T, D, NB>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      single_block_bwd_kernel<T, D, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (attr != cudaSuccess) return attr;
  const int warps = (p.len + 15) / 16;
  single_block_bwd_kernel<T, D, NB><<<dim3(bh, unsigned(warps)), 32 * warps,
                                      kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBackward, typename T, int D>
cudaError_t launch(const Params& p, unsigned bh, cudaStream_t s) {
  if constexpr (kBackward) {
    return p.len <= 64 ? launch_bwd<T, D, 8>(p, bh, s)
                       : launch_bwd<T, D, 16>(p, bh, s);
  } else {
    return launch_fwd<T, D>(p, bh, s);
  }
}

// The instance of the padded width D = 16, 32, 64, 128 or 256.
template <bool kBackward, typename T>
cudaError_t launch_width(const Params& p, unsigned bh, cudaStream_t s) {
  if (p.dh <= 16) return launch<kBackward, T, 16>(p, bh, s);
  if (p.dh <= 32) return launch<kBackward, T, 32>(p, bh, s);
  if (p.dh <= 64) return launch<kBackward, T, 64>(p, bh, s);
  if (p.dh <= 128) return launch<kBackward, T, 128>(p, bh, s);
  return launch<kBackward, T, 256>(p, bh, s);
}

template <bool kBackward>
int run(Params& p, int dtype, int batch, int heads, int len, int dh, int vec,
        const long long* strides, float scale, void* stream) {
  const int min_vec = dtype == 1 ? 2 : 4;
  if (batch <= 0 || heads <= 0 || len <= 0 || len > kMaxLen || dh <= 0 ||
      dh > kMaxWidth || (long long)batch * heads > 0x7fffffffLL ||
      vec < min_vec || vec > 16 || (vec & (vec - 1)) != 0) {
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
  p.dh = dh;
  p.vec = vec;
  p.scale = scale;
  const unsigned bh = unsigned(batch) * unsigned(heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return int(launch_width<kBackward, float>(p, bh, s));
    case 1: return int(launch_width<kBackward, __nv_bfloat16>(p, bh, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v and out are (batch, heads, len, dh) arrays addressed through
// `strides`: 12 element strides, (batch, head, row) for q, k, v and out in
// that order. dtype: 0 = float32, 1 = bfloat16; len 1 to 128, dh 1 to 256;
// `scale` is 1/sqrt(dh); vec: bytes per copy of q, k and v into shared
// memory (16, 8, 4; 2 for bf16 only), which their addresses and strides
// must be multiples of. Returns the launch's cudaError_t (0 on success);
// the kernel runs on `stream` and allocates nothing.
extern "C" int tdm_attention_single_block_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int len, int dh, int vec, const long long* strides,
    float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  return run<false>(p, dtype, batch, heads, len, dh, vec, strides, scale,
                    stream);
}

// As the forward, with the output's cotangent dout in (vec also covers it)
// and dq, dk, dv out; `strides` holds 21 element strides, (batch, head,
// row) for q, k, v, dout, dq, dk and dv in that order.
extern "C" int tdm_attention_single_block_bwd(
    const void* q, const void* k, const void* v, const void* dout, void* dq,
    void* dk, void* dv, int dtype, int batch, int heads, int len, int dh,
    int vec, const long long* strides, float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.out = dq;
  p.dk = dk;
  p.dv = dv;
  return run<true>(p, dtype, batch, heads, len, dh, vec, strides, scale,
                   stream);
}
