// Flash-attention forward for Hopper (sm_90a), f32 and bf16, f32 accumulation.
//
// Replaces the TPU kernel `_flash_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (driven by
// `_flash_attention_impl` there): tiled online-softmax attention that returns
// O in the input dtype and the per-row float32 logsumexp m + log(l). An
// optional causal predicate keeps key j for query i where q_off + i >=
// k_off + j. Masked scores take -FLT_MAX, the TPU kernel's sentinel, so rows
// whose last tile is ragged get the same lse. Key slots past Lk in the last
// tile get probability 0 after the exp, so a row with no visible key
// averages V over Lk as the plain version does (the TPU kernel pads them and
// divides by the padded length there).
//
// Attention-weight dropout (training) follows torch and the TPU kernel: the
// weights are dropped after the softmax, so the normalizer l and the lse sum
// the undropped weights and only the P*V accumulation sees the mask. The mask
// is the coordinate hash of dropout_hash.cuh (seed, batch*head, global q,
// global k), which the backward kernels regenerate; the seed is read from a
// device int32, so a launch needs no host value of it.
//
// Design. One CTA of 256 threads per (batch*head, 64-row query tile); four
// threads share one query row. The CTA walks the keys and values in 64-row
// tiles with a loop inside the block (the TPU kernel's grid runs in order on
// one core and unrolls that walk statically instead). Each tile is staged in
// shared memory as float, rows padded by one word so that the four threads of
// a row hit four banks. The running max, normalizer and the thread's quarter
// of the output row stay in registers; the row's reductions and the exchange
// of probabilities for P*V are warp shuffles within the four lanes. The
// ragged edge of both Lq and Lk is masked here, not padded by the host. Q, K,
// V and O are addressed through element strides over (batch, head, row), so
// the (B, L, H, Dh) view of a fused QKV projection goes in without a copy.
//
// What bounds it. The products run as plain FP32 FMA (no TF32, no tensor
// cores), matching PyTorch's "highest" float32 matmul default. At the text
// sampler's shape (B=8, H=4, L=64, Dh=64) the grid is 32 CTAs on 132 SMs and
// each CTA does 0.5 M FMAs: the kernel is bound by launch latency and by the
// latency of its one tile walk, not by FLOPs or bytes. Filling the card
// (more, smaller CTAs or a persistent grid), wgmma and TMA are later work.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_common.cuh"

namespace {

using flash::kBlockK;
using flash::kBlockQ;
using flash::kFullMask;
using flash::kLanesPerRow;
using flash::kThreads;
using flash::load_f32;
using flash::store_f32;

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
  int heads, lq, lk;
  int q_off, k_off;
  int causal;
  float scale;
  // Dropout: off when seed is null; else keep where hash >= drop_thresh and
  // scale kept weights by drop_scale.
  const int* seed;
  uint32_t drop_thresh;
  float drop_scale;
};

template <int DH, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kBlockQ) * (DH + 1) + size_t(kBlockK) * (DH + 1) +
          size_t(kBlockK) * DV);
}

template <typename T, int DH, int DV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int kQStride = DH + 1;
  constexpr int kKStride = DH + 1;
  constexpr int kCols = kBlockK / kLanesPerRow;  // scores per thread per tile
  constexpr int kOut = DV / kLanesPerRow;        // output columns per thread
  float* sq = smem;
  float* sk = sq + kBlockQ * kQStride;
  float* sv = sk + kBlockK * kKStride;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.y * kBlockQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid % kLanesPerRow;

  // Q tile, pre-scaled as the TPU kernel does (q * scale before the dot).
  // Rows past Lq load zeros; their results are never stored.
  for (int e = tid; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    const int qr = q0 + r;
    sq[r * kQStride + c] =
        qr < p.lq ? load_f32(q + qr * p.q_sl + c) * p.scale : 0.f;
  }

  const int q_pos = p.q_off + q0 + row;
  const bool dropout = p.seed != nullptr;
  const uint32_t drop_row =
      dropout ? dropout_row_base(uint32_t(*p.seed), uint32_t(bh), q_pos) : 0u;
  float m = -FLT_MAX;
  float l = 0.f;
  float acc[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < p.lk; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int e = tid; e < kBlockK * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const int kr = k0 + r;
      sk[r * kKStride + c] = kr < p.lk ? load_f32(k + kr * p.k_sl + c) : 0.f;
    }
    for (int e = tid; e < kBlockK * DV; e += kThreads) {
      const int r = e / DV, c = e % DV;
      const int kr = k0 + r;
      sv[r * DV + c] = kr < p.lk ? load_f32(v + kr * p.v_sl + c) : 0.f;
    }
    __syncthreads();

    // Scores of this thread's keys: key j*4 + sub of the tile.
    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = sq[row * kQStride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] = fmaf(qd, sk[(j * kLanesPerRow + sub) * kKStride + d], s[j]);
      }
    }

    float tile_max = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kj = k0 + j * kLanesPerRow + sub;
      const bool valid = kj < p.lk && (!p.causal || q_pos >= p.k_off + kj);
      s[j] = valid ? s[j] : -FLT_MAX;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFullMask, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFullMask, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float correction = expf(m - m_new);

    // Slots past Lk weigh nothing, even in a row with no visible key (their
    // V rows are zeros in shared memory, so only l needs this).
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = k0 + j * kLanesPerRow + sub < p.lk ? expf(s[j] - m_new) : 0.f;
      row_sum += s[j];
    }
    row_sum += __shfl_xor_sync(kFullMask, row_sum, 1);
    row_sum += __shfl_xor_sync(kFullMask, row_sum, 2);
    l = correction * l + row_sum;
    if (dropout) {  // after l: only P*V sees the mask
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] *= dropout_factor(drop_row, p.k_off + k0 + j * kLanesPerRow + sub,
                               p.drop_thresh, p.drop_scale);
      }
    }

    // acc = correction * acc + P V. Lane t of the row holds the
    // probabilities of keys j*4 + t; each thread owns output columns
    // c*4 + sub.
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[c] *= correction;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int t = 0; t < kLanesPerRow; ++t) {
        const float pt = __shfl_sync(kFullMask, s[j], t, kLanesPerRow);
        const float* vrow = sv + (j * kLanesPerRow + t) * DV;
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          acc[c] = fmaf(pt, vrow[c * kLanesPerRow + sub], acc[c]);
        }
      }
    }
    m = m_new;
  }

  const int qr = q0 + row;
  if (qr < p.lq) {
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      store_f32(o + qr * p.o_sl + c * kLanesPerRow + sub, acc[c] / l);
    }
    if (sub == 0) p.lse[int64_t(bh) * p.lq + qr] = m + logf(l);
  }
}

template <typename T, int DH, int DV>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH, DV>();
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  flash_fwd_kernel<T, DH, DV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dv(const Params& p, int dv, dim3 grid, cudaStream_t s) {
  switch (dv) {
    case 32: return launch<T, DH, 32>(p, grid, s);
    case 64: return launch<T, DH, 64>(p, grid, s);
    case 128: return launch<T, DH, 128>(p, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dh(const Params& p, int dh, int dv, dim3 grid,
                      cudaStream_t s) {
  switch (dh) {
    case 32: return launch_dv<T, 32>(p, dv, grid, s);
    case 64: return launch_dv<T, 64>(p, dv, grid, s);
    case 128: return launch_dv<T, 128>(p, dv, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `seed` is a
// device int32 (null: no dropout). Returns the launch's cudaError_t (0 on
// success); the kernel runs on `stream` and allocates nothing.
extern "C" int tdm_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int dh, int dv,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, int q_off, int k_off,
    const void* seed, unsigned drop_thresh, float drop_scale, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lk <= 0) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
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
  p.q_off = q_off;
  p.k_off = k_off;
  p.causal = causal;
  p.scale = scale;
  p.seed = static_cast<const int*>(seed);
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  const dim3 grid(unsigned(batch) * unsigned(heads),
                  unsigned((lq + kBlockQ - 1) / kBlockQ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_dh<float>(p, dh, dv, grid, s); break;
    case 1: err = launch_dh<__nv_bfloat16>(p, dh, dv, grid, s); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return int(err);
}

extern "C" const char* tdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
