// Flash-attention forward for Hopper (sm_90a), f32 and bf16, f32 accumulation
// on the tensor cores.
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
// global k), which the backward kernels regenerate; the hashed head is
// (b + batch_off) * heads_total + head_off + h, so a launch on a slice of
// the heads (a tensor-parallel rank's) or of the batch (a data-parallel
// rank's) draws that slice of the whole mask (batch_off 0, head_off 0 and
// heads_total = heads: b * heads + h, the launch's own); the seed is read from a
// device int32, so a launch needs no host value of it. In bf16, the dropped
// weights are rounded to bf16 before P*V, where the TPU kernel rounds them
// (`pv.astype(v.dtype)`).
//
// Head widths. Every Dh and Dv with max(Dh, Dv) up to 256; wider heads are
// the wide kernel's (flash_attention_wide_fwd.cu), and this entry point
// refuses them. The kernel is instantiated at D = 16, 32, 64, 128 and 256,
// D the padded max(Dh, Dv); it takes the true widths at run time, loads
// columns at or past them as zeros (zero columns of q and k change no
// score), skips whole k steps and output blocks past them, and stores no
// padded column. The scale is 1/sqrt(Dh) of the true width. A CTA
// accumulates at most 128 output columns (registers): with Dv > 128, a
// second CTA (grid z) takes columns 128-255 and forms the same scores and
// softmax; only the first writes the lse. The D 256 instance walks keys in
// tiles of 32 and takes at most two warps per query group or two groups
// per CTA (shared memory: its Q and K tiles are 256 wide).
//
// Design. Each 16-row query group is one warp's, or, at short sequences,
// four warps' that split every key tile among them (16 keys each) and merge
// their softmax states (m, l, O) through shared memory at the end. A CTA
// takes one to four groups of one (batch, head): the host picks the most
// groups that still give at least 128 CTAs, and the key split where even
// one group per CTA does not give more (the training shape, B 8, H 4, L 64:
// 128 CTAs of four warps; four groups of one warp, 64 rows, at long
// sequences). The CTA walks the keys in 64-row tiles (32 at D 256) with a
// loop inside the block; K and V tiles arrive by cp.async into a
// double-buffered ring in shared memory, so the next tile's copy overlaps
// this tile's products. The
// widest copy (16, 8 or 4 bytes; bf16 rows aligned to 2 bytes only take
// plain loads) is chosen by the host from the operands' addresses and
// strides, so strided views of a fused QKV projection go in without a copy.
// Both products run on the tensor cores with mma.sync and f32 accumulation:
// bf16 on m16n8k16 with ldmatrix fragments, f32 as 3xTF32 on m16n8k8 (each
// operand split into a TF32 big and small part, big*big + big*small +
// small*big), which keeps float32's accuracy; each tile's P V sums apart
// before it joins the output (flash_mma.cuh). S = Q K^T stays in registers;
// its C fragments are the A fragments of P V, so P never touches shared
// memory. The running max, normalizer and the output rows stay in
// registers.
//
// What bounds it. At the training shape the work is 4.2 MFLOP per (b, h) and
// 1 MB in all: launch latency and the latency of one tile's chain of
// dependent steps (copy, products, softmax, merge) bound it, not FLOPs (3
// TF32 products per f32 product, at 495 TFLOP/s) or bytes. At long
// sequences the f32 path is bound by its three mma.sync per product, the
// splits of each operand, and the softmax's exp between them; mma.sync
// reaches only part of the tensor cores' rate on Hopper. wgmma with TMA for
// bf16 at L >= 512 is the next step (ROADMAP).

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_attention_fwd.cuh"
#include "flash_mma.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Key rows per tile: 64, or 32 at D 256 (shared memory).
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D <= 128 ? 64 : 32;
}

using flash_fwd::Params;
using flash_fwd::store;

template <typename T, int D>
constexpr size_t smem_bytes(int rows) {
  // Q of `rows` rows, two stages of K tiles (D wide) and of V tiles (the
  // CTA's output columns).
  constexpr size_t kTiles = size_t(2) * key_tile<D>();
  return sizeof(T) * (fmma::stride<T, D>() * (size_t(rows) + kTiles) +
                      fmma::stride<T, fmma::out_cols<D>()>() * kTiles);
}

// KW warps share each 16-row query group and split every key tile among
// them (KW = 1, or max_warps<D>() at short sequences: kBlockK / KW keys per
// warp); their softmax states are merged at the end. The CTA accumulates
// the output columns [col0, col0 + DO).
template <typename T, int D, int KW>
__global__ void __launch_bounds__(32 * fmma::kMaxWarps)
    flash_fwd_kernel(const Params p) {
  constexpr int S = fmma::stride<T, D>();
  constexpr int DO = fmma::out_cols<D>();
  constexpr int SV = fmma::stride<T, DO>();
  constexpr int kBlockK = key_tile<D>();
  constexpr int kOutBlocks = DO / 8;
  constexpr int kWarpBlocks = kBlockK / 8 / KW;  // key blocks of 8 per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / (2 * KW);  // 16 per query group
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + rows * S;                          // stages of kBlockK x S
  T* sv = sk + 2 * kBlockK * S;                  // stages of kBlockK x SV
  const int col0 = blockIdx.z * DO;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.y * rows;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + col0;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int warp = threadIdx.x / 32;
  const int group = warp / KW;         // the warp's 16 query rows
  const int slice = warp % KW;         // its part of each key tile
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (p.lk + kBlockK - 1) / kBlockK;

  fmma::load_tile<T, D>(sq, q, p.q_sl, q0, rows, p.lq, p.dh, p.vec);
  fmma::load_tile<T, D>(sk, k, p.k_sl, 0, kBlockK, p.lk, p.dh, p.vec);
  fmma::load_tile<T, DO>(sv, v, p.v_sl, 0, kBlockK, p.lk, p.dv - col0,
                         p.vec);
  fmma::cp_async_commit();

  // This thread's two query rows, g and g + 8 of the group's 16.
  int q_pos[2];
  uint32_t drop_row[2] = {0u, 0u};
  const bool dropout = p.seed != nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    q_pos[r] = p.q_off + q0 + group * 16 + g + 8 * r;
    if (dropout) {
      drop_row[r] = dropout_row_base(
          uint32_t(*p.seed),
          uint32_t((b + p.batch_off) * p.heads_total + p.head_off + h),
          q_pos[r]);
    }
  }
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};
  float acc[kOutBlocks][4];
#pragma unroll
  for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      const int next = (it + 1) % 2;
      const int k0 = (it + 1) * kBlockK;
      fmma::load_tile<T, D>(sk + next * kBlockK * S, k, p.k_sl, k0, kBlockK,
                            p.lk, p.dh, p.vec);
      fmma::load_tile<T, DO>(sv + next * kBlockK * SV, v, p.v_sl, k0,
                             kBlockK, p.lk, p.dv - col0, p.vec);
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();
    // This warp's keys of the tile: kw0 .. kw0 + 8 kWarpBlocks.
    const int off = slice * 8 * kWarpBlocks;
    const int kw0 = it * kBlockK + off;
    const int stage = it % 2;
    const int stage_off_v = stage * kBlockK * SV + off * SV;
    // Key blocks of 8 that hold a key below Lk (none: <= 0).
    const int k_blocks = min(kWarpBlocks, (p.lk - kw0 + 7) / 8);

    float s[kWarpBlocks][4];
#pragma unroll
    for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    }
    if (k_blocks > 0) {
      fmma::mma_abt<kWarpBlocks, D>(s, sq + group * 16 * S,
                                    sk + stage * kBlockK * S + off * S, p.dh);
    }

    // Scale, mask and the tile's row maxima. Element c of block j is row
    // g + 8 (c / 2), key kw0 + 8 j + 2 t + c % 2.
    float tile_max[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = kw0 + 8 * j + 2 * t + c % 2;
        const bool valid =
            kj < p.lk && (!p.causal || q_pos[c / 2] >= p.k_off + kj);
        s[j][c] = valid ? s[j][c] * p.scale : -FLT_MAX;
        tile_max[c / 2] = fmaxf(tile_max[c / 2], s[j][c]);
      }
    }
    float correction[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(kFullMask, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(kFullMask, tile_max[r], 2));
      const float m_new = fmaxf(m[r], tile_max[r]);
      correction[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    // Slots past Lk weigh nothing, even in a row with no visible key.
#pragma unroll
    for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = kw0 + 8 * j + 2 * t + c % 2;
        s[j][c] = kj < p.lk ? expf(s[j][c] - m[c / 2]) : 0.f;
        row_sum[c / 2] += s[j][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(kFullMask, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(kFullMask, row_sum[r], 2);
      l[r] = correction[r] * l[r] + row_sum[r];
    }
    if (dropout) {  // after l: only P*V sees the mask
#pragma unroll
      for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] *= dropout_factor(drop_row[c / 2],
                                    p.k_off + kw0 + 8 * j + 2 * t + c % 2,
                                    p.drop_thresh, p.drop_scale);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= correction[c / 2];
    }
    fmma::mma_cx<kWarpBlocks, DO, DO>(acc, s, sv + stage_off_v, p.dv - col0,
                                      k_blocks);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if constexpr (KW > 1) {
    // Merge the group's KW softmax states into its first warp, through the
    // K/V stages, free now (at least 32 rows of K and of V: room for two
    // warps' states at D 256): per warp the acc fragments, then m and l.
    constexpr int kStash = (4 * kOutBlocks + 4) * 32;
    float* mine = reinterpret_cast<float*>(sk) + warp * kStash;
    fmma::stash(mine, acc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(4 * kOutBlocks + r) * 32 + lane] = m[r];
      mine[(4 * kOutBlocks + 2 + r) * 32 + lane] = l[r];
    }
    __syncthreads();
    if (slice != 0) return;
    float weight[KW][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mw[KW], lw[KW], m_all = -FLT_MAX;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const float* theirs = mine + w * kStash;
        mw[w] = theirs[(4 * kOutBlocks + r) * 32 + lane];
        lw[w] = theirs[(4 * kOutBlocks + 2 + r) * 32 + lane];
        m_all = fmaxf(m_all, mw[w]);
      }
      l[r] = 0.f;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        weight[w][r] = expf(mw[w] - m_all);
        l[r] += weight[w][r] * lw[w];
      }
      m[r] = m_all;
    }
#pragma unroll
    for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          sum += weight[w][c / 2] * fmma::stashed(mine + w * kStash, n, c);
        }
        acc[n][c] = sum;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + group * 16 + g + 8 * r;
    if (qr >= p.lq) continue;
    T* orow = o + qr * p.o_sl;
#pragma unroll
    for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * n + 2 * t + c;
        if (col < p.dv) store(orow + col, acc[n][2 * r + c] / l[r]);
      }
    }
    if (t == 0 && col0 == 0) p.lse[int64_t(bh) * p.lq + qr] = m[r] + logf(l[r]);
  }
}

template <typename T, int D, int KW>
cudaError_t launch_split(const Params& p, int bh, int groups,
                         cudaStream_t stream) {
  // Once per instance: the most shared memory any launch of it asks for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes<T, D>(16 * fmma::max_warps<D>() / KW)));
  if (attr != cudaSuccess) return attr;
  constexpr int DO = fmma::out_cols<D>();
  const dim3 grid(unsigned(bh), unsigned((p.lq + 16 * groups - 1) / (16 * groups)),
                  unsigned((p.dv + DO - 1) / DO));
  flash_fwd_kernel<T, D, KW><<<grid, 32 * KW * groups,
                               smem_bytes<T, D>(16 * groups), stream>>>(p);
  return cudaGetLastError();
}

// One 16-row query group per warp, as many groups per CTA (up to
// max_warps<D>()) as keep 128 CTAs; where even one group per CTA gives no
// more CTAs than that (short sequences), max_warps<D>() warps split each
// key tile of the one group.
template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kMost = fmma::max_warps<D>();
  const int bh = batch * p.heads;
  const int groups = fmma::pick_warps(bh, p.lq, kMost);
  if (groups == 1) return launch_split<T, D, kMost>(p, bh, 1, stream);
  return launch_split<T, D, 1>(p, bh, groups, stream);
}

template <typename T>
cudaError_t launch_width(const Params& p, int batch, cudaStream_t s) {
  const int d = p.dh > p.dv ? p.dh : p.dv;
  if (d <= 16) return launch<T, 16>(p, batch, s);
  if (d <= 32) return launch<T, 32>(p, batch, s);
  if (d <= 64) return launch<T, 64>(p, batch, s);
  if (d <= 128) return launch<T, 128>(p, batch, s);
  if (d <= 256) return launch<T, 256>(p, batch, s);
  return cudaErrorInvalidValue;  // the wide kernel's
}

}  // namespace

// The entry point of flash_attention_fwd.cuh's arguments: max(dh, dv) up
// to 256.
extern "C" int tdm_flash_attention_fwd(TDM_FWD_ARGS) {
  Params p;
  if (!TDM_FWD_PARAMS(p)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_width<float>(p, batch, s)
                              : launch_width<__nv_bfloat16>(p, batch, s);
  return int(err);
}

extern "C" const char* tdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
