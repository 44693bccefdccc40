// The dq kernel of the flash-attention recompute backward, for Hopper
// (sm_90a), f32 and bf16, f32 accumulation on the tensor cores.
//
// Replaces the TPU kernel `_flash_dq_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (host side
// `_flash_bwd_impl`). The function, its parameters and its treatment of
// dropout and of rows with no visible key are those of
// flash_attention_bwd.cuh's header: for the query rows it owns it
// recomputes, per tile of keys,
//
//   S  = Q K^T scale
//   P  = exp(S - lse), zero where masked
//   dP = dO V^T, times the dropout factor
//   dS = P (dP - D), zero where masked (so in a row with no visible key)
//   dq += dS K
//
// and writes dq = dq scale. In bf16, dS is rounded to q's dtype before its
// product, as the TPU kernel does (`ds.astype(k.dtype)`).
//
// Head widths: every Dh and Dv from 1 up, on instances at D = 16, 32, 64,
// 128 and 256 (the padded max(Dh, Dv)); columns past the true widths load
// as zeros, whole k steps and output blocks past them are skipped, and no
// padded column is stored. A CTA accumulates at most 128 columns of dq
// (registers): with Dh > 128 further CTAs (grid z, ceil(Dh / 128) in all)
// take columns 128-255, ... and recompute S and dP. Above 256 the D 256
// instance runs staged (STAGED): per key tile, S = Q K^T and dP = dO V^T
// sum over 256 columns at a time, Q and K (dO and V) restaged through the
// same shared tiles (flash_mma.cuh mma_abt_staged) one contraction after
// the other, and the CTA's 128 columns of K for dS K come in beside them
// (67 KB of shared memory in f32 at 16 query rows: three CTAs per SM).
//
// Design: the dk/dv kernel's (flash_attention_bwd_dkv.cu) with the roles of
// queries and keys exchanged. Each 16-row query group is one warp's, or, at
// short sequences, several warps' that split every key tile among them (16
// keys each) and sum their dq through shared memory at the end. A CTA
// takes one to four groups of one (batch, head): the host picks the most
// groups that still give at least 128 CTAs, and the key split where even
// one group per CTA does not give more (the training shape, B 8, H 4, L 64:
// 128 CTAs of four warps). Q and dO of the CTA's query rows are loaded
// once, and lse and D of the thread's two rows go to registers; the CTA
// then walks the keys in tiles of 64 rows (32 with one warp per group at
// D 128, for registers, and at D 256, for shared memory), K and V arriving
// by cp.async into a double-buffered ring in shared memory, so the next
// tile's copies overlap this tile's products. All three products run on the
// tensor cores with mma.sync and f32 accumulation: bf16 on m16n8k16 with
// ldmatrix fragments, f32 as 3xTF32 on m16n8k8 (flash_mma.cuh), which keeps
// float32's accuracy; each tile's dS K sums apart before it joins dq. S and
// dP stay in registers, and dS's C fragments are the A fragments of dS K,
// so dS never touches shared memory. Each CTA owns its query rows: no
// atomics, no second pass.
//
// What bounds it. At the training shape the work is 6.3 MFLOP per (b, h)
// and 1 MB in all: launch latency and the latency of one tile's chain of
// dependent steps bound it, not FLOPs (3 TF32 products per f32 product, at
// 495 TFLOP/s) or bytes. At long sequences, the three products per tile
// issued as mma.sync (three each in f32, with the operand splits) and the
// exp and dropout hash of every (query, key) pair.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_attention_bwd.cuh"
#include "flash_mma.cuh"

namespace {

using flash_bwd::BwdParams;
using flash_bwd::kDO;
using flash_bwd::kDQ;
using flash_bwd::kK;
using flash_bwd::kQ;
using flash_bwd::kV;

// Key rows per tile. With one warp per 16 query rows (KW = 1): 64, or 32 at
// D 128, where S, dP and dq of 64 keys would crowd a thread's registers.
// With KW warps splitting each tile: 64, 16 each. At D 256: 32 (shared
// memory), 16 each for KW = 2.
template <int D, int KW>
__host__ __device__ constexpr int key_tile() {
  return D > 128 ? 32 : KW > 1 || D <= 64 ? 64 : 32;
}

template <typename T, int D, int KW, bool STAGED>
constexpr size_t smem_bytes(int rows) {
  // Q and dO of `rows` rows; two stages of K and V tiles. Staged: one
  // `rows` tile (Q, then dO) and one key tile (K, then V) for the
  // contractions, then the CTA's columns of K.
  constexpr size_t kBK = key_tile<D, KW>();
  constexpr size_t S = fmma::stride<T, D>();
  return STAGED ? sizeof(T) * ((rows + kBK) * S +
                               kBK * fmma::stride<T, fmma::out_cols<D>()>())
                : sizeof(T) * S * (2 * size_t(rows) + 4 * kBK);
}

// KW warps share each 16-row query group and split every key tile among
// them (KW = 1, or max_warps<D>() at short sequences); their dq are summed
// at the end. The CTA accumulates the dq columns [col0, col0 + DO).
// STAGED: Dh or Dv above D (256).
template <typename T, int D, int KW, bool STAGED>
__global__ void __launch_bounds__(32 * fmma::kMaxWarps)
    flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int S = fmma::stride<T, D>();
  constexpr int DO = fmma::out_cols<D>();
  constexpr int kBK = key_tile<D, KW>();
  constexpr int kWarpBlocks = kBK / 8 / KW;  // key blocks of 8 per warp
  constexpr int kOutBlocks = DO / 8;
  constexpr int SO = fmma::stride<T, DO>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / (2 * KW);  // 16 query rows per group
  // Staged, the two contractions run one after the other through one pair
  // of tiles: dO takes Q's, V takes K's; the CTA's columns of K follow.
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = STAGED ? sq : sq + rows * S;
  T* sk = sdo + rows * S;                  // two stages of kBK x S
  T* sv = STAGED ? sk : sk + 2 * kBK * S;  // two stages of kBK x S

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.y * rows;
  const int col0 = blockIdx.z * DO;
  const T* q = flash_bwd::operand<T>(p, p.q, kQ, b, h);
  const T* dout = flash_bwd::operand<T>(p, p.dout, kDO, b, h);
  const T* k = flash_bwd::operand<T>(p, p.k, kK, b, h);
  const T* v = flash_bwd::operand<T>(p, p.v, kV, b, h);
  T* dq = static_cast<T*>(p.dq) + b * p.sb[kDQ] + h * p.sh[kDQ];

  const int warp = threadIdx.x / 32;
  const int group = warp / KW;         // the warp's 16 query rows
  const int slice = warp % KW;         // its part of each key tile
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (p.lk + kBK - 1) / kBK;

  auto load_keys = [&](int stage, int k0) {
    fmma::load_tile<T, D>(sk + stage * kBK * S, k, p.sl[kK], k0, kBK, p.lk,
                          p.dh, p.vec);
    fmma::load_tile<T, D>(sv + stage * kBK * S, v, p.sl[kV], k0, kBK, p.lk,
                          p.dv_dim, p.vec);
  };
  if constexpr (!STAGED) {
    fmma::load_tile<T, D>(sq, q, p.sl[kQ], q0, rows, p.lq, p.dh, p.vec);
    fmma::load_tile<T, D>(sdo, dout, p.sl[kDO], q0, rows, p.lq, p.dv_dim,
                          p.vec);
    load_keys(0, 0);
    fmma::cp_async_commit();
  }

  // This thread's two query rows, g and g + 8 of the group's 16.
  int q_row[2], q_pos[2];
  float lse[2], delta[2];
  uint32_t drop_row[2] = {0u, 0u};
  const bool dropout = p.seed != nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    q_row[r] = q0 + group * 16 + g + 8 * r;
    q_pos[r] = p.q_off + q_row[r];
    const bool in = q_row[r] < p.lq;
    lse[r] = in ? p.lse[int64_t(bh) * p.lq + q_row[r]] : 0.f;
    delta[r] = in ? p.delta[int64_t(bh) * p.lq + q_row[r]] : 0.f;
    if (dropout) {
      drop_row[r] = dropout_row_base(
          uint32_t(*p.seed),
          uint32_t((b + p.batch_off) * p.heads_total + p.head_off + h),
          q_pos[r]);
    }
  }

  float acc[kOutBlocks][4];
#pragma unroll
  for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // This warp's keys of the tile: kw0 .. kw0 + 8 kWarpBlocks, at `off` in
    // the stage.
    const int off = slice * 8 * kWarpBlocks;
    const int kw0 = it * kBK + off;
    const int k_blocks = min(kWarpBlocks, (p.lk - kw0 + 7) / 8);
    // S and dP of the group's 16 queries against the warp's keys.
    float s[kWarpBlocks][4], dp[kWarpBlocks][4];
#pragma unroll
    for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
    }
    const T* kt = sk + (it % 2) * kBK * S + off * S;
    if constexpr (STAGED) {
      // The CTA's columns of K, for dS K, after the key tile.
      kt = sk + kBK * S + off * SO;
      fmma::load_tile<T, DO>(sk + kBK * S, k + col0, p.sl[kK], it * kBK, kBK,
                             p.lk, p.dh - col0, p.vec);
      const fmma::Rows<T> keys{k, p.sl[kK], it * kBK, kBK, p.lk};
      const fmma::Rows<T> values{v, p.sl[kV], it * kBK, kBK, p.lk};
      fmma::mma_abt_staged<kWarpBlocks, D>(
          s, sq, fmma::Rows<T>{q, p.sl[kQ], q0, rows, p.lq}, group * 16, sk,
          keys, off, p.dh, p.vec, k_blocks > 0);
      fmma::mma_abt_staged<kWarpBlocks, D>(
          dp, sdo, fmma::Rows<T>{dout, p.sl[kDO], q0, rows, p.lq}, group * 16,
          sv, values, off, p.dv_dim, p.vec, k_blocks > 0);
    } else {
      if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
        load_keys((it + 1) % 2, (it + 1) * kBK);
        fmma::cp_async_commit();
        fmma::cp_async_wait<1>();
      } else {
        fmma::cp_async_wait<0>();
      }
      __syncthreads();
      if (k_blocks > 0) {
        fmma::mma_abt<kWarpBlocks, D>(s, sq + group * 16 * S, kt, p.dh);
        fmma::mma_abt<kWarpBlocks, D>(dp, sdo + group * 16 * S,
                                      sv + (it % 2) * kBK * S + off * S,
                                      p.dv_dim);
      }
    }
    if (k_blocks > 0) {
      // dS, into s. Element c of block j is query row g + 8 (c / 2), key
      // kw0 + 8 j + 2 t + c % 2. Only visible weights carry a gradient, and
      // a row with a visible key has p = exp(s - lse).
#pragma unroll
      for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c / 2;
          const int kj = kw0 + 8 * j + 2 * t + c % 2;
          const bool visible = q_row[r] < p.lq && kj < p.lk &&
                               (!p.causal || q_pos[r] >= p.k_off + kj);
          float dpj = dp[j][c];
          if (dropout) {
            dpj *= dropout_factor(drop_row[r], p.k_off + kj, p.drop_thresh,
                                  p.drop_scale);
          }
          s[j][c] = visible ? expf(s[j][c] * p.scale - lse[r]) * (dpj - delta[r])
                            : 0.f;
        }
      }

      // dq += dS K, over the CTA's columns of K.
      if constexpr (STAGED) {
        fmma::mma_cx<kWarpBlocks, DO, DO>(acc, s, kt, p.dh - col0, k_blocks);
      } else {
        fmma::mma_cx<kWarpBlocks, DO, D>(acc, s, kt + col0, p.dh - col0,
                                         k_blocks);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if constexpr (KW > 1) {
    // Sum the group's KW partial dq into its first warp through the K/V
    // stages, free now.
    constexpr int kStash = 4 * kOutBlocks * 32;
    float* mine = reinterpret_cast<float*>(sk) + warp * kStash;
    fmma::stash(mine, acc);
    __syncthreads();
    if (slice != 0) return;
#pragma unroll
    for (int w = 1; w < KW; ++w) {
#pragma unroll
      for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[n][c] += fmma::stashed(mine + w * kStash, n, c);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_row[r] >= p.lq) continue;
    T* dq_row = dq + q_row[r] * p.sl[kDQ];
#pragma unroll
    for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * n + 2 * t + c;
        if (col < p.dh) {
          flash_bwd::store(dq_row + col, acc[n][2 * r + c] * p.scale);
        }
      }
    }
  }
}

template <typename T, int D, int KW, bool STAGED>
cudaError_t launch_split(const BwdParams& p, int bh, int groups,
                         cudaStream_t stream) {
  // Once per instance: the most shared memory any launch of it asks for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, KW, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes<T, D, KW, STAGED>(16 * fmma::max_warps<D>() / KW)));
  if (attr != cudaSuccess) return attr;
  constexpr int DO = fmma::out_cols<D>();
  const dim3 grid(unsigned(bh), unsigned((p.lq + 16 * groups - 1) / (16 * groups)),
                  unsigned((p.dh + DO - 1) / DO));
  flash_bwd_dq_kernel<T, D, KW, STAGED><<<grid, 32 * KW * groups,
                                          smem_bytes<T, D, KW, STAGED>(
                                              16 * groups),
                                          stream>>>(p);
  return cudaGetLastError();
}

// One 16-row query group per warp, as many groups per CTA (up to
// max_warps<D>()) as keep 128 CTAs; where even one group per CTA gives no
// more CTAs than that (short sequences), max_warps<D>() warps split each
// key tile of the one group.
template <typename T, int D, bool STAGED = false>
cudaError_t launch(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kMost = fmma::max_warps<D>();
  const int bh = batch * p.heads;
  const int groups = fmma::pick_warps(bh, p.lq, kMost);
  if (groups == 1) return launch_split<T, D, kMost, STAGED>(p, bh, 1, stream);
  return launch_split<T, D, 1, STAGED>(p, bh, groups, stream);
}

template <typename T>
cudaError_t launch_width(const BwdParams& p, int batch, cudaStream_t s) {
  switch (flash_bwd::padded_width(p.dh, p.dv_dim)) {
    case 16: return launch<T, 16>(p, batch, s);
    case 32: return launch<T, 32>(p, batch, s);
    case 64: return launch<T, 64>(p, batch, s);
    case 128: return launch<T, 128>(p, batch, s);
    case 256: return launch<T, 256>(p, batch, s);
    default: return launch<T, 256, true>(p, batch, s);
  }
}

}  // namespace

extern "C" int tdm_flash_attention_bwd_dq(TDM_BWD_ARGS) {
  BwdParams p;
  if (!TDM_BWD_PARAMS(p)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_width<float>(p, batch, s)
                              : launch_width<__nv_bfloat16>(p, batch, s);
  return int(err);
}
