// The dk/dv kernel of the flash-attention recompute backward, for Hopper
// (sm_90a), f32 and bf16, f32 accumulation on the tensor cores.
//
// Replaces the TPU kernel `_flash_dkv_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (host side
// `_flash_bwd_impl`). The function, its parameters and its treatment of
// dropout and of rows with no visible key are those of
// flash_attention_bwd.cuh's header: for the key rows it owns it recomputes,
// per tile of queries,
//
//   S^T  = K Q^T scale
//   P^T  = exp(S^T - lse), masked (1/Lk in a row with no visible key)
//   dP^T = V dO^T, times the dropout factor
//   dS^T = P^T (dP^T - D), zero where masked
//   dv  += (mask P)^T dO
//   dk  += dS^T Q
//
// and writes dk = dk scale and dv. In bf16, mask P is rounded to dO's dtype
// and dS to q's before their products, as the TPU kernel does
// (`pv.astype(do.dtype)`, `ds.astype(q.dtype)`).
//
// Head widths: every Dh and Dv from 1 up, on instances at D = 16, 32, 64,
// 128 and 256 (the padded max(Dh, Dv)); columns past the true widths load
// as zeros, whole k steps and output blocks past them are skipped, and no
// padded column is stored. A CTA accumulates at most 128 columns of dk and
// of dv (registers): past 128, further CTAs (grid z, ceil(max(Dh, Dv) / 128)
// in all) take columns 128-255, ... of both and recompute S^T and dP^T. The
// D 256 instance walks queries in tiles of 32 and takes at most two warps
// per key group or two groups per CTA (shared memory). Above 256 it runs
// staged (STAGED): per query tile, S^T = K Q^T and dP^T = V dO^T sum over
// 256 columns at a time, K and Q (V and dO) restaged through the same
// shared tiles (flash_mma.cuh mma_abt_staged) one contraction after the
// other, and the CTA's 128 columns of Q and dO come in beside them (84 KB of
// shared memory in f32 at 16 key rows: two CTAs per SM).
//
// Design. Each 16-row key group is one warp's, or, at short sequences,
// four warps' that split every query tile among them (16 queries each) and
// sum their dk and dv through shared memory at the end. A CTA takes one to
// four groups of one (batch, head): the host picks the most groups that
// still give at least 128 CTAs, and the query split where even one group
// per CTA does not give more (the training shape, B 8, H 4, L 64: 128 CTAs
// of four warps). K and V of the CTA's key rows are loaded once; the CTA
// then walks the queries in tiles of 64 rows (32 at D 128 with one warp per
// group, for registers, and at D 256), with Q, dO, lse and D arriving by
// cp.async into a double-buffered ring in shared memory, so the next
// tile's copies overlap this tile's products. All four products run on the tensor cores
// with mma.sync and f32 accumulation: bf16 on m16n8k16 with ldmatrix
// fragments, f32 as 3xTF32 on m16n8k8 (flash_mma.cuh), which keeps
// float32's accuracy. S^T and dP^T stay in registers, and their C fragments
// are the A fragments of the dv and dk products, so P and dS never touch
// shared memory; dk and dv accumulate in registers. Each CTA owns its key
// rows: no atomics, no second pass.
//
// What bounds it. At the training shape the work is 8.4 MFLOP per (b, h) and
// 1.2 MB in all: launch latency and the latency of one tile's chain of
// dependent steps bound it, not FLOPs (3 TF32 products per f32 product, at
// 495 TFLOP/s) or bytes. At long sequences, the four products per tile
// issued as mma.sync (three each in f32, with the operand splits) and the
// exp and dropout hash of every (query, key) pair.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_attention_bwd.cuh"
#include "flash_mma.cuh"

namespace {

using flash_bwd::BwdParams;
using flash_bwd::kDK;
using flash_bwd::kDO;
using flash_bwd::kDV;
using flash_bwd::kK;
using flash_bwd::kQ;
using flash_bwd::kV;
using flash_bwd::store;

// Query rows per tile. With one warp per 16 key rows (QW = 1): 64, or 32
// at D >= 128, where dk, dv, S^T and dP^T of 64 queries would not fit in a
// thread's registers. With QW = 4 warps splitting each tile: 64, 16 each.
// At D 256: 32 (shared memory), 16 each for QW = 2.
template <int D, int QW>
__host__ __device__ constexpr int query_tile() {
  return D > 128 ? 32 : QW > 1 || D <= 64 ? 64 : 32;
}

template <typename T, int D, int QW, bool STAGED>
constexpr size_t smem_bytes(int key_rows) {
  // K and V of `key_rows` rows; two stages of Q and dO tiles; two stages of
  // lse and D. Staged: one `key_rows` tile (K, then V) and one query tile
  // (Q, then dO) for the contractions, then the CTA's columns of Q and dO.
  constexpr size_t kBQ = query_tile<D, QW>();
  constexpr size_t S = fmma::stride<T, D>();
  constexpr size_t SO = fmma::stride<T, fmma::out_cols<D>()>();
  return (STAGED ? sizeof(T) * ((key_rows + kBQ) * S + 2 * kBQ * SO)
                 : sizeof(T) * S * (2 * size_t(key_rows) + 4 * kBQ)) +
         sizeof(float) * 4 * kBQ;
}

// QW warps share each 16-row key group and split every query tile among
// them (QW = 1, or max_warps<D>() at short sequences); their dk and dv are
// summed at the end. The CTA accumulates the columns [col0, col0 + DO) of
// dk and dv. STAGED: Dh or Dv above D (256).
template <typename T, int D, int QW, bool STAGED>
__global__ void __launch_bounds__(32 * fmma::kMaxWarps)
    flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int S = fmma::stride<T, D>();
  constexpr int DO = fmma::out_cols<D>();
  constexpr int kBQ = query_tile<D, QW>();
  constexpr int kWarpBlocks = kBQ / 8 / QW;  // query blocks of 8 per warp
  constexpr int kOutBlocks = DO / 8;
  constexpr int SO = fmma::stride<T, DO>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / (2 * QW);  // 16 key rows per group
  // Staged, the two contractions run one after the other through one pair
  // of tiles: V takes K's, dO takes Q's; the CTA's columns of Q and of dO
  // follow.
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = STAGED ? sk : sk + rows * S;
  T* sq = sv + rows * S;                   // two stages of kBQ x S
  T* sdo = STAGED ? sq : sq + 2 * kBQ * S;  // two stages of kBQ x S
  T* q_slice = sq + kBQ * S;               // staged: kBQ x SO each
  T* do_slice = q_slice + kBQ * SO;
  float* slse = reinterpret_cast<float*>(STAGED ? do_slice + kBQ * SO
                                                : sdo + 2 * kBQ * S);
  float* sdelta = slse + 2 * kBQ;  // both 2 x kBQ

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.y * rows;
  const int col0 = blockIdx.z * DO;
  const T* q = flash_bwd::operand<T>(p, p.q, kQ, b, h);
  const T* dout = flash_bwd::operand<T>(p, p.dout, kDO, b, h);
  const T* k = flash_bwd::operand<T>(p, p.k, kK, b, h);
  const T* v = flash_bwd::operand<T>(p, p.v, kV, b, h);
  const float* lse = p.lse + int64_t(bh) * p.lq;
  const float* delta = p.delta + int64_t(bh) * p.lq;
  T* dk = static_cast<T*>(p.dk) + b * p.sb[kDK] + h * p.sh[kDK];
  T* dv = static_cast<T*>(p.dv) + b * p.sb[kDV] + h * p.sh[kDV];

  const int warp = threadIdx.x / 32;
  const int group = warp / QW;         // the warp's 16 key rows
  const int slice = warp % QW;         // its part of each query tile
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (p.lq + kBQ - 1) / kBQ;

  auto load_queries = [&](int stage, int q0) {
    fmma::load_tile<T, D>(sq + stage * kBQ * S, q, p.sl[kQ], q0, kBQ, p.lq,
                          p.dh, p.vec);
    fmma::load_tile<T, D>(sdo + stage * kBQ * S, dout, p.sl[kDO], q0, kBQ,
                          p.lq, p.dv_dim, p.vec);
    fmma::load_row_f32(slse + stage * kBQ, lse, q0, kBQ, p.lq);
    fmma::load_row_f32(sdelta + stage * kBQ, delta, q0, kBQ, p.lq);
  };
  if constexpr (!STAGED) {
    fmma::load_tile<T, D>(sk, k, p.sl[kK], k0, rows, p.lk, p.dh, p.vec);
    fmma::load_tile<T, D>(sv, v, p.sl[kV], k0, rows, p.lk, p.dv_dim, p.vec);
    load_queries(0, 0);
    fmma::cp_async_commit();
  }

  // This thread's two key rows, g and g + 8 of the group's 16.
  int k_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) k_row[r] = k0 + group * 16 + g + 8 * r;
  const float inv_lk = 1.f / float(p.lk);
  const bool dropout = p.seed != nullptr;
  const uint32_t seed = dropout ? uint32_t(*p.seed) : 0u;
  const uint32_t drop_bh =
      uint32_t((b + p.batch_off) * p.heads_total + p.head_off + h);

  float acc_k[kOutBlocks][4], acc_v[kOutBlocks][4];
#pragma unroll
  for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // This warp's queries of the tile: qw0 .. qw0 + 8 kWarpBlocks, at `off`
    // in the stage.
    const int off = slice * 8 * kWarpBlocks;
    const int qw0 = it * kBQ + off;
    const int stage = STAGED ? 0 : it % 2;
    const float* lse_t = slse + stage * kBQ + off;
    const float* delta_t = sdelta + stage * kBQ + off;
    const int q_blocks = min(kWarpBlocks, (p.lq - qw0 + 7) / 8);
    // S^T and dP^T of the group's 16 keys against the warp's queries.
    float st[kWarpBlocks][4], dpt[kWarpBlocks][4];
#pragma unroll
    for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
    }
    // The warp's rows of Q and dO in the stage.
    const T* qt = sq + stage * kBQ * S + off * S;
    const T* dot = sdo + stage * kBQ * S + off * S;
    // The right factors of dk and dv: those rows at the CTA's columns.
    const T* q_cols = qt + col0;
    const T* do_cols = dot + col0;
    if constexpr (STAGED) {
      // lse and D into the first stage; the CTA's columns of Q and dO
      // after the query tile.
      const int q0 = it * kBQ;
      q_cols = q_slice + off * SO;
      do_cols = do_slice + off * SO;
      fmma::load_row_f32(slse, lse, q0, kBQ, p.lq);
      fmma::load_row_f32(sdelta, delta, q0, kBQ, p.lq);
      fmma::load_tile<T, DO>(q_slice, col0 < p.dh ? q + col0 : q, p.sl[kQ],
                             q0, kBQ, p.lq, p.dh - col0, p.vec);
      fmma::load_tile<T, DO>(do_slice, col0 < p.dv_dim ? dout + col0 : dout,
                             p.sl[kDO], q0, kBQ, p.lq, p.dv_dim - col0,
                             p.vec);
      fmma::mma_abt_staged<kWarpBlocks, D>(
          st, sk, fmma::Rows<T>{k, p.sl[kK], k0, rows, p.lk}, group * 16, sq,
          fmma::Rows<T>{q, p.sl[kQ], q0, kBQ, p.lq}, off, p.dh, p.vec,
          q_blocks > 0);
      fmma::mma_abt_staged<kWarpBlocks, D>(
          dpt, sv, fmma::Rows<T>{v, p.sl[kV], k0, rows, p.lk}, group * 16,
          sdo, fmma::Rows<T>{dout, p.sl[kDO], q0, kBQ, p.lq}, off, p.dv_dim,
          p.vec, q_blocks > 0);
    } else {
      if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
        load_queries((it + 1) % 2, (it + 1) * kBQ);
        fmma::cp_async_commit();
        fmma::cp_async_wait<1>();
      } else {
        fmma::cp_async_wait<0>();
      }
      __syncthreads();
      if (q_blocks > 0) {
        fmma::mma_abt<kWarpBlocks, D>(st, sk + group * 16 * S, qt, p.dh);
        fmma::mma_abt<kWarpBlocks, D>(dpt, sv + group * 16 * S, dot,
                                      p.dv_dim);
      }
    }
    if (q_blocks > 0) {
      // The forward's weight p, its dropped form (into st, for dv) and ds
      // (into dpt, for dk). Element c of block j is key row g + 8 (c / 2),
      // query qw0 + 8 j + 2 t + c % 2.
#pragma unroll
      for (int j = 0; j < kWarpBlocks; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ti = 8 * j + 2 * t + c % 2;
          const int qi = qw0 + ti;
          const int kr = k_row[c / 2];
          const int q_pos = p.q_off + qi;
          const int k_pos = p.k_off + kr;
          const bool both_in = qi < p.lq && kr < p.lk;
          const bool visible = both_in && (!p.causal || q_pos >= k_pos);
          float pij;
          if (p.causal && q_pos < p.k_off) {
            pij = both_in ? inv_lk : 0.f;  // a row with no visible key
          } else {
            pij = visible ? expf(st[j][c] * p.scale - lse_t[ti]) : 0.f;
          }
          float factor = 1.f;
          if (dropout) {
            factor = dropout_factor(dropout_row_base(seed, drop_bh, q_pos),
                                    k_pos, p.drop_thresh, p.drop_scale);
          }
          st[j][c] = pij * factor;
          dpt[j][c] = visible ? pij * (dpt[j][c] * factor - delta_t[ti]) : 0.f;
        }
      }

      // dv += (mask P)^T dO and dk += dS^T Q.
      constexpr int SX = STAGED ? DO : D;  // the row stride of Q and dO
      fmma::mma_cx<kWarpBlocks, DO, SX>(acc_v, st, do_cols, p.dv_dim - col0,
                                        q_blocks);
      fmma::mma_cx<kWarpBlocks, DO, SX>(acc_k, dpt, q_cols, p.dh - col0,
                                        q_blocks);
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if constexpr (QW > 1) {
    // Sum the group's QW partial dk and dv into its first warp, one after
    // the other, through the Q and dO stages, free now.
    constexpr int kStash = 4 * kOutBlocks * 32;
    float* mine = reinterpret_cast<float*>(sq) + warp * kStash;
    auto merge = [&](float (&acc)[kOutBlocks][4]) {
      fmma::stash(mine, acc);
      __syncthreads();
      if (slice == 0) {
#pragma unroll
        for (int w = 1; w < QW; ++w) {
#pragma unroll
          for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[n][c] += fmma::stashed(mine + w * kStash, n, c);
            }
          }
        }
      }
      __syncthreads();  // read before the next stash
    };
    merge(acc_v);
    merge(acc_k);
    if (slice != 0) return;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k_row[r];
    if (kr >= p.lk) continue;
    T* dk_row = dk + kr * p.sl[kDK];
    T* dv_row = dv + kr * p.sl[kDV];
#pragma unroll
    for (int n = 0; n < kOutBlocks; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * n + 2 * t + c;
        if (col < p.dh) store(dk_row + col, acc_k[n][2 * r + c] * p.scale);
        if (col < p.dv_dim) store(dv_row + col, acc_v[n][2 * r + c]);
      }
    }
  }
}

template <typename T, int D, int QW, bool STAGED>
cudaError_t launch_split(const BwdParams& p, int bh, int groups,
                         cudaStream_t stream) {
  // Once per instance: the most shared memory any launch of it asks for.
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, QW, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes<T, D, QW, STAGED>(16 * fmma::max_warps<D>() / QW)));
  if (attr != cudaSuccess) return attr;
  constexpr int DO = fmma::out_cols<D>();
  const int cols = p.dh > p.dv_dim ? p.dh : p.dv_dim;
  const dim3 grid(unsigned(bh), unsigned((p.lk + 16 * groups - 1) / (16 * groups)),
                  unsigned((cols + DO - 1) / DO));
  flash_bwd_dkv_kernel<T, D, QW, STAGED><<<grid, 32 * QW * groups,
                                           smem_bytes<T, D, QW, STAGED>(
                                               16 * groups),
                                           stream>>>(p);
  return cudaGetLastError();
}

// One 16-row key group per warp, as many groups per CTA (up to
// max_warps<D>()) as keep 128 CTAs; where even one group per CTA gives no
// more CTAs than that (short sequences), max_warps<D>() warps split each
// query tile of the one group.
template <typename T, int D, bool STAGED = false>
cudaError_t launch(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int kMost = fmma::max_warps<D>();
  const int bh = batch * p.heads;
  const int groups = fmma::pick_warps(bh, p.lk, kMost);
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

extern "C" int tdm_flash_attention_bwd_dkv(TDM_BWD_ARGS) {
  BwdParams p;
  if (!TDM_BWD_PARAMS(p)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_width<float>(p, batch, s)
                              : launch_width<__nv_bfloat16>(p, batch, s);
  return int(err);
}
