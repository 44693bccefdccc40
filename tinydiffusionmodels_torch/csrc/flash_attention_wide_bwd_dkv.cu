// The dk/dv kernel of the flash-attention recompute backward for Hopper
// (sm_90a) at head widths whose max(Dh, Dv) is above 256, f32 and bf16,
// f32 accumulation on the tensor cores.
//
// Replaces the TPU kernel `_flash_dkv_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py at those widths. It
// computes what flash_attention_bwd_dkv.cu computes, with the parameters
// of flash_attention_bwd.cuh: for the key rows it owns, per tile of
// queries,
//
//   S^T  = K Q^T scale
//   P^T  = exp(S^T - lse), masked (1/Lk in a row with no visible key)
//   dP^T = V dO^T, times the dropout factor
//   dS^T = P^T (dP^T - D), zero where masked
//   dv  += (mask P)^T dO
//   dk  += dS^T Q
//
// then dk = dk scale and dv, with mask P rounded to dO's dtype and dS to
// q's in bf16 (`pv.astype(do.dtype)`, `ds.astype(q.dtype)`), every Dh and
// Dv in (256, 4096].
//
// Design (flash_wide.cuh). A cluster of C CTAs takes one (batch, head) and
// 64 / G key rows; CTA r keeps its W columns of those rows of K and of V
// in shared memory and walks the queries in tiles of 16 (32 in bf16 at G
// 1), its columns of Q and dO and the tile's lse and D arriving by
// cp.async into a two-stage ring. Per tile each warp hashes the tile's
// dropout bits, forms its partial S^T over its columns of Dh and its
// partial dP^T over its columns of Dv in one walk (fwide::abt2, both
// products' chains in flight), and after one cluster barrier sums
// the C x G partials of both from the cluster's shared memory, the same
// sums in every CTA; P^T and dS^T form in registers and their C fragments
// are the A fragments of its own columns of dv and dk. So S^T and dP^T are
// formed once per key block, K, V, Q and dO are read once, and each CTA
// writes only its columns. The slot buffer is the forward's (one, behind a
// split cluster barrier).
//
// What bounds it. At B 8, L 64, H 4, Dh 512 the work is 537 MFLOP (1.6 G
// TF32 products in f32) and 25 MB: the bound is the bytes, 7.5 us at 3.35
// TB/s; the grid is 32 clusters of 4, 128 CTAs of 4 warps (110 KB of
// shared memory in f32, two CTAs an SM), each warp running four query
// tiles of 3xTF32 mma.sync, four exchanges and the exp and hash of its
// 16 x 64 weights, latency-bound with one warp a scheduler (about half
// SDPA's whole backward in f32 and a quarter in bf16 on an H100 at 700 W;
// PERF.md has the times).

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_attention_bwd.cuh"
#include "flash_mma.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

namespace {

using flash_bwd::BwdParams;
using flash_bwd::kDK;
using flash_bwd::kDO;
using flash_bwd::kDV;
using flash_bwd::kK;
using flash_bwd::kQ;
using flash_bwd::kV;

// Query rows a tile: 16, or 32 in bf16 at G 1 (bf16 A fragments of P^T
// and dS^T take pairs of 8-query blocks). Short tiles keep the f32
// kernel's shared memory at G 1 under half the SM's, so two CTAs share an
// SM (the forward's reason).
template <typename T, int G>
__host__ __device__ constexpr int query_tile() {
  return sizeof(T) == 2 && G == 1 ? 32 : 16;
}

// Shared memory of the G-part kernel: K and V of the key rows (64 / G), two
// stages of Q and dO tiles and of lse and D, the four warps' partial S^T
// and dP^T.
template <typename T, int G>
constexpr size_t smem_bytes() {
  constexpr size_t kRows = 64 / G, kBQ = query_tile<T, G>();
  constexpr size_t S = fmma::stride<T, fwide::kPartCols * G>();
  return sizeof(T) * S * (2 * kRows + 4 * kBQ) + sizeof(float) * 4 * kBQ +
         sizeof(float) * 2 * fwide::kWarps * fwide::slot_floats<kBQ / 8>();
}

// One CTA of a cluster: the columns [rank * slice, + slice) of dk and dv of
// the key rows of block `blockIdx.x / C % n_blocks` of one (batch, head).
template <typename T, int G>
__global__ void __launch_bounds__(fwide::kThreads, 2)
    flash_wide_dkv_kernel(const BwdParams p, int n_blocks, int slice) {
  constexpr int RG = fwide::kWarps / G;  // 16-row groups a CTA
  constexpr int kRows = 16 * RG;         // key rows a CTA
  constexpr int kBQ = query_tile<T, G>();
  constexpr int NB = kBQ / 8;            // query blocks of 8 a tile
  constexpr int SW = fwide::kPartCols * G;
  constexpr int S = fmma::stride<T, SW>();
  constexpr int kOut = fwide::kPartCols / 8;  // a warp's output blocks
  constexpr int kSlot = fwide::slot_floats<NB>();
  static_assert(4 * NB <= 32, "a tile's keep bits fill one word");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + kRows * S;
  T* sq = sv + kRows * S;       // two stages of kBQ x S
  T* sdo = sq + 2 * kBQ * S;    // two stages of kBQ x S
  float* slse = reinterpret_cast<float*>(sdo + 2 * kBQ * S);
  float* sdelta = slse + 2 * kBQ;  // both 2 x kBQ
  // The warps' S^T slots, then their dP^T slots.
  float* spart = sdelta + 2 * kBQ;
  float* spart_dp = spart + fwide::kWarps * kSlot;

  const int cluster = int(hop::cluster_size());
  const int rank = int(hop::cluster_rank());
  const int blk = blockIdx.x / cluster;
  const int bh = blk / n_blocks;
  const int k0 = blk % n_blocks * kRows;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int col0 = rank * slice;
  const int wh = fwide::owned(p.dh, col0, slice);      // the CTA's Dh columns
  const int wv = fwide::owned(p.dv_dim, col0, slice);  // and Dv columns
  const T* q = flash_bwd::operand<T>(p, p.q, kQ, b, h) + (wh > 0 ? col0 : 0);
  const T* k = flash_bwd::operand<T>(p, p.k, kK, b, h) + (wh > 0 ? col0 : 0);
  const T* v = flash_bwd::operand<T>(p, p.v, kV, b, h) + (wv > 0 ? col0 : 0);
  const T* dout =
      flash_bwd::operand<T>(p, p.dout, kDO, b, h) + (wv > 0 ? col0 : 0);
  const float* lse = p.lse + int64_t(bh) * p.lq;
  const float* delta = p.delta + int64_t(bh) * p.lq;
  T* dk = static_cast<T*>(p.dk) + b * p.sb[kDK] + h * p.sh[kDK] + col0;
  T* dv = static_cast<T*>(p.dv) + b * p.sb[kDV] + h * p.sh[kDV] + col0;

  const int warp = threadIdx.x / 32;
  const int group = warp % RG;                  // the warp's 16 key rows
  const int pc = warp / RG * fwide::kPartCols;  // its first column
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int depth = fwide::owned(wh, pc, fwide::kPartCols);
  const int width = fwide::owned(wv, pc, fwide::kPartCols);
  const int n_tiles = (p.lq + kBQ - 1) / kBQ;

  auto load_queries = [&](int stage, int q0) {
    fmma::load_tile<T, SW>(sq + stage * kBQ * S, q, p.sl[kQ], q0, kBQ, p.lq,
                           wh, p.vec);
    fmma::load_tile<T, SW>(sdo + stage * kBQ * S, dout, p.sl[kDO], q0, kBQ,
                           p.lq, wv, p.vec);
    fmma::load_row_f32(slse + stage * kBQ, lse, q0, kBQ, p.lq);
    fmma::load_row_f32(sdelta + stage * kBQ, delta, q0, kBQ, p.lq);
  };
  fmma::load_tile<T, SW>(sk, k, p.sl[kK], k0, kRows, p.lk, wh, p.vec);
  fmma::load_tile<T, SW>(sv, v, p.sl[kV], k0, kRows, p.lk, wv, p.vec);
  load_queries(0, 0);
  fmma::cp_async_commit();

  // This thread's two key rows, g and g + 8 of the group's 16.
  int k_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) k_row[r] = k0 + group * 16 + g + 8 * r;
  const float inv_lk = 1.f / float(p.lk);
  const bool dropout = p.seed != nullptr;
  const uint32_t seed = dropout ? uint32_t(*p.seed) : 0u;
  const uint32_t drop_bh =
      uint32_t((b + p.batch_off) * p.heads_total + p.head_off + h);

  float acc_k[kOut][4], acc_v[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_queries((it + 1) % 2, (it + 1) * kBQ);
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();
    const int stage = it % 2;
    const int qw0 = it * kBQ;
    const float* lse_t = slse + stage * kBQ;
    const float* delta_t = sdelta + stage * kBQ;
    const int q_blocks = min(NB, (p.lq - qw0 + 7) / 8);
    const T* qt = sq + stage * kBQ * S + pc;   // the warp's columns of Q
    const T* dot = sdo + stage * kBQ * S + pc;  // and of dO

    // The tile's keep bits (bit 4 j + c: element c of block j, key row
    // g + 8 (c / 2), query qw0 + 8 j + 2 t + c % 2), hashed while the
    // products are in flight.
    uint32_t keep = 0u;
    if (dropout) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q_pos = p.q_off + qw0 + 8 * j + 2 * t + c % 2;
          keep |= uint32_t(dropout_factor(
                      dropout_row_base(seed, drop_bh, q_pos),
                      p.k_off + k_row[c / 2], p.drop_thresh, 1.f) != 0.f)
                  << (4 * j + c);
        }
      }
    }

    // The warp's partial S^T and dP^T of its 16 keys against the tile's
    // queries, then the sums of every part of its rows across the cluster.
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = dpt[j][c] = 0.f;
    }
    fwide::abt2<NB, SW>(st, sk + group * 16 * S + pc, qt, dpt,
                        sv + group * 16 * S + pc, dot, max(depth, width));
    if (it > 0) hop::cluster_wait();  // the last tile's partials are read
    fwide::put<NB>(spart + warp * kSlot, st);
    fwide::put<NB>(spart_dp + warp * kSlot, dpt);
    hop::cluster_sync();
    fwide::gather<NB>(st, spart + group * kSlot, RG * kSlot, G, cluster);
    fwide::gather<NB>(dpt, spart_dp + group * kSlot, RG * kSlot, G, cluster);
    hop::cluster_arrive();

    // The forward's weight p, its dropped form (into st, for dv) and ds
    // (into dpt, for dk). Element c of block j is key row g + 8 (c / 2),
    // query qw0 + 8 j + 2 t + c % 2.
#pragma unroll
    for (int j = 0; j < NB; ++j) {
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
        const float factor = !dropout                    ? 1.f
                             : keep >> (4 * j + c) & 1u ? p.drop_scale
                                                        : 0.f;
        st[j][c] = pij * factor;
        dpt[j][c] = visible ? pij * (dpt[j][c] * factor - delta_t[ti]) : 0.f;
      }
    }

    // dv += (mask P)^T dO and dk += dS^T Q over the warp's columns.
    fmma::mma_cx<NB, fwide::kPartCols, SW, 8>(acc_v, st, dot, width,
                                              q_blocks);
    fmma::mma_cx<NB, fwide::kPartCols, SW, 8>(acc_k, dpt, qt, depth,
                                              q_blocks);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  // No CTA leaves while another may still read its partials.
  hop::cluster_wait();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k_row[r];
    if (kr >= p.lk) continue;
    fwide::store_row(dk + kr * p.sl[kDK] + pc, acc_k, r, p.scale, depth);
    fwide::store_row(dv + kr * p.sl[kDV] + pc, acc_v, r, 1.f, width);
  }
}

template <typename T, int G>
cudaError_t launch(const BwdParams& p, int batch, const fwide::Plan& plan,
                   cudaStream_t stream) {
  const int n_blocks = (p.lk + 64 / G - 1) / (64 / G);
  return hop::launch_clusters(
      flash_wide_dkv_kernel<T, G>,
      (long long)batch * p.heads * n_blocks * plan.cluster,
      fwide::kThreads, plan.cluster, smem_bytes<T, G>(), stream, p, n_blocks,
      plan.slice);
}

template <typename T, int G>
cudaError_t attrs(const fwide::Plan& plan, int* out) {
  return fwide::kernel_attrs(flash_wide_dkv_kernel<T, G>, plan,
                             smem_bytes<T, G>(), out);
}

template <typename T>
cudaError_t launch_plan(const BwdParams& p, int batch, cudaStream_t s) {
  fwide::Plan plan;
  if (!fwide::plan_for(p.dh, p.dv_dim, plan)) return cudaErrorInvalidValue;
  switch (plan.parts) {
    case 1: return launch<T, 1>(p, batch, plan, s);
    case 2: return launch<T, 2>(p, batch, plan, s);
    default: return launch<T, 4>(p, batch, plan, s);
  }
}

}  // namespace

// The dk/dv entry point of flash_attention_bwd.cuh's arguments at
// max(dh, dv_dim) in (256, 4096].
extern "C" int tdm_flash_attention_wide_bwd_dkv(TDM_BWD_ARGS) {
  BwdParams p;
  if (!TDM_BWD_PARAMS(p)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_plan<float>(p, batch, s)
                              : launch_plan<__nv_bfloat16>(p, batch, s);
  return int(err);
}

// out[0..5] for heads of widths dh and dv (dtype as the launch's): a
// thread's registers and spill bytes, the clusters the card holds at once,
// and the plan's parts, cluster and slice (fwide::kernel_attrs).
extern "C" int tdm_flash_attention_wide_bwd_dkv_attrs(int dtype, int dh,
                                                      int dv, int* out) {
  fwide::Plan plan;
  if (!fwide::plan_for(dh, dv, plan) || (dtype != 0 && dtype != 1)) {
    return int(cudaErrorInvalidValue);
  }
  const int g = plan.parts;
  cudaError_t err;
  if (dtype == 0) {
    err = g == 1 ? attrs<float, 1>(plan, out)
          : g == 2 ? attrs<float, 2>(plan, out) : attrs<float, 4>(plan, out);
  } else {
    err = g == 1   ? attrs<__nv_bfloat16, 1>(plan, out)
          : g == 2 ? attrs<__nv_bfloat16, 2>(plan, out)
                   : attrs<__nv_bfloat16, 4>(plan, out);
  }
  return int(err);
}
