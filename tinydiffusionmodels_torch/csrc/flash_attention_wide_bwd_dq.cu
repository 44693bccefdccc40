// The dq kernel of the flash-attention recompute backward for Hopper
// (sm_90a) at head widths whose max(Dh, Dv) is above 256, f32 and bf16,
// f32 accumulation on the tensor cores.
//
// Replaces the TPU kernel `_flash_dq_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py at those widths (the
// reference's default denoiser: width 2048, 4 heads of 512). It computes
// what flash_attention_bwd_dq.cu computes, with the parameters of
// flash_attention_bwd.cuh: for the query rows it owns, per tile of keys,
//
//   S  = Q K^T scale
//   P  = exp(S - lse), zero where masked
//   dP = dO V^T, times the dropout factor
//   dS = P (dP - D), zero where masked (so in a row with no visible key)
//   dq += dS K
//
// then dq = dq scale, with dS rounded to k's dtype in bf16
// (`ds.astype(k.dtype)`), every Dh and Dv in (256, 4096].
//
// Design (flash_wide.cuh): the dk/dv kernel's with queries and keys
// exchanged. A cluster of C CTAs takes one (batch, head) and 64 / G query
// rows, G at least 2 (kMinParts); CTA r keeps its W columns of those rows
// of Q and of dO in shared memory (and each thread the lse and D of its
// two rows in registers) and walks the keys in tiles of 16 (32 in bf16 at
// G 2), its columns of K and V arriving by cp.async into a two-stage
// ring. Per tile each warp hashes
// the tile's dropout bits, forms its partial S over its columns of Dh and
// its partial dP over its columns of Dv in one walk (fwide::abt2, both
// products' chains in flight), and after one cluster barrier sums the C
// x G partials of both from the cluster's shared memory, the same sums in
// every CTA; dS forms in registers and its C fragments are the A fragments
// of dS K against the CTA's own columns of K, already in the ring. So S
// and dP are formed once per row block, Q, dO, K and V are read once, and
// each CTA writes only its columns of dq, with no atomics.
// A CTA that owns no column of Dh (Dv wider than Dh) adds its dP partials
// and zero S partials, and writes nothing. Under the causal mask the key
// tiles past the row block's last visible key are skipped, by a rule that
// depends on the row block alone, so every CTA of a cluster walks the
// same tiles and takes the same barriers. The slot buffers are the dk/dv
// kernel's (one for S, one for dP, behind a split cluster barrier).
//
// What bounds it. At B 8, L 64, H 4, Dh 512 the work is 403 MFLOP (1.2 G
// TF32 products in f32) and 21 MB: the bound is the bytes, 6.3 us at 3.35
// TB/s; the grid is 64 clusters of 2 (32 query rows a row block, so K and
// V are read twice), 128 CTAs of 4 warps (141 KB of shared memory in f32,
// 117 KB in bf16: one CTA an SM), each warp running four key tiles of
// 3xTF32 mma.sync (two of bf16), as many exchanges and the exp and hash of
// its 16 x 64 weights: latency-bound with one warp a scheduler, as the
// dk/dv kernel (PERF.md has its times).

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
using flash_bwd::kDO;
using flash_bwd::kDQ;
using flash_bwd::kK;
using flash_bwd::kQ;
using flash_bwd::kV;

// Parts a CTA, at least: two 128-column parts and 32 query rows, so the
// cluster of a row block is half the forward's and dk/dv's (clusters of 2
// at Dh 512). At B 8, L 64, H 4, Dh 512 that read 0.934x (f32) and 0.831x
// (bf16, with 32-key tiles) of the one-part plan's time, K and V read
// twice notwithstanding, and four parts (clusters of 1) 1.072x (f32) and
// 0.993x of two (PERF.md, PR 22).
constexpr int kMinParts = 2;

// Keys a tile: 16, or 32 in bf16 at G 2 (bf16 A fragments of dS take pairs
// of 8-key blocks; bf16 at G 2 holds twice the tiles in 117 KB).
template <typename T, int G>
__host__ __device__ constexpr int key_tile() {
  return sizeof(T) == 2 && G == 2 ? 32 : 16;
}

// Shared memory of the G-part kernel: Q and dO of the query rows (64 / G),
// two stages of K and V tiles, the four warps' partial S and dP.
template <typename T, int G>
constexpr size_t smem_bytes() {
  constexpr size_t kRows = 64 / G, kBK = key_tile<T, G>();
  constexpr size_t S = fmma::stride<T, fwide::kPartCols * G>();
  return sizeof(T) * S * (2 * kRows + 4 * kBK) +
         sizeof(float) * 2 * fwide::kWarps * fwide::slot_floats<kBK / 8>();
}

// One CTA of a cluster: the columns [rank * slice, + slice) of dq of the
// query rows of block `blockIdx.x / C % n_blocks` of one (batch, head).
template <typename T, int G>
__global__ void __launch_bounds__(fwide::kThreads, 2)
    flash_wide_dq_kernel(const BwdParams p, int n_blocks, int slice) {
  constexpr int RG = fwide::kWarps / G;  // 16-row groups a CTA
  constexpr int kRows = 16 * RG;         // query rows a CTA
  constexpr int kBK = key_tile<T, G>();
  constexpr int NB = kBK / 8;            // key blocks of 8 a tile
  constexpr int SW = fwide::kPartCols * G;
  constexpr int S = fmma::stride<T, SW>();
  constexpr int kOut = fwide::kPartCols / 8;  // a warp's output blocks
  constexpr int kSlot = fwide::slot_floats<NB>();
  static_assert(4 * NB <= 32, "a tile's keep bits fill one word");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sdo = sq + kRows * S;
  T* sk = sdo + kRows * S;     // two stages of kBK x S
  T* sv = sk + 2 * kBK * S;    // two stages of kBK x S
  // The warps' S slots, then their dP slots.
  float* spart = reinterpret_cast<float*>(sv + 2 * kBK * S);
  float* spart_dp = spart + fwide::kWarps * kSlot;

  const int cluster = int(hop::cluster_size());
  const int rank = int(hop::cluster_rank());
  const int blk = blockIdx.x / cluster;
  const int bh = blk / n_blocks;
  const int q0 = blk % n_blocks * kRows;
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
  T* dq = static_cast<T*>(p.dq) + b * p.sb[kDQ] + h * p.sh[kDQ] + col0;

  const int warp = threadIdx.x / 32;
  const int group = warp % RG;                  // the warp's 16 query rows
  const int pc = warp / RG * fwide::kPartCols;  // its first column
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int depth = fwide::owned(wh, pc, fwide::kPartCols);
  const int width = fwide::owned(wv, pc, fwide::kPartCols);
  int n_tiles = (p.lk + kBK - 1) / kBK;
  if (p.causal) {  // up to the last key the block's last row sees
    const int last = p.q_off + min(q0 + kRows, p.lq) - 1 - p.k_off;
    n_tiles = min(n_tiles, max(0, last + kBK) / kBK);
  }

  auto load_keys = [&](int stage, int k0) {
    fmma::load_tile<T, SW>(sk + stage * kBK * S, k, p.sl[kK], k0, kBK, p.lk,
                           wh, p.vec);
    fmma::load_tile<T, SW>(sv + stage * kBK * S, v, p.sl[kV], k0, kBK, p.lk,
                           wv, p.vec);
  };
  if (n_tiles > 0) {
    fmma::load_tile<T, SW>(sq, q, p.sl[kQ], q0, kRows, p.lq, wh, p.vec);
    fmma::load_tile<T, SW>(sdo, dout, p.sl[kDO], q0, kRows, p.lq, wv,
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

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_keys((it + 1) % 2, (it + 1) * kBK);
      fmma::cp_async_commit();
      fmma::cp_async_wait<1>();
    } else {
      fmma::cp_async_wait<0>();
    }
    __syncthreads();
    const int stage = it % 2;
    const int kw0 = it * kBK;
    const int k_blocks = min(NB, (p.lk - kw0 + 7) / 8);
    const T* kt = sk + stage * kBK * S + pc;  // the warp's columns of K
    const T* vt = sv + stage * kBK * S + pc;  // and of V

    // The tile's keep bits (bit 4 j + c: element c of block j, query row
    // g + 8 (c / 2), key kw0 + 8 j + 2 t + c % 2), hashed while the
    // products are in flight.
    uint32_t keep = 0u;
    if (dropout) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          keep |= uint32_t(dropout_factor(
                      drop_row[c / 2], p.k_off + kw0 + 8 * j + 2 * t + c % 2,
                      p.drop_thresh, 1.f) != 0.f)
                  << (4 * j + c);
        }
      }
    }

    // The warp's partial S and dP of its 16 queries against the tile's
    // keys, then the sums of every part of its rows across the cluster.
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
    }
    fwide::abt2<NB, SW>(s, sq + group * 16 * S + pc, kt, dp,
                        sdo + group * 16 * S + pc, vt, max(depth, width));
    if (it > 0) hop::cluster_wait();  // the last tile's partials are read
    fwide::put<NB>(spart + warp * kSlot, s);
    fwide::put<NB>(spart_dp + warp * kSlot, dp);
    hop::cluster_sync();
    fwide::gather<NB>(s, spart + group * kSlot, RG * kSlot, G, cluster);
    fwide::gather<NB>(dp, spart_dp + group * kSlot, RG * kSlot, G, cluster);
    hop::cluster_arrive();

    // dS, into s. Element c of block j is query row g + 8 (c / 2), key
    // kw0 + 8 j + 2 t + c % 2. Only visible weights carry a gradient, and
    // a row with a visible key has p = exp(s - lse).
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c / 2;
        const int kj = kw0 + 8 * j + 2 * t + c % 2;
        const bool visible = q_row[r] < p.lq && kj < p.lk &&
                             (!p.causal || q_pos[r] >= p.k_off + kj);
        const float factor = !dropout                    ? 1.f
                             : keep >> (4 * j + c) & 1u ? p.drop_scale
                                                        : 0.f;
        s[j][c] = visible ? expf(s[j][c] * p.scale - lse[r]) *
                                (dp[j][c] * factor - delta[r])
                          : 0.f;
      }
    }

    // dq += dS K over the warp's columns.
    fmma::mma_cx<NB, fwide::kPartCols, SW, 8>(acc, s, kt, depth, k_blocks);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  // No CTA leaves while another may still read its partials.
  if (n_tiles > 0) hop::cluster_wait();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q_row[r] >= p.lq) continue;
    fwide::store_row(dq + q_row[r] * p.sl[kDQ] + pc, acc, r, p.scale, depth);
  }
}

template <typename T, int G>
cudaError_t launch(const BwdParams& p, int batch, const fwide::Plan& plan,
                   cudaStream_t stream) {
  const int n_blocks = (p.lq + 64 / G - 1) / (64 / G);  // query rows 64 / G
  return hop::launch_clusters(
      flash_wide_dq_kernel<T, G>,
      (long long)batch * p.heads * n_blocks * plan.cluster,
      fwide::kThreads, plan.cluster, smem_bytes<T, G>(), stream, p, n_blocks,
      plan.slice);
}

template <typename T, int G>
cudaError_t attrs(const fwide::Plan& plan, int* out) {
  return fwide::kernel_attrs(flash_wide_dq_kernel<T, G>, plan,
                             smem_bytes<T, G>(), out);
}

template <typename T>
cudaError_t launch_plan(const BwdParams& p, int batch, cudaStream_t s) {
  fwide::Plan plan;
  if (!fwide::plan_for(p.dh, p.dv_dim, plan, kMinParts)) {
    return cudaErrorInvalidValue;
  }
  return plan.parts == 2 ? launch<T, 2>(p, batch, plan, s)
                         : launch<T, 4>(p, batch, plan, s);
}

}  // namespace

// The dq entry point of flash_attention_bwd.cuh's arguments at
// max(dh, dv_dim) in (256, 4096].
extern "C" int tdm_flash_attention_wide_bwd_dq(TDM_BWD_ARGS) {
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
extern "C" int tdm_flash_attention_wide_bwd_dq_attrs(int dtype, int dh,
                                                     int dv, int* out) {
  fwide::Plan plan;
  if (!fwide::plan_for(dh, dv, plan, kMinParts) ||
      (dtype != 0 && dtype != 1)) {
    return int(cudaErrorInvalidValue);
  }
  const bool two = plan.parts == 2;
  const cudaError_t err =
      dtype == 0 ? (two ? attrs<float, 2>(plan, out)
                        : attrs<float, 4>(plan, out))
                 : (two ? attrs<__nv_bfloat16, 2>(plan, out)
                        : attrs<__nv_bfloat16, 4>(plan, out));
  return int(err);
}
