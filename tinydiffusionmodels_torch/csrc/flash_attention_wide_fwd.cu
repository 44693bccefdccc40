// Flash-attention forward for Hopper (sm_90a) at head widths whose
// max(Dh, Dv) is above 256, f32 and bf16, f32 accumulation on the tensor
// cores.
//
// Replaces the TPU kernel `_flash_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py at those widths (the
// reference's default denoiser: width 2048, 4 heads of 512). It computes
// what flash_attention_fwd.cu computes, with its parameters
// (flash_attention_fwd.cuh): O in the input dtype and the float32 lse,
// causal with q_off and k_off, the dropout mask of dropout_hash.cuh at the
// same coordinates (the weights dropped after the softmax, rounded to bf16
// before P V in bf16), rows with no visible key averaging V over Lk, and
// every Dh and Dv in (256, 4096].
//
// Design (flash_wide.cuh). A cluster of C CTAs takes one (batch, head) and
// 64 / G query rows; CTA r keeps its W columns of those rows of Q in shared
// memory and walks the keys in tiles (key_tile: 32 / G keys in f32, 64 / G
// in bf16, at least 16), its columns of K and V arriving by cp.async into
// a two-stage ring: the next tile's copies overlap this tile's work, and
// this tile's V lands while its scores are formed. Per tile each warp
// forms its partial scores over its 128 or fewer columns of Dh (3xTF32 on
// mma.sync with two k steps in flight, or bf16), hashes the tile's dropout
// bits meanwhile, puts the partials in its slot, and after one cluster
// barrier sums the C x G partials of its 16 rows from the cluster's shared
// memory, the same sum in every CTA; then the online softmax in registers
// as the narrow kernel's, and P V over the warp's own output columns (its
// C fragments are the A fragments). One slot buffer serves every tile: a
// CTA arrives on the cluster barrier when it has read a tile's partials
// and waits on it before it puts the next, so the wait hides behind the
// next tile's products. CTA 0's first part writes the lse; O is stored two
// columns a store.
//
// What bounds it. At B 8, L 64, H 4, Dh 512 (the --embed_dim 2048 path) the
// work is 268 MFLOP (805 M TF32 products in f32) and 16.8 MB, so the bound
// is the bytes, 5.0 us at 3.35 TB/s (2.5 us in bf16); the grid is 32
// clusters of 4, 128 CTAs of 4 warps. Shared memory (110 KB in f32, 103 KB
// in bf16) leaves room for two CTAs an SM, so the card holds 62 clusters
// and the grid runs in one wave (with 64-key f32 tiles and two slot
// buffers, one CTA an SM, it held fewer than 32 and took two). With one
// warp a scheduler the time goes to latency, not to bytes or products:
// about half of a CTA's clock in the products, the rest in the first
// copies, the softmax, the exchange (cluster barrier and distributed-
// shared-memory reads) and the epilogue (29.5 us in f32, level with SDPA's
// forward; 17.6 us in bf16 against its 10.8; an H100 at 700 W, PERF.md).

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "flash_attention_fwd.cuh"
#include "flash_mma.cuh"
#include "flash_wide.cuh"
#include "hopper.cuh"

namespace {

using flash_fwd::Params;

constexpr unsigned kFullMask = 0xffffffffu;

// Keys a tile: 64 / G in bf16 and 32 / G in f32, at least 16 (bf16 A
// fragments of P take pairs of 8-key blocks). Either keeps the kernel's
// shared memory under half the SM's, so two CTAs share an SM: at B 8, L 64,
// H 4, Dh 512 the card holds 30 clusters of 4 at one CTA an SM, and the
// grid's 32 would take two waves (f32 tiles of 64 keys did).
template <typename T, int G>
__host__ __device__ constexpr int key_tile() {
  return (sizeof(T) == 2 ? 64 : 32) / G < 16 ? 16
                                             : (sizeof(T) == 2 ? 64 : 32) / G;
}

// Shared memory of the G-part kernel: Q's rows (64 / G), two stages of K
// and V tiles (128 G columns wide), the four warps' partial scores.
template <typename T, int G>
constexpr size_t smem_bytes() {
  constexpr size_t kRows = 64 / G, kBlockK = key_tile<T, G>();
  constexpr size_t S = fmma::stride<T, fwide::kPartCols * G>();
  return sizeof(T) * S * (kRows + 4 * kBlockK) +
         sizeof(float) * fwide::kWarps * fwide::slot_floats<kBlockK / 8>();
}

// One CTA of a cluster: the columns [rank * slice, + slice) of Dh and Dv of
// the query rows of block `blockIdx.x / C % n_blocks` of one (batch, head).
template <typename T, int G>
__global__ void __launch_bounds__(fwide::kThreads, 2)
    flash_wide_fwd_kernel(const Params p, int n_blocks, int slice) {
  constexpr int RG = fwide::kWarps / G;  // 16-row groups a CTA
  constexpr int kRows = 16 * RG;         // query rows a CTA
  constexpr int kBlockK = key_tile<T, G>();
  constexpr int NB = kBlockK / 8;        // key blocks of 8 a tile
  constexpr int SW = fwide::kPartCols * G;
  constexpr int S = fmma::stride<T, SW>();
  constexpr int kOut = fwide::kPartCols / 8;  // a warp's output blocks
  constexpr int kSlot = fwide::slot_floats<NB>();
  static_assert(4 * NB <= 32, "a tile's keep bits fill one word");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* sk = sq + kRows * S;            // two stages of kBlockK x S
  T* sv = sk + 2 * kBlockK * S;      // two stages of kBlockK x S
  float* spart = reinterpret_cast<float*>(sv + 2 * kBlockK * S);  // 4 slots

  const int cluster = int(hop::cluster_size());
  const int rank = int(hop::cluster_rank());
  const int blk = blockIdx.x / cluster;
  const int bh = blk / n_blocks;
  const int q0 = blk % n_blocks * kRows;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int col0 = rank * slice;
  const int wh = fwide::owned(p.dh, col0, slice);  // the CTA's Dh columns
  const int wv = fwide::owned(p.dv, col0, slice);  // and Dv columns
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
               (wh > 0 ? col0 : 0);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh +
               (wh > 0 ? col0 : 0);
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh +
               (wv > 0 ? col0 : 0);
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + col0;

  const int warp = threadIdx.x / 32;
  const int group = warp % RG;               // the warp's 16 query rows
  const int pc = warp / RG * fwide::kPartCols;  // its first column
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int depth = fwide::owned(wh, pc, fwide::kPartCols);
  const int width = fwide::owned(wv, pc, fwide::kPartCols);
  const int n_tiles = (p.lk + kBlockK - 1) / kBlockK;

  // K and V tiles are committed apart (V after K), so the scores start
  // when Q and K have landed and V lands beside them.
  fmma::load_tile<T, SW>(sq, q, p.q_sl, q0, kRows, p.lq, wh, p.vec);
  fmma::load_tile<T, SW>(sk, k, p.k_sl, 0, kBlockK, p.lk, wh, p.vec);
  fmma::cp_async_commit();
  fmma::load_tile<T, SW>(sv, v, p.v_sl, 0, kBlockK, p.lk, wv, p.vec);
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
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const bool more = it + 1 < n_tiles;
    if (more) {  // prefetch the next tile into the other stage
      const int next = (it + 1) % 2;
      const int k0 = (it + 1) * kBlockK;
      fmma::load_tile<T, SW>(sk + next * kBlockK * S, k, p.k_sl, k0, kBlockK,
                             p.lk, wh, p.vec);
      fmma::cp_async_commit();
      fmma::load_tile<T, SW>(sv + next * kBlockK * S, v, p.v_sl, k0, kBlockK,
                             p.lk, wv, p.vec);
      fmma::cp_async_commit();
      fmma::cp_async_wait<3>();  // this tile's K (V and the next pending)
    } else {
      fmma::cp_async_wait<1>();
    }
    __syncthreads();
    const int stage = it % 2;
    const int kw0 = it * kBlockK;
    const int k_blocks = min(NB, (p.lk - kw0 + 7) / 8);

    // The tile's keep bits (bit 4 j + c: element c of block j), hashed
    // while the products are in flight.
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

    // The warp's partial scores over its columns of Dh, then the sum of
    // every part of its rows across the cluster.
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    }
    if (depth > 0) {
      fwide::abt<NB, SW>(
          s, sq + group * 16 * S + pc, sk + stage * kBlockK * S + pc, depth);
    }
    if (it > 0) hop::cluster_wait();  // the last tile's partials are read
    fwide::put<NB>(spart + warp * kSlot, s);
    // This tile's V has landed; the cluster barrier shows every thread's
    // copies to the CTA.
    if (more) {
      fmma::cp_async_wait<2>();
    } else {
      fmma::cp_async_wait<0>();
    }
    hop::cluster_sync();
    fwide::gather<NB>(s, spart + group * kSlot, RG * kSlot, G, cluster);
    hop::cluster_arrive();

    // Scale, mask and the tile's row maxima. Element c of block j is row
    // g + 8 (c / 2), key kw0 + 8 j + 2 t + c % 2.
    float tile_max[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
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
    for (int j = 0; j < NB; ++j) {
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
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] *= keep >> (4 * j + c) & 1u ? p.drop_scale : 0.f;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= correction[c / 2];
    }
    fmma::mma_cx<NB, fwide::kPartCols, SW, 8>(
        acc, s, sv + stage * kBlockK * S + pc, width, k_blocks);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  // No CTA leaves while another may still read its partials.
  hop::cluster_wait();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + group * 16 + g + 8 * r;
    if (qr >= p.lq) continue;
    fwide::store_row(o + qr * p.o_sl + pc, acc, r, 1.f / l[r], width);
    if (t == 0 && rank == 0 && pc == 0) {
      p.lse[int64_t(bh) * p.lq + qr] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int G>
cudaError_t launch(const Params& p, int batch, const fwide::Plan& plan,
                   cudaStream_t stream) {
  const int n_blocks = (p.lq + 64 / G - 1) / (64 / G);  // query rows 64 / G
  return hop::launch_clusters(
      flash_wide_fwd_kernel<T, G>,
      (long long)batch * p.heads * n_blocks * plan.cluster,
      fwide::kThreads, plan.cluster, smem_bytes<T, G>(), stream, p, n_blocks,
      plan.slice);
}

template <typename T, int G>
cudaError_t attrs(const fwide::Plan& plan, int* out) {
  return fwide::kernel_attrs(flash_wide_fwd_kernel<T, G>, plan,
                             smem_bytes<T, G>(), out);
}

template <typename T>
cudaError_t launch_plan(const Params& p, int batch, cudaStream_t s) {
  fwide::Plan plan;
  if (!fwide::plan_for(p.dh, p.dv, plan)) return cudaErrorInvalidValue;
  switch (plan.parts) {
    case 1: return launch<T, 1>(p, batch, plan, s);
    case 2: return launch<T, 2>(p, batch, plan, s);
    default: return launch<T, 4>(p, batch, plan, s);
  }
}

}  // namespace

// The entry point of flash_attention_fwd.cuh's arguments: max(dh, dv) in
// (256, 4096].
extern "C" int tdm_flash_attention_wide_fwd(TDM_FWD_ARGS) {
  Params p;
  if (!TDM_FWD_PARAMS(p)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_plan<float>(p, batch, s)
                              : launch_plan<__nv_bfloat16>(p, batch, s);
  return int(err);
}

// out[0..5] for heads of widths dh and dv (dtype as the launch's): a
// thread's registers and spill bytes, the clusters the card holds at once,
// and the plan's parts, cluster and slice (fwide::kernel_attrs).
extern "C" int tdm_flash_attention_wide_fwd_attrs(int dtype, int dh,
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
