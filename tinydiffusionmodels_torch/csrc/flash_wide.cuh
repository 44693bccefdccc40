// What the wide flash kernels share: the forward
// (flash_attention_wide_fwd.cu), the dq kernel
// (flash_attention_wide_bwd_dq.cu) and the dk/dv kernel
// (flash_attention_wide_bwd_dkv.cu) at head widths whose max(Dh, Dv) is
// above 256, where a warp's 16 rows of scores no longer come with all
// their output columns in registers.
//
// The split. A (batch, head, row block) is one thread-block cluster of C
// CTAs (at most 8), and CTA r of it owns the columns [r W, r W + W) of the
// head width, of Dh and of Dv alike (W = max(Dh, Dv) / C rounded up to 16).
// It keeps its columns of the resident operand (Q in the forward, Q and
// dO in dq, K and V in dk/dv) in shared memory for the whole walk, and
// takes only its columns of each streamed tile (K and V; Q and dO) through
// a two-stage cp.async ring, so every operand byte is read once per row
// block. Per tile each CTA forms the partial scores over its own columns,
// S_r = Q_r K_r^T (and dP in dq, dP^T in dk/dv), puts them in its shared
// memory, and after one cluster barrier every CTA sums all C partials
// through distributed shared memory (ld.shared::cluster), in the same
// order, so every CTA holds the same S and the same softmax. Then each CTA
// multiplies by its own columns of the other operand (P V, dS K, or P^T dO
// and dS^T Q) and writes only those. S is formed once per row block, not
// once per output slice.
//
// A CTA is four warps. Its W columns are G parts of at most 128 (G = 1, 2
// or 4: one part while C of 8 cover the width, 1024 columns; two up to
// 2048; four up to 4096, the widest a launch takes; the dq kernel takes
// at least two, its header says why): warp w takes part
// w / (4 / G) of the columns for rows 16 (w % (4 / G)) .. + 16, so the
// CTA's rows are 64 / G. Whatever G, a warp contracts over at most 128
// columns and owns at most 128 output columns: 64 registers a thread an
// accumulator. The partials of a tile are one slot a warp, and every warp
// of a row group sums the C x G slots of its rows. The slots are refilled
// only after every CTA has read them: a CTA arrives on the cluster barrier
// (hop::cluster_arrive) when it has gathered a tile and waits
// (hop::cluster_wait) before it puts the next, so the barrier's latency
// hides behind the next tile's products. Each kernel's header gives its
// tiles, which keep two CTAs on an SM where G is 1.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"
#include "hopper.cuh"

namespace fwide {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPartCols = 128;  // columns of a warp's part
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxParts = 4;
constexpr int kMinWidth = 257;  // narrower heads are the other kernels'
constexpr int kMaxWidth = kMaxCluster * kMaxParts * kPartCols;  // 4096

// How a launch splits the head width: G parts a CTA, C CTAs a cluster, W
// columns a CTA.
struct Plan {
  int parts, cluster, slice;
};

// The plan for max(dh, dv) in [kMinWidth, kMaxWidth], with at least
// `min_parts` (1, 2 or 4) parts a CTA; false outside.
inline bool plan_for(int dh, int dv, Plan& plan, int min_parts = 1) {
  const int d = dh > dv ? dh : dv;
  if (d < kMinWidth || d > kMaxWidth) return false;
  const int n = (d + kPartCols - 1) / kPartCols;  // 128-column parts in all
  int g = n <= kMaxCluster ? 1 : n <= 2 * kMaxCluster ? 2 : 4;
  if (g < min_parts) g = min_parts;
  const int c = (d + g * kPartCols - 1) / (g * kPartCols);
  plan = {g, c, ((d + c - 1) / c + 15) / 16 * 16};
  return true;
}

// The columns [0, n) of a width `total` that a CTA starting at `col0` owns,
// `slice` at most.
__device__ __forceinline__ int owned(int total, int col0, int slice) {
  return max(0, min(slice, total - col0));
}

// ---- distributed shared memory ---------------------------------------------

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// Floats of one warp's slot: NB C fragments of 32 lanes.
template <int NB>
__host__ __device__ constexpr int slot_floats() {
  return NB * 32 * 4;
}

// A warp's C fragments x[j] into its slot, one float4 a lane and block, so
// that the stores and the loads of a warp are consecutive 16 bytes.
template <int NB>
__device__ __forceinline__ void put(float* slot, const float (&x)[NB][4]) {
  float4* s = reinterpret_cast<float4*>(slot) + threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[32 * j] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
  }
}

// x = the sum of the slots at `first` + p `step` floats (p < parts) in
// every CTA of the cluster, taken CTA by CTA and part by part from 0, so
// that every warp that sums the same slots gets the same bits. Call after
// a cluster barrier that follows every CTA's put.
template <int NB>
__device__ __forceinline__ void gather(float (&x)[NB][4], const float* first,
                                       int step, int parts, int cluster) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[j][c] = 0.f;
  }
  const uint32_t lane_bytes = 16u * (threadIdx.x % 32);
  for (int r = 0; r < cluster; ++r) {
    const uint32_t base = hop::cluster_addr(first, uint32_t(r)) + lane_bytes;
    for (int part = 0; part < parts; ++part) {
      const uint32_t a = base + 4u * uint32_t(part * step);
      float4 v[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = ld_cluster(a + 512u * j);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        x[j][0] += v[j].x;
        x[j][1] += v[j].y;
        x[j][2] += v[j].z;
        x[j][3] += v[j].w;
      }
    }
  }
}

// ---- products -------------------------------------------------------------

// acc[j] += A B^T as fmma::mma_abt over at most kPartCols columns of tiles
// with the row stride of an SW-wide tile. f32: the even k steps sum into
// acc and the odd ones into a second set, added at the end, so that 2 NB
// chains of 3xTF32 products are in flight rather than NB (one warp a
// scheduler waits on each product's latency otherwise).
template <int NB, int SW>
__device__ __forceinline__ void abt(float (&acc)[NB][4], const float* a,
                                    const float* b, int depth) {
  constexpr int S = fmma::stride<float, SW>();
  float odd[NB][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kPartCols; k0 += 16) {
    if (k0 >= depth) break;
    const fmma::Split<4> fa0 = fmma::tf32_a<S>(a, k0);
    const fmma::Split<4> fa1 = fmma::tf32_a<S>(a, k0 + 8);
    fmma::Split<2> fb0[NB], fb1[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fb0[j] = fmma::tf32_b_t<S>(b, 8 * j, k0);
      fb1[j] = fmma::tf32_b_t<S>(b, 8 * j, k0 + 8);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fmma::mma_tf32(acc[j], fa0.small, fb0[j].big);
      fmma::mma_tf32(odd[j], fa1.small, fb1[j].big);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fmma::mma_tf32(acc[j], fa0.big, fb0[j].small);
      fmma::mma_tf32(odd[j], fa1.big, fb1[j].small);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fmma::mma_tf32(acc[j], fa0.big, fb0[j].big);
      fmma::mma_tf32(odd[j], fa1.big, fb1[j].big);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] += odd[j][c];
  }
}

template <int NB, int SW>
__device__ __forceinline__ void abt(float (&acc)[NB][4],
                                    const __nv_bfloat16* a,
                                    const __nv_bfloat16* b, int depth) {
  fmma::mma_abt<NB, kPartCols, SW>(acc, a, b, depth);
}

// x[j] += XA XB^T and y[j] += YA YB^T, as abt, in one walk over the first
// `depth` columns (the larger of the two products' depths: the tiles are
// zero past each one's own), so that both products' chains are in flight
// together; each sums in abt's order.
template <int NB, int SW>
__device__ __forceinline__ void abt2(float (&x)[NB][4], const float* xa,
                                     const float* xb, float (&y)[NB][4],
                                     const float* ya, const float* yb,
                                     int depth) {
  constexpr int S = fmma::stride<float, SW>();
  float x_odd[NB][4] = {}, y_odd[NB][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kPartCols; k0 += 16) {
    if (k0 >= depth) break;
    const fmma::Split<4> xa0 = fmma::tf32_a<S>(xa, k0);
    const fmma::Split<4> xa1 = fmma::tf32_a<S>(xa, k0 + 8);
    const fmma::Split<4> ya0 = fmma::tf32_a<S>(ya, k0);
    const fmma::Split<4> ya1 = fmma::tf32_a<S>(ya, k0 + 8);
    fmma::Split<2> xb0[NB], xb1[NB], yb0[NB], yb1[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      xb0[j] = fmma::tf32_b_t<S>(xb, 8 * j, k0);
      xb1[j] = fmma::tf32_b_t<S>(xb, 8 * j, k0 + 8);
      yb0[j] = fmma::tf32_b_t<S>(yb, 8 * j, k0);
      yb1[j] = fmma::tf32_b_t<S>(yb, 8 * j, k0 + 8);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fmma::mma_tf32(x[j], xa0.small, xb0[j].big);
      fmma::mma_tf32(x_odd[j], xa1.small, xb1[j].big);
      fmma::mma_tf32(y[j], ya0.small, yb0[j].big);
      fmma::mma_tf32(y_odd[j], ya1.small, yb1[j].big);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fmma::mma_tf32(x[j], xa0.big, xb0[j].small);
      fmma::mma_tf32(x_odd[j], xa1.big, xb1[j].small);
      fmma::mma_tf32(y[j], ya0.big, yb0[j].small);
      fmma::mma_tf32(y_odd[j], ya1.big, yb1[j].small);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fmma::mma_tf32(x[j], xa0.big, xb0[j].big);
      fmma::mma_tf32(x_odd[j], xa1.big, xb1[j].big);
      fmma::mma_tf32(y[j], ya0.big, yb0[j].big);
      fmma::mma_tf32(y_odd[j], ya1.big, yb1[j].big);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[j][c] += x_odd[j][c];
      y[j][c] += y_odd[j][c];
    }
  }
}

template <int NB, int SW>
__device__ __forceinline__ void abt2(float (&x)[NB][4],
                                     const __nv_bfloat16* xa,
                                     const __nv_bfloat16* xb,
                                     float (&y)[NB][4],
                                     const __nv_bfloat16* ya,
                                     const __nv_bfloat16* yb, int depth) {
  constexpr int S = fmma::stride<__nv_bfloat16, SW>();
  static_assert(NB % 2 == 0, "bf16 B fragments come in pairs of blocks");
#pragma unroll
  for (int k0 = 0; k0 < kPartCols; k0 += 16) {
    if (k0 >= depth) break;
    uint32_t fx[4], fy[4];
    fmma::bf16_a<S>(fx, xa, k0);
    fmma::bf16_a<S>(fy, ya, k0);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t bx[4], by[4];
      fmma::bf16_b_t<S>(bx, xb, 8 * j, k0);
      fmma::bf16_b_t<S>(by, yb, 8 * j, k0);
      fmma::mma_bf16(x[j], fx, bx[0], bx[1]);
      fmma::mma_bf16(y[j], fy, by[0], by[1]);
      fmma::mma_bf16(x[j + 1], fx, bx[2], bx[3]);
      fmma::mma_bf16(y[j + 1], fy, by[2], by[3]);
    }
  }
}

// ---- epilogue -------------------------------------------------------------

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

// Row r (0: g, 1: g + 8) of a warp's N C fragments times `scale` into
// `row`, its first `width` columns: the two columns of a block (2t, 2t + 1)
// in one store where the row is aligned for it.
template <typename T, int N>
__device__ __forceinline__ void store_row(T* row, const float (&acc)[N][4],
                                          int r, float scale, int width) {
  const int t = threadIdx.x % 4;
  const bool pairs = reinterpret_cast<uintptr_t>(row) % (2 * sizeof(T)) == 0;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int col = 8 * n + 2 * t;
    const float a = acc[n][2 * r] * scale, b = acc[n][2 * r + 1] * scale;
    if (pairs && col + 1 < width) {
      store2(row + col, a, b);
    } else {
      if (col < width) store1(row + col, a);
      if (col + 1 < width) store1(row + col + 1, b);
    }
  }
}

// ---- attributes -----------------------------------------------------------

// out[0..5]: hop::cluster_attrs of `kernel` at the plan's cluster, then the
// plan's parts, cluster and slice.
template <typename Kernel>
cudaError_t kernel_attrs(Kernel kernel, const Plan& plan, size_t smem,
                         int* out) {
  out[3] = plan.parts;
  out[4] = plan.cluster;
  out[5] = plan.slice;
  return hop::cluster_attrs(kernel, kThreads, plan.cluster, smem, out);
}

}  // namespace fwide
