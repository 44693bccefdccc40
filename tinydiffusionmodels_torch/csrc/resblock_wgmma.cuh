// The fused resblock's wgmma kernel (csrc/fused_resblock.cu's header says
// what it computes, its design and what bounds it): the kernel template,
// its launch and its attributes. Each instance (float and bf16 at 32, 64,
// 128 and 256 columns) is compiled in one of the fused_resblock_wgmma_*.cu
// files, two a file, so that nvcc builds them side by side (ptxas takes
// tens of seconds an instance); fused_resblock.cu calls them.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"
#include "hopper.cuh"
#include "resblock_common.cuh"

namespace tdm_resblock {

// Consumer warpgroups 0 and 1, the producer warpgroup 2.
constexpr int kWideThreads = 384;
constexpr int kConsumerThreads = 256;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kMaxKSteps = 4;  // k-steps a stage: 128 bytes of K / 32

// f32: two weight planes (3xTF32's big and small halves) and a second set
// of accumulators for a stage's partial sums.
template <typename T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int kPlanes = 2, kAccSets = 2;
};
template <>
struct Wide<__nv_bfloat16> {
  static constexpr int kPlanes = 1, kAccSets = 1;
};

// The 64-row m-tiles of a phase a consumer warpgroup holds at NC columns
// (NC / 2 its own): its accumulator sets within 128 registers a thread.
template <typename T, int NC>
__host__ __device__ constexpr int wide_mtiles() {
  return 512 / (NC * Wide<T>::kAccSets);
}

struct WideParams {
  const void* x;   // (batch, height / up, width / up, ca): x, or x_a
  const void* xb;  // (batch, height, width, cin - ca): x_b; null for one
  const void* b1;  // (cout)
  const void* tb;  // (batch, cout): time bias
  const void* b2;  // (cout)
  const void* bs;  // (cout): 1x1 skip's bias; null for the identity skip
  void* out;       // (batch, height, width, cout)
  int height, width, cin, ca, up;
  int vec;  // bytes per copy of x into shared memory (16, 8, 4; 2 for bf16)
  int cout, cin_pad, cout_pad;
  int tile, tiles_x, tiles_per_image;
  int ks;      // channels a weight stage (and an x chunk) holds
  int stages;  // weight stages in the ring
  int x_chunked;
};

// Shared memory (byte offsets from a 1024-byte aligned base, which takes
// up to 1024 bytes of the allocation): the ring of weight stages (each
// kPlanes planes of NC rows of KS channels), the x tile ((T + 4)^2 rows of
// all cin_pad channels, or two buffers of KS), the h tile ((T + 2)^2 rows
// of cout_pad), then the ring's full and empty barriers. ops/resblock.py
// `wgmma_smem_bytes` computes the same bytes.
template <typename T, int NC>
struct WideSmem {
  int atom, stage_bytes, x_edge, h_edge, xs_stride, hs_stride;
  int x_off, x_buf, h_off, bar_off;
  size_t bytes;
  __host__ __device__ explicit WideSmem(const WideParams& p)
      : atom(p.ks * int(sizeof(T))),
        stage_bytes(Wide<T>::kPlanes * NC * atom),
        x_edge(p.tile + 4),
        h_edge(p.tile + 2),
        xs_stride((p.x_chunked ? p.ks : p.cin_pad) + Mma<T>::kPad),
        hs_stride(p.cout_pad + Mma<T>::kPad) {
    x_off = p.stages * stage_bytes;
    x_buf = x_edge * x_edge * xs_stride;  // elements of one x buffer
    h_off = x_off + (p.x_chunked ? 2 : 1) * x_buf * int(sizeof(T));
    bar_off = h_off + h_edge * h_edge * hs_stride * int(sizeof(T));
    bytes = 1024 + size_t(bar_off) + 2 * size_t(p.stages) * 8;
  }
};

// The A rows a thread gathers for m-tile i of a phase with `rows` rows:
// bf16 one (ldmatrix's row lane % 16), f32 two (the TF32 fragment's g and
// g + 8), at their source positions; padding rows read the last row.
template <typename T, int MT>
__device__ __forceinline__ void a_rows(int (&pos)[MT][2], Phase ph, int rows,
                                       int tile) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 64 * i + 16 * warp +
                    (sizeof(T) == 4 ? lane / 4 + 8 * r : lane % 16);
      pos[i][r] = source_pos(ph, min(m, rows - 1), tile);
    }
  }
}

// One weight stage's products for the warpgroup's columns: for each k-step
// (up to `depth` channels) and each of the phase's mt m-tiles, A from
// `src` (row stride ss, rows pos + off, the stage's channels from column
// 0) and B at `desc` (f32: its small plane at `desc_small`). bf16 adds to
// acc; f32 sums the stage into part (zeroed by its first product) and then
// adds part to acc. `fresh`: the first stage of acc's sums, which it sets
// rather than adds to. The products of a k-step go in groups of up to
// kGroup m-tiles (f32: one), each gathered, issued as one wgmma group and
// waited for before the next is gathered: no product is in flight while
// registers are written, so ptxas keeps them in order without spilling,
// and the other consumer warpgroup's products fill the tensor cores in
// the gaps. Returns when the stage's products are done.
constexpr int kGroup = 4;

template <int MT, int R>
__device__ __forceinline__ void stage_products(
    float (&acc)[MT][R], float (&part)[MT][R], const __nv_bfloat16* src,
    int ss, const int (&pos)[MT][2], int off, int depth, int mt, bool fresh,
    uint64_t desc, uint64_t) {
  constexpr int G = MT < kGroup ? MT : kGroup;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < MT; ++i) hop::fence_operands(acc[i]);
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    if (ks * 16 >= depth) break;
#pragma unroll
    for (int i0 = 0; i0 < MT; i0 += G) {
      if (i0 >= mt) break;
      uint32_t a[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (i0 + g < mt) {
          fmma::ldsm_x4(a[g], src + (pos[i0 + g][0] + off) * ss + ks * 16 +
                                  (lane >> 4) * 8);
        }
      }
      hop::wgmma_fence();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (i0 + g < mt) {
          hop::wgmma_bf16(acc[i0 + g], a[g], desc + 2 * ks,
                          !fresh || ks > 0);
        }
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) hop::fence_operands(acc[i]);
}

template <int MT, int R>
__device__ __forceinline__ void stage_products(
    float (&acc)[MT][R], float (&part)[MT][R], const float* src, int ss,
    const int (&pos)[MT][2], int off, int depth, int mt, bool fresh,
    uint64_t desc, uint64_t desc_small) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) hop::fence_operands(part[i]);
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    if (ks * 8 >= depth) break;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mt) break;
      const float* p0 = src + (pos[i][0] + off) * ss + ks * 8 + t;
      const float* p1 = src + (pos[i][1] + off) * ss + ks * 8 + t;
      const float v[4] = {p0[0], p1[0], p0[4], p1[4]};
      const fmma::Split<4> a(v);
      hop::wgmma_fence();
      hop::wgmma_tf32(part[i], a.small, desc + 2 * ks, ks > 0);
      hop::wgmma_tf32(part[i], a.big, desc_small + 2 * ks, 1);
      hop::wgmma_tf32(part[i], a.big, desc + 2 * ks, 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    hop::fence_operands(part[i]);
    if (i < mt) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[i][r] = fresh ? part[i][r] : acc[i][r] + part[i][r];
      }
    }
  }
}

// The consumers' side of the weight ring: stage j's slot and phase.
struct RingReader {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;  // shared address of stage 0's columns of this warpgroup
  int stage_bytes, small_off, atom, stages, total;
  uint32_t cs;
  int j, s;
  uint32_t phase;

  // Waits for the next stage's weights; its descriptors (f32: the big and
  // the small plane).
  __device__ __forceinline__ void wait(uint64_t& big, uint64_t& small) {
    hop::mbar_wait(full + s, phase);
    const uint32_t at = base + s * stage_bytes;
    big = hop::desc_kmajor(at, atom);
    small = hop::desc_kmajor(at + small_off, atom);
  }

  // Releases it to every producer of the cluster, one arrival a warp (the
  // last `stages` are never waited for, so none arrives on a CTA that may
  // have finished).
  __device__ __forceinline__ void release() {
    if (threadIdx.x % 32 == 0 && j + stages < total) {
      if (cs == 1) {
        hop::mbar_arrive(empty + s);
      } else {
        for (uint32_t r = 0; r < cs; ++r) {
          hop::mbar_arrive_cluster(empty + s, r);
        }
      }
    }
    ++j;
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// The kernel at any width, on the plan's tile, stage channels, ring depth
// and cluster (a cluster of up to 4 along the grid; rank r multicasts rows
// [r NC / cs, (r + 1) NC / cs) of each stage). m1, m2, ms: TMA maps of the
// packed conv1, conv2 and skip weights (ms = m1 for the identity skip),
// 2D (K, rows), boxes of KS x NC / cs.
template <typename T, int NC>
__global__ void __launch_bounds__(kWideThreads, 1)
    fused_resblock_wgmma(const WideParams p,
                         const __grid_constant__ CUtensorMap m1,
                         const __grid_constant__ CUtensorMap m2,
                         const __grid_constant__ CUtensorMap ms) {
  constexpr int NW = NC / 2;  // a consumer warpgroup's columns
  constexpr int MT = wide_mtiles<T, NC>();
  constexpr int R = NW / 2;   // accumulator registers a thread a m-tile
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  unsigned char* smem =
      wide_smem + ((1024 - (hop::smem_u32(wide_smem) & 1023)) & 1023);
  const WideSmem<T, NC> L(p);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + p.stages;
  const uint32_t cs = hop::cluster_size();
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hop::mbar_init(full + s, 1);
      hop::mbar_init(empty + s, 8 * cs);  // every consumer warp of the cluster
    }
    hop::fence_mbar_init();
  }
  // Every barrier of the cluster is initialised before a copy or a remote
  // arrival reaches it.
  hop::cluster_sync();

  const bool skip = p.bs != nullptr;
  const int nk1 = (p.cin_pad + p.ks - 1) / p.ks;   // k-chunks of conv1, skip
  const int nk2 = (p.cout_pad + p.ks - 1) / p.ks;  // of conv2
  const int ncc = p.cout_pad / NC;                 // column chunks
  const int total = ncc * (9 * nk1 + 9 * nk2 + (skip ? nk1 : 0));

  if (threadIdx.x >= kConsumerThreads) {
    // The producer: one thread issues every stage's copies.
    hop::regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      const uint32_t rank = hop::cluster_rank();
      const int rows = NC / int(cs);  // this CTA's share of a stage's rows
      const uint16_t mask = uint16_t((1u << cs) - 1);
      int s = 0;
      uint32_t phase = 0;
      auto issue = [&](const CUtensorMap* map, int k0, int row0,
                       int plane_rows) {
        if (cs == 1) {
          hop::mbar_wait(empty + s, phase ^ 1);
        } else {
          hop::mbar_wait_cluster(empty + s, phase ^ 1);
        }
        hop::mbar_expect_tx(full + s, L.stage_bytes);
#pragma unroll
        for (int q = 0; q < Wide<T>::kPlanes; ++q) {
          unsigned char* dst = smem + s * L.stage_bytes + q * NC * L.atom +
                               int(rank) * rows * L.atom;
          const int row = row0 + q * plane_rows + int(rank) * rows;
          if (cs > 1) {
            hop::tma_load_multicast(dst, map, full + s, k0, row, mask);
          } else {
            hop::tma_load(dst, map, full + s, k0, row);
          }
        }
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      };
      const int taps_rows = 9 * p.cout_pad;  // rows of a plane of m1, m2
      for (int cc = 0; cc < ncc; ++cc) {
        for (int kc = 0; kc < nk1; ++kc) {
          for (int tap = 0; tap < 9; ++tap) {
            issue(&m1, kc * p.ks, tap * p.cout_pad + cc * NC, taps_rows);
          }
        }
      }
      for (int cc = 0; cc < ncc; ++cc) {
        for (int kc = 0; kc < nk2; ++kc) {
          for (int tap = 0; tap < 9; ++tap) {
            issue(&m2, kc * p.ks, tap * p.cout_pad + cc * NC, taps_rows);
          }
        }
        if (skip) {
          for (int kc = 0; kc < nk1; ++kc) {
            issue(&ms, kc * p.ks, cc * NC, p.cout_pad);
          }
        }
      }
    }
  } else {
    hop::regs_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;  // the column half
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int b = blockIdx.x / p.tiles_per_image;
    const int tile_id = blockIdx.x % p.tiles_per_image;
    const int y0 = (tile_id / p.tiles_x) * p.tile;
    const int x0 = (tile_id % p.tiles_x) * p.tile;
    const T* b1 = static_cast<const T*>(p.b1);
    const T* b2 = static_cast<const T*>(p.b2);
    const T* bs = static_cast<const T*>(p.bs);
    const int cout = p.cout;
    const T* tb = static_cast<const T*>(p.tb) + int64_t(b) * cout;
    T* out = static_cast<T*>(p.out);
    T* xs = reinterpret_cast<T*>(smem + L.x_off);
    T* hs = reinterpret_cast<T*>(smem + L.h_off);
    const int m1 = L.h_edge * L.h_edge, m2 = p.tile * p.tile;
    const int mt1 = (m1 + 63) / 64, mt2 = (m2 + 63) / 64;

    // x: whole, or chunk u % nk1 for its u-th use (conv1's, then the
    // skip's), each copied into buffer u % 2 one use ahead.
    const int uses = p.x_chunked ? ncc * nk1 * (skip ? 2 : 1) : 0;
    int use = 0;
    auto x_copy = [&](int u) {
      const int k0 = (u % nk1) * p.ks;
      load_sources(xs + (u & 1) * L.x_buf, p, b, L.x_edge, L.xs_stride, y0,
                   x0, k0, min(p.ks, p.cin_pad - k0));
      fmma::cp_async_commit();
    };
    // The x tile columns of k-chunk kc: in a chunked plan, the next use's
    // buffer once its copies have landed (issued a chunk before), after
    // which the buffer of the use before takes the next copy.
    auto x_chunk = [&](int kc) -> const T* {
      if (!p.x_chunked) return xs + kc * p.ks;
      fmma::cp_async_wait<0>();
      hop::bar_sync<kConsumerThreads>();
      if (use + 1 < uses) x_copy(use + 1);
      return xs + (use++ & 1) * L.x_buf;
    };
    if (p.x_chunked) {
      x_copy(0);
    } else {
      load_sources(xs, p, b, L.x_edge, L.xs_stride, y0, x0, 0, p.cin_pad);
      fmma::cp_async_commit();
      fmma::cp_async_wait<0>();
      hop::bar_sync<kConsumerThreads>();
    }

    float acc[MT][R], part[MT][R];
    int pos[MT][2];
    RingReader ring{full, empty, hop::smem_u32(smem) + wg * NW * L.atom,
                    L.stage_bytes, NC * L.atom, L.atom, p.stages, total, cs,
                    0, 0, 0};
    uint64_t big, small;

    // conv1, column chunk by column chunk, into the h tile. Accumulator
    // 4 n + 2 r + e of m-tile i is row 64 i + 16 warp + g + 8 r, column
    // cc NC + wg NW + 8 n + 2 t + e.
    a_rows<T>(pos, kConv1, m1, p.tile);
    for (int cc = 0; cc < ncc; ++cc) {
      for (int kc = 0; kc < nk1; ++kc) {
        const T* src = x_chunk(kc);
        const int depth = min(p.ks, p.cin_pad - kc * p.ks);
        for (int tap = 0; tap < 9; ++tap) {
          ring.wait(big, small);
          stage_products(acc, part, src, L.xs_stride, pos,
                         (tap / 3) * L.x_edge + tap % 3, depth, mt1,
                         kc == 0 && tap == 0, big, small);
          ring.release();
        }
      }
      const int col_base = cc * NC + wg * NW + 2 * t;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt1) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = 64 * i + 16 * warp + g + 8 * r;
          if (m >= m1) continue;
          const int gy = y0 - 1 + m / L.h_edge, gx = x0 - 1 + m % L.h_edge;
          const bool inside =
              gy >= 0 && gy < p.height && gx >= 0 && gx < p.width;
          T* row = hs + m * L.hs_stride;
#pragma unroll
          for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = col_base + 8 * n + e;
              const float v =
                  inside && col < cout
                      ? fmaxf(acc[i][4 * n + 2 * r + e] + to_f32(b1[col]),
                              0.f) + to_f32(tb[col])
                      : 0.f;
              row[col] = from_f32<T>(v);
            }
          }
        }
      }
    }
    hop::bar_sync<kConsumerThreads>();  // the h tile is whole

    // conv2 and the skip, column chunk by column chunk, to the output.
    for (int cc = 0; cc < ncc; ++cc) {
      a_rows<T>(pos, kConv2, m2, p.tile);
      for (int kc = 0; kc < nk2; ++kc) {
        const int depth = min(p.ks, p.cout_pad - kc * p.ks);
        for (int tap = 0; tap < 9; ++tap) {
          ring.wait(big, small);
          stage_products(acc, part, hs + kc * p.ks, L.hs_stride, pos,
                         (tap / 3) * L.h_edge + tap % 3, depth, mt2,
                         kc == 0 && tap == 0, big, small);
          ring.release();
        }
      }
      const int col_base = cc * NC + wg * NW + 2 * t;
      // relu(conv2 + b2), and the identity skip
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt2) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // The identity skip's x: the x tile's centre, or (x in chunks)
          // device memory.
          const int m = min(64 * i + 16 * warp + g + 8 * r, m2 - 1);
          const T* xrow = xs + source_pos(kSkip, m, p.tile) * L.xs_stride;
          const int gy = min(y0 + m / p.tile, p.height - 1);
          const int gx = min(x0 + m % p.tile, p.width - 1);
#pragma unroll
          for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = col_base + 8 * n + e;
              if (col >= cout) continue;
              float& a = acc[i][4 * n + 2 * r + e];
              a = fmaxf(a + to_f32(b2[col]), 0.f);
              if (!skip) {
                a += to_f32(p.x_chunked ? *x_addr<T>(p, b, gy, gx, col)
                                        : xrow[col]);
              }
            }
          }
        }
      }
      if (skip) {
        a_rows<T>(pos, kSkip, m2, p.tile);
        for (int kc = 0; kc < nk1; ++kc) {
          const T* src = x_chunk(kc);
          ring.wait(big, small);
          stage_products(acc, part, src, L.xs_stride, pos, 0,
                         min(p.ks, p.cin_pad - kc * p.ks), mt2, false, big,
                         small);
          ring.release();
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt2) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = 64 * i + 16 * warp + g + 8 * r;
          const int gy = y0 + m / p.tile, gx = x0 + m % p.tile;
          if (m >= m2 || gy >= p.height || gx >= p.width) continue;
          T* row = out + ((int64_t(b) * p.height + gy) * p.width + gx) * cout;
#pragma unroll
          for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = col_base + 8 * n + e;
              if (col >= cout) continue;
              float v = acc[i][4 * n + 2 * r + e];
              if (skip) v += to_f32(bs[col]);
              row[col] = from_f32<T>(v);
            }
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return EncodeTiled(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The TMA map of a packed weight: `rows` rows of k elements (k contiguous,
// k times the element size a multiple of 16 bytes), boxes of box_k x
// box_rows, swizzled to rows of box_k elements (128, 64 or 32 bytes).
template <typename T>
bool weight_map(CUtensorMap* map, const void* base, int k, int rows,
                int box_k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int atom = box_k * int(sizeof(T));
  const cuuint64_t dims[2] = {cuuint64_t(k), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(k) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(box_k), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                atom == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : atom == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma kernel at NC columns a chunk on a grid of `batch` x tiles CTAs
// in clusters of `cluster`; w1 (planes, 9, cout_pad, cin_pad), w2 (planes,
// 9, cout_pad, cout_pad), ws (planes, cout_pad, cin_pad) or null.
template <typename T, int NC>
cudaError_t launch_wide(const WideParams& p, const void* w1, const void* w2,
                        const void* ws, int batch, int cluster, size_t smem,
                        cudaStream_t stream) {
  if (WideSmem<T, NC>(p).bytes != smem || NC / cluster % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const int planes = Wide<T>::kPlanes, rows = NC / cluster;
  CUtensorMap maps[3];
  if (!weight_map<T>(&maps[0], w1, p.cin_pad, planes * 9 * p.cout_pad, p.ks,
                     rows) ||
      !weight_map<T>(&maps[1], w2, p.cout_pad, planes * 9 * p.cout_pad, p.ks,
                     rows) ||
      !weight_map<T>(&maps[2], ws ? ws : w1, p.cin_pad,
                     planes * (ws ? 1 : 9) * p.cout_pad, p.ks, rows)) {
    return cudaErrorInvalidValue;
  }
  return hop::launch_clusters(fused_resblock_wgmma<T, NC>,
                              (long long)batch * p.tiles_per_image,
                              kWideThreads, cluster, smem, stream, p, maps[0],
                              maps[1], maps[2]);
}

// The wgmma instance's registers and local (spill) bytes a thread, and how
// many clusters of `cluster` CTAs with `smem` bytes each the device holds
// at once.
template <typename T, int NC>
cudaError_t wide_attrs(size_t smem, int cluster, int* out) {
  return hop::cluster_attrs(fused_resblock_wgmma<T, NC>, kWideThreads,
                            cluster, smem, out);
}

// The instances: `TDM_WIDE_INSTANCE(extern, T, NC)` declares one (every
// file but the one that compiles it), `TDM_WIDE_INSTANCE(, T, NC)` compiles
// it.
#define TDM_WIDE_INSTANCE(KIND, T, NC)                                       \
  KIND template cudaError_t launch_wide<T, NC>(                             \
      const WideParams&, const void*, const void*, const void*, int, int,  \
      size_t, cudaStream_t);                                               \
  KIND template cudaError_t wide_attrs<T, NC>(size_t, int, int*);

TDM_WIDE_INSTANCE(extern, float, 32)
TDM_WIDE_INSTANCE(extern, float, 64)
TDM_WIDE_INSTANCE(extern, float, 128)
TDM_WIDE_INSTANCE(extern, float, 256)
TDM_WIDE_INSTANCE(extern, __nv_bfloat16, 32)
TDM_WIDE_INSTANCE(extern, __nv_bfloat16, 64)
TDM_WIDE_INSTANCE(extern, __nv_bfloat16, 128)
TDM_WIDE_INSTANCE(extern, __nv_bfloat16, 256)

}  // namespace tdm_resblock
