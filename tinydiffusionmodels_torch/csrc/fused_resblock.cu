// Fused UNet residual block for Hopper (sm_90a), f32 and bf16: an implicit
// GEMM on the tensor cores, at any Cin and Cout, from one input or from the
// channel concatenation of two.
//
// Replaces the TPU kernel `_resblock_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (driven by
// `_fused_resblock_impl` there), and the JAX package's concat-free decoder
// block `xla_ref.fused_resblock_split`. One launch computes the whole block
// on NHWC activations:
//
//   h   = relu(conv3x3(x) + b1) + time_bias, and 0 outside the image
//   out = relu(conv3x3(h) + b2) + skip(x)
//
// where skip is a 1x1 conv + bias, or the identity when there is no skip
// weight (Cin == Cout). conv3x3 is SAME-padded. The TPU kernel adds the time
// bias after the ReLU and then zeroes h outside the image, so conv2's padding
// reads 0 there and not time_bias; this kernel does the same. h never leaves
// shared memory. Every product accumulates in f32. In bf16 (every operand
// bf16), h is rounded to bf16 before conv2 and the output is written in bf16,
// where the TPU kernel rounds (`h.astype(x.dtype)`, the output's dtype).
//
// Two sources. x may be the concatenation cat(upsample(x_a, up), x_b) along
// channels, x_a at 1/up of the resolution (nearest neighbour). The kernel
// never builds it: the gather that stages the x tile reads channel c < Ca
// of pixel (y, x) from x_a at (y / up, x / up) and the rest from x_b, into
// the same shared-memory rows the concatenated tensor would fill. All that
// follows the gather is the same code, so the result is bit-equal to the
// launch on the materialised concat.
//
// Two kernels. A CTA owns an output tile of T x T pixels of one image: it
// stages the input tile with a 2-pixel halo (zeros outside the image and
// past Cin), computes h over the tile plus a 1-pixel halo into shared
// memory, then conv2 over the tile, adds the skip and writes the output.
// Each conv3x3 is a GEMM: M = the positions (h: (T + 2)^2, out: T^2), N =
// Cout padded to 32 (zero weight columns, whose h channels are relu(0) + 0
// = 0, so conv2 is unchanged; only the first Cout are written), K = 9 Cin
// taken tap by tap; A rows are tile positions shifted by the tap, gathered
// from shared memory (no im2col copy). The host plans which kernel, the
// tile and the layout (ops/resblock.py `plan`), so shared memory fits.
//
// `fused_resblock_kernel_narrow` (the UNet's plans: Cout 32 or 64, every
// channel in one stage, x whole, T 7 or 14): 8 warps of mma.sync, bf16 on
// m16n8k16 and f32 as 3xTF32 on m16n8k8 (flash_mma.cuh), the weights of
// one tap a stage staged by cp.async into a ring of three, one barrier a
// stage. Everything else runs
//
// `fused_resblock_wgmma` (design). 384 threads: two consumer warpgroups
// and a producer warpgroup, which gives its registers to the consumers
// (setmaxnreg: 40 against 232). The producer's one thread walks the CTA's
// weight stages in order: conv1's (column chunk of NC, k-chunk of KS input
// channels, tap), then for each column chunk conv2's and the 1x1 skip's;
// a stage is KS x NC weights of one tap, a TMA box from the wrapper's
// K-major packing (taps, Cout_pad, K), written with the 128-, 64- or
// 32-byte swizzle that wgmma's descriptor reads (KS = that many bytes of
// channels; hopper.cuh). It keeps the ring of 2-4 stages full: it waits on
// a stage's `empty` barrier, arms its `full` barrier with the stage's bytes
// and issues the copy. In a cluster of 2 or 4 CTAs (`plan(cluster=...)`)
// each CTA copies its share of the stage's rows and multicasts it to all,
// so a weight crosses from L2 once a cluster; the plan's clusters are of 1,
// since on the H100 clusters of 2 were 4-12 % slower (the cluster's
// lockstep release of every stage costs more than the L2 reads it saves).
// Each stage is used by all of the CTA's m-tiles before it is released, so
// each weight is read once a CTA a call. The consumers wait on the stage's
// `full` barrier (no barrier across the CTA), and warpgroup w takes the
// stage's columns [w NC / 2, (w + 1) NC / 2) for every 64-row m-tile of
// the phase (T = 8: h's 100 rows in 2, the output's 64 in 1): per k-step,
// the A fragments of up to 4 m-tiles (f32: one) are gathered into
// registers from the x or h tile (ldmatrix in bf16, scalar loads and the
// TF32 split in f32), then their wgmma m64nNk16 (bf16) or m64nNk8 (TF32)
// with B the stage go as one group, waited for before the next gather: no
// product is in flight while registers are written, so ptxas neither
// serializes the products nor spills, and the other warpgroup's products
// fill the tensor cores meanwhile. f32 is 3xTF32: A's big and small
// halves split in registers, B's two planes packed by the wrapper (big =
// w rounded to TF32, small = the rest rounded to TF32), three products
// (small big, big small, big big) a k-step; a stage's products sum into
// zeroed partials that are then added to the accumulators in f32 (the
// tensor cores' f32 accumulation truncates). bf16 accumulates on the
// tensor cores. Each consumer warp then arrives on the stage's `empty`
// barrier (in every CTA of the cluster). x is staged whole where it fits,
// else KS channels at a time in two buffers, each chunk copied (cp.async)
// one chunk ahead of its use. The epilogues act on the accumulators:
// relu(conv1 + b1) + time_bias, 0 outside the image, into the h tile;
// relu(conv2 + b2), then the 1x1 skip as more stages (A the tile's centre
// positions) or the identity, then the store. Rows of the x and h tiles
// are padded (4 floats, 8 bf16) so a warp's fragment loads hit distinct
// banks and bf16 rows start on 16 bytes.
//
// What bounds it. At B 8, 32 x 32, Cin = Cout = 256 the block does 19.3
// GFLOP against 21.5 MB (f32) of activations and weights: it is bound by
// operations. On the tensor cores the least time is that of the bf16
// products at 989 TFLOP/s, or of the f32 products as 3xTF32 (three TF32
// products each, at 495 TFLOP/s). This kernel pays on top: the conv1 halo
// recomputed by neighbouring tiles and the m-tiles' padding rows (at T = 8,
// 128 rows for conv1's 100 and 64 for the output's 64: 3 m-tiles for 2 of
// useful work), Cin padded to the k step and Cout to 32, the A gathers and
// (f32) their splits, the wait after each group of products, and a fixed
// cost a stage: clock64 stamps of one CTA on the H100 put a stage at about
// 2000 cycles, 1500 of them its products (both warpgroups, the tensor
// cores about 2/3 busy in bf16 and 1/2 in f32) and the rest the `full`
// barrier's wait (about 100), the release and the loop; each change of x
// chunk adds a barrier and the next chunk's copies. The weights come from
// L2, each once a CTA (once a cluster in clusters).

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"
#include "resblock_common.cuh"
#include "resblock_wgmma.cuh"

namespace {

using namespace tdm_resblock;

constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // weight stages in the narrow kernel's ring
constexpr int kMaxMt = 2;         // m-tiles of 16 rows per warp per pass
constexpr int kWarpCols = 32;     // output columns per warp
constexpr int kNb = kWarpCols / 8;

// The narrow kernel's parameters: those of the kernel before any width,
// then the second source. With these and a general plan's fields appended
// nvcc gave its one-source instance 17 % more instructions (7208 against
// 6136 in f32 at Cout 32, nvcc 12.9) and the UNet's blocks 10 % more time
// on the H100.
struct NarrowParams {
  const void* x;
  const void* w1;
  const void* b1;
  const void* tb;
  const void* w2;
  const void* b2;
  const void* ws;
  const void* bs;
  void* out;
  int height, width, cin, cin_pad;
  int tile, tiles_x, tiles_per_image;
  int vec;
  const void* xb;
  int ca, up;
};

// The narrow kernel's shared memory: the x tile ((T + 4)^2 rows of x_cols
// channels), the h tile ((T + 2)^2 rows of h_cols) and kStages stages of
// w_rows x NC weights. ops/resblock.py `narrow_smem_bytes` computes the
// same bytes.
template <typename T, int NC>
struct Smem {
  static constexpr int kWStride = NC + 8;  // weight rows: banks, 16 bytes
  int x_edge, h_edge, xs_stride, hs_stride, w_rows, hs_off, ring_off;
  size_t bytes;
  __host__ __device__ Smem(int tile, int x_cols, int h_cols, int rows)
      : x_edge(tile + 4),
        h_edge(tile + 2),
        xs_stride(x_cols + Mma<T>::kPad),
        hs_stride(h_cols + Mma<T>::kPad),
        w_rows(rows) {
    hs_off = x_edge * x_edge * xs_stride;
    ring_off = hs_off + h_edge * h_edge * hs_stride;
    bytes = sizeof(T) *
            (size_t(ring_off) + kStages * size_t(w_rows) * kWStride);
  }
};

// The narrow kernel's layout: x whole, the h tile of COUT channels, a tap's
// max(Cin, Cout) rows a stage.
template <typename T, int NC>
__host__ __device__ __forceinline__ Smem<T, NC> narrow_smem(
    const NarrowParams& p) {
  return Smem<T, NC>(p.tile, p.cin_pad, NC, p.cin_pad > NC ? p.cin_pad : NC);
}
// The narrow kernel's x tile from one source, image base xb: its 2-pixel
// halo, cin_pad channels per position, copies of V bytes; zeros outside
// the image and past Cin. Joins the open group.
template <typename T, int V, typename P>
__device__ __forceinline__ void load_one_v(T* xs, const T* xb, const P& p,
                                         int x_edge, int xs_stride, int y0,
                                         int x0) {
  constexpr int E = V / int(sizeof(T));
  const int chunks = p.cin_pad / E;
  const int n = x_edge * x_edge * chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pos = i / chunks, c = (i % chunks) * E;
    const int gy = y0 - 2 + pos / x_edge, gx = x0 - 2 + pos % x_edge;
    const bool inside = gy >= 0 && gy < p.height && gx >= 0 && gx < p.width;
    const int m = inside ? max(0, min(E, p.cin - c)) : 0;
    const T* src = m > 0 ? xb + (int64_t(gy) * p.width + gx) * p.cin + c : xb;
    T* dst = xs + pos * xs_stride + c;
    if constexpr (V == 2) {  // one bf16: no cp.async of 2 bytes
      *dst = m > 0 ? *src : fmma::zero<T>();
    } else {
      fmma::cp_async<V>(dst, src, m * int(sizeof(T)));
    }
  }
}

template <typename T, typename P>
__device__ __forceinline__ void load_one(T* xs, const T* xb, const P& p,
                                       int x_edge, int xs_stride, int y0,
                                       int x0) {
  switch (p.vec) {
    case 16: load_one_v<T, 16>(xs, xb, p, x_edge, xs_stride, y0, x0); break;
    case 8: load_one_v<T, 8>(xs, xb, p, x_edge, xs_stride, y0, x0); break;
    case 4: load_one_v<T, 4>(xs, xb, p, x_edge, xs_stride, y0, x0); break;
    default:
      if constexpr (sizeof(T) == 2) {
        load_one_v<T, 2>(xs, xb, p, x_edge, xs_stride, y0, x0);
      }
      break;
  }
}

// Rows [0, rows) of one tap's weights ((rows_in, COUT) row-major at `src`)
// into a ring stage; rows at or past rows_in are zeros. Joins the open group.
template <typename T, int COUT>
__device__ __forceinline__ void load_taps(T* dst, const T* src, int rows_in,
                                       int rows) {
  constexpr int E = 16 / int(sizeof(T));
  constexpr int kChunks = COUT / E;
  constexpr int WS = Smem<T, COUT>::kWStride;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * E;
    const bool in = r < rows_in;
    fmma::cp_async<16>(dst + r * WS + c, in ? src + r * COUT + c : src,
                       in ? 16 : 0);
  }
}

// part[i][n] += A B for the warp's `mts` m-tiles i and its kNb 8-column
// blocks n (columns n0 + 8 n), over k in [0, depth): A row r of m-tile i is
// the source tile's position pos[i][.] + off, channels k; B is a ring stage
// (k the row). f32: pos[i][0] and pos[i][1] are rows g and g + 8 (the TF32
// A fragment's); bf16: pos[i][0] is row lane % 16 (ldmatrix's).
template <int NC>
__device__ __forceinline__ void gemm(float (&part)[kMaxMt][kNb][4],
                                     const float* src, int ss,
                                     const int (&pos)[kMaxMt][2], int mts,
                                     int off, const float* w, int n0,
                                     int depth) {
  constexpr int WS = Smem<float, NC>::kWStride;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int k0 = 0; k0 < depth; k0 += 8) {
    fmma::Split<2> fb[kNb];
#pragma unroll
    for (int n = 0; n < kNb; ++n) {
      const float* pb = w + (k0 + t) * WS + n0 + 8 * n + g;
      const float b[2] = {pb[0], pb[4 * WS]};
      fb[n] = fmma::Split<2>(b);
    }
#pragma unroll
    for (int i = 0; i < kMaxMt; ++i) {
      if (i < mts) {
        const float* p0 = src + (pos[i][0] + off) * ss + k0 + t;
        const float* p1 = src + (pos[i][1] + off) * ss + k0 + t;
        const float a[4] = {p0[0], p1[0], p0[4], p1[4]};
        fmma::mma_3xtf32<kNb>(part[i], fmma::Split<4>(a), fb);
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void gemm(float (&part)[kMaxMt][kNb][4],
                                     const __nv_bfloat16* src, int ss,
                                     const int (&pos)[kMaxMt][2], int mts,
                                     int off, const __nv_bfloat16* w, int n0,
                                     int depth) {
  constexpr int WS = Smem<__nv_bfloat16, NC>::kWStride;
  const int lane = threadIdx.x % 32;
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t fa[kMaxMt][4];
#pragma unroll
    for (int i = 0; i < kMaxMt; ++i) {
      if (i < mts) {
        fmma::ldsm_x4(fa[i], src + (pos[i][0] + off) * ss + k0 + (lane >> 4) * 8);
      }
    }
#pragma unroll
    for (int n = 0; n < kNb; n += 2) {
      uint32_t fb[4];
      fmma::bf16_b<WS>(fb, w, k0, n0 + 8 * n);
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        if (i < mts) {
          fmma::mma_bf16(part[i][n], fa[i], fb[0], fb[1]);
          fmma::mma_bf16(part[i][n + 1], fa[i], fb[2], fb[3]);
        }
      }
    }
  }
}

// The UNet's blocks: Cout the instance's 32 or 64 columns, every channel
// in one k-chunk, x whole, one job a tap; kTwo: x from two sources. Its
// one-source instance is the kernel as it was before any width, with its
// parameters (NarrowParams) and its gather. The wgmma kernel, run at these
// plans on the H100, was faster at no block at every batch in both dtypes
// (at these widths each of its weight stages carries little work, and a
// stage's fixed cost dominates), so these plans stay on this kernel
// (resblock_tile_ab --kernels times both).
template <typename T, int COUT, bool kTwo>
__global__ void __launch_bounds__(kThreads, 2)
    fused_resblock_kernel_narrow(const NarrowParams p) {
  constexpr int kGroups = COUT / kWarpCols;  // column groups of the CTA
  constexpr int kWpg = kWarps / kGroups;     // warps per column group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T, COUT> L = narrow_smem<T, COUT>(p);
  constexpr int WS = Smem<T, COUT>::kWStride;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* hs = xs + L.hs_off;
  T* ring = xs + L.ring_off;

  const int b = blockIdx.x / p.tiles_per_image;
  const int tile_id = blockIdx.x % p.tiles_per_image;
  const int y0 = (tile_id / p.tiles_x) * p.tile;
  const int x0 = (tile_id % p.tiles_x) * p.tile;
  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* ws = static_cast<const T*>(p.ws);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* b2 = static_cast<const T*>(p.b2);
  const T* bs = static_cast<const T*>(p.bs);
  const T* tb = static_cast<const T*>(p.tb) + int64_t(b) * COUT;
  T* out = static_cast<T*>(p.out);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = (warp / kWpg) * kWarpCols;  // the warp's output columns
  const int wm = warp % kWpg;                // its place in the group

  // Jobs, one per stage of weights: conv1 by passes of up to kWpg kMaxMt
  // m-tiles, 9 taps each; then conv2 likewise, 9 taps and the skip each.
  const int m1 = L.h_edge * L.h_edge, m2 = p.tile * p.tile;
  const int per_pass = kWpg * kMaxMt;
  const int passes1 = ((m1 + 15) / 16 + per_pass - 1) / per_pass;
  const int passes2 = ((m2 + 15) / 16 + per_pass - 1) / per_pass;
  const bool has_skip = ws != nullptr;
  const int steps2 = 9 + (has_skip ? 1 : 0);
  const int jobs1 = passes1 * 9;
  const int jobs = jobs1 + passes2 * steps2;

  auto issue = [&](int j) {
    T* dst = ring + (j % kStages) * L.w_rows * WS;
    if (j < jobs1) {
      load_taps<T, COUT>(dst, w1 + (j % 9) * p.cin * COUT, p.cin, p.cin_pad);
    } else {
      const int step = (j - jobs1) % steps2;
      if (step < 9) {
        load_taps<T, COUT>(dst, w2 + step * COUT * COUT, COUT, COUT);
      } else {
        load_taps<T, COUT>(dst, ws, p.cin, p.cin_pad);
      }
    }
  };
  // Prologue: the x tile and the first kStages - 1 jobs' weights, one
  // group each (the x tile joins the first).
  if constexpr (kTwo) {
    load_sources(xs, p, b, L.x_edge, L.xs_stride, y0, x0, 0, p.cin_pad);
  } else {
    load_one(xs, x + int64_t(b) * p.height * p.width * p.cin, p, L.x_edge,
             L.xs_stride, y0, x0);
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < jobs) issue(j);
    fmma::cp_async_commit();
  }

  float acc[kMaxMt][kNb][4];
  int tiles[kMaxMt];  // the warp's m-tiles in this pass
  int mts = 0;
  for (int j = 0; j < jobs; ++j) {
    // Job j's weights have landed, every thread sees them, and every thread
    // is done with job j - 1, whose stage is refilled with job
    // j + kStages - 1's (an empty group past the last, so that the count of
    // groups in flight stays kStages - 2 at the wait).
    fmma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < jobs) issue(j + kStages - 1);
    fmma::cp_async_commit();
    const bool conv1 = j < jobs1;
    const int jj = conv1 ? j : j - jobs1;
    const int per = conv1 ? 9 : steps2;
    const int pass = jj / per, step = jj % per;
    const int rows = conv1 ? m1 : m2;
    if (step == 0) {
      mts = 0;
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        tiles[i] = pass * per_pass + wm + i * kWpg;
        if (tiles[i] * 16 < rows) mts = i + 1;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
        }
      }
    }
    const Phase ph = conv1 ? kConv1 : step < 9 ? kConv2 : kSkip;
    int pos[kMaxMt][2];
#pragma unroll
    for (int i = 0; i < kMaxMt; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tiles[i] * 16 +
                      (sizeof(T) == 4 ? g + 8 * r : lane % 16);
        pos[i][r] = source_pos(ph, min(m, rows - 1), p.tile);
      }
    }
    const T* w = ring + (j % kStages) * L.w_rows * WS;
    float part[kMaxMt][kNb][4] = {};
    if (mts > 0) {
      if (ph == kConv2) {
        const int off = (step / 3) * L.h_edge + step % 3;
        gemm<COUT>(part, hs, L.hs_stride, pos, mts, off, w, n0, COUT);
      } else {
        const int off = ph == kConv1 ? (step / 3) * L.x_edge + step % 3 : 0;
        gemm<COUT>(part, xs, L.xs_stride, pos, mts, off, w, n0, p.cin_pad);
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxMt; ++i) {
#pragma unroll
      for (int n = 0; n < kNb; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][n][c] += part[i][n][c];
      }
    }

    // Epilogues on the C fragments: element c of block n of m-tile i is
    // row tiles[i] 16 + g + 8 (c / 2), column n0 + 8 n + 2 t + c % 2.
    if (conv1 && step == 8) {
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        if (i >= mts) break;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = tiles[i] * 16 + g + 8 * (c / 2);
            if (m >= m1) continue;
            const int col = n0 + 8 * n + 2 * t + c % 2;
            const int gy = y0 - 1 + m / L.h_edge, gx = x0 - 1 + m % L.h_edge;
            const bool inside =
                gy >= 0 && gy < p.height && gx >= 0 && gx < p.width;
            const float v = fmaxf(acc[i][n][c] + to_f32(b1[col]), 0.f) +
                            to_f32(tb[col]);
            hs[m * L.hs_stride + col] = from_f32<T>(inside ? v : 0.f);
          }
        }
      }
    }
    if (!conv1 && step == 8) {  // relu(conv2 + b2), and the identity skip
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = n0 + 8 * n + 2 * t + c % 2;
            float v = fmaxf(acc[i][n][c] + to_f32(b2[col]), 0.f);
            if (!has_skip) {
              const int m = min(tiles[i] * 16 + g + 8 * (c / 2), m2 - 1);
              v += to_f32(xs[source_pos(kSkip, m, p.tile) * L.xs_stride + col]);
            }
            acc[i][n][c] = v;
          }
        }
      }
    }
    if (!conv1 && step == steps2 - 1) {  // after the skip GEMM: store
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        if (i >= mts) break;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = tiles[i] * 16 + g + 8 * (c / 2);
            const int gy = y0 + m / p.tile, gx = x0 + m % p.tile;
            if (m >= m2 || gy >= p.height || gx >= p.width) continue;
            const int col = n0 + 8 * n + 2 * t + c % 2;
            float v = acc[i][n][c];
            if (has_skip) v += to_f32(bs[col]);
            out[((int64_t(b) * p.height + gy) * p.width + gx) * COUT + col] =
                from_f32<T>(v);
          }
        }
      }
    }
  }
}

// The narrow kernel at Cout = COUT; the host's plan and the kernel's layout
// must agree on the bytes.
template <typename T, int COUT>
cudaError_t launch_narrow(const NarrowParams& p, int batch, size_t smem,
                          cudaStream_t stream) {
  if (narrow_smem<T, COUT>(p).bytes != smem) return cudaErrorInvalidValue;
  const auto kernel = p.xb ? fused_resblock_kernel_narrow<T, COUT, true>
                           : fused_resblock_kernel_narrow<T, COUT, false>;
  const cudaError_t attr = hop::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)batch * p.tiles_per_image;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_nc(const WideParams& p, const void* w1,
                           const void* w2, const void* ws, int batch, int nc,
                           int cluster, size_t smem, cudaStream_t stream) {
  switch (nc) {
    case 32:
      return launch_wide<T, 32>(p, w1, w2, ws, batch, cluster, smem, stream);
    case 64:
      return launch_wide<T, 64>(p, w1, w2, ws, batch, cluster, smem, stream);
    case 128:
      return launch_wide<T, 128>(p, w1, w2, ws, batch, cluster, smem, stream);
    case 256:
      return launch_wide<T, 256>(p, w1, w2, ws, batch, cluster, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_inputs(int dtype, int batch, int height, int width, int cin, int ca,
                int up, int cout, int tile, const void* xb, const void* ws,
                const void* bs, int vec, long long smem) {
  const int min_vec = dtype == 1 ? 2 : 4;
  const bool one = xb == nullptr;
  return batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
         tile <= 0 || up <= 0 || (dtype != 0 && dtype != 1) ||
         (one && (ca != cin || up != 1)) ||
         (!one && (ca <= 0 || ca >= cin || height % up || width % up)) ||
         (ws == nullptr && cin != cout) ||
         ((ws == nullptr) != (bs == nullptr)) || vec < min_vec || vec > 16 ||
         (vec & (vec - 1)) != 0 || smem <= 0;
}

}  // namespace

// One launch of the block on `stream`, by the narrow kernel (Cout 32 or
// 64, every channel in one stage, x whole; the UNet's plans) or by the
// wgmma kernel (any plan of ops/resblock.py `plan`). dtype: 0 = float32,
// 1 = bfloat16, every pointer an array of that dtype. One source: xb null,
// ca == cin, up == 1. Two sources: the block's input is cat(upsample(x,
// up), xb) along channels, x with ca channels at 1/up of height and width
// (which up divides), xb with cin - ca at full size. b1, b2, bs (cout), tb
// (batch, cout); ws and bs are null for the identity skip (then cin must
// equal cout). `tile` is the output tile edge, `smem` the dynamic
// shared-memory bytes, which must equal the kernel's layout's. vec: bytes
// per copy of x into shared memory (16, 8, 4; 2 for bf16 only), which both
// sources' addresses and ca and cin - ca times the element size must be
// multiples of. Each returns the cudaError_t of the launch (0 on success),
// including a refusal of the shared-memory size; neither allocates.
//
// Narrow: w1 (9, cin, cout), w2 (9, cout, cout), ws (cin, cout), tap-major.
extern "C" int tdm_fused_resblock_narrow(
    const void* x, const void* xb, const void* w1, const void* b1,
    const void* tb, const void* w2, const void* b2, const void* ws,
    const void* bs, void* out, int dtype, int batch, int height, int width,
    int cin, int ca, int up, int cout, int tile, int vec, long long smem,
    void* stream) {
  if (bad_inputs(dtype, batch, height, width, cin, ca, up, cout, tile, xb, ws,
                 bs, vec, smem) ||
      (cout != 32 && cout != 64)) {
    return int(cudaErrorInvalidValue);
  }
  const int step = dtype == 1 ? 16 : 8;
  NarrowParams p{x, w1, b1, tb, w2, b2, ws, bs, out, height, width, cin,
                 (cin + step - 1) / step * step, tile, (width + tile - 1) / tile,
                 0, vec, xb, ca, up};
  p.tiles_per_image = p.tiles_x * ((height + tile - 1) / tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = size_t(smem);
  cudaError_t err;
  if (dtype == 0) {
    err = cout == 32 ? launch_narrow<float, 32>(p, batch, bytes, s)
                     : launch_narrow<float, 64>(p, batch, bytes, s);
  } else {
    err = cout == 32 ? launch_narrow<__nv_bfloat16, 32>(p, batch, bytes, s)
                     : launch_narrow<__nv_bfloat16, 64>(p, batch, bytes, s);
  }
  return int(err);
}

// wgmma: w1, w2, ws packed K-major in `planes` planes (f32: 2, the TF32
// big and small halves; bf16: 1): w1 (planes, 9, cout_pad, cin_pad), w2
// (planes, 9, cout_pad, cout_pad), ws (planes, cout_pad, cin_pad), cin_pad
// Cin rounded up to the k step (8 f32, 16 bf16), cout_pad Cout to 32, zeros
// past Cin and Cout. The plan: `ks` channels a weight stage (128, 64 or 32
// bytes of them), `stages` in the ring, x whole or chunked (`x_chunked`,
// ks channels at a time), `nc` columns a chunk (32, 64, 128 or 256,
// dividing cout_pad), clusters of `cluster` CTAs (1, 2 or 4, dividing the
// grid of batch x tiles).
extern "C" int tdm_fused_resblock_wgmma(
    const void* x, const void* xb, const void* w1, const void* b1,
    const void* tb, const void* w2, const void* b2, const void* ws,
    const void* bs, void* out, int dtype, int batch, int height, int width,
    int cin, int ca, int up, int cout, int tile, int ks, int stages,
    int x_chunked, int nc, int cluster, int vec, long long smem,
    void* stream) {
  const int size = dtype == 1 ? 2 : 4;
  const int atom = ks * size;
  if (bad_inputs(dtype, batch, height, width, cin, ca, up, cout, tile, xb, ws,
                 bs, vec, smem) ||
      (atom != 32 && atom != 64 && atom != 128) || stages < 1 ||
      stages > 8 || (cluster != 1 && cluster != 2 && cluster != 4)) {
    return int(cudaErrorInvalidValue);
  }
  const int step = dtype == 1 ? 16 : 8;
  WideParams p;
  p.x = x;
  p.xb = xb;
  p.b1 = b1;
  p.tb = tb;
  p.b2 = b2;
  p.bs = bs;
  p.out = out;
  p.height = height;
  p.width = width;
  p.cin = cin;
  p.ca = ca;
  p.up = up;
  p.vec = vec;
  p.cout = cout;
  p.cin_pad = (cin + step - 1) / step * step;
  p.cout_pad = (cout + 31) / 32 * 32;
  p.tile = tile;
  p.tiles_x = (width + tile - 1) / tile;
  p.tiles_per_image = p.tiles_x * ((height + tile - 1) / tile);
  p.ks = ks;
  p.stages = stages;
  p.x_chunked = x_chunked;
  if (p.cout_pad % nc != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_wide_nc<float>(p, w1, w2, ws, batch, nc, cluster,
                                         size_t(smem), s)
                 : launch_wide_nc<__nv_bfloat16>(p, w1, w2, ws, batch, nc,
                                                 cluster, size_t(smem), s);
  return int(err);
}

// out[0] registers a thread, out[1] local (spill) bytes a thread of the
// wgmma instance (dtype, nc), out[2] the clusters of `cluster` CTAs with
// `smem` bytes of shared memory each that the device holds at once.
extern "C" int tdm_fused_resblock_wgmma_attrs(int dtype, int nc,
                                              long long smem, int cluster,
                                              int* out) {
  const size_t bytes = size_t(smem);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dtype * 1000 + nc) {
    case 32: err = wide_attrs<float, 32>(bytes, cluster, out); break;
    case 64: err = wide_attrs<float, 64>(bytes, cluster, out); break;
    case 128: err = wide_attrs<float, 128>(bytes, cluster, out); break;
    case 256: err = wide_attrs<float, 256>(bytes, cluster, out); break;
    case 1032: err = wide_attrs<__nv_bfloat16, 32>(bytes, cluster, out); break;
    case 1064: err = wide_attrs<__nv_bfloat16, 64>(bytes, cluster, out); break;
    case 1128: err = wide_attrs<__nv_bfloat16, 128>(bytes, cluster, out); break;
    case 1256: err = wide_attrs<__nv_bfloat16, 256>(bytes, cluster, out); break;
    default: break;
  }
  return int(err);
}
