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
// Design. One CTA of 256 threads (8 warps) per (image, output tile of T x T
// pixels). The host plans T, the k-chunk KC and whether x is staged whole
// or KC channels at a time (ops/resblock.py `plan`), so that the x tile
// (with its 2-pixel halo), the h tile (T + 2)^2 x Cout and the weight ring
// fit the 227 KB of shared memory; at the MNIST UNet's blocks the plan is
// one k-chunk, x whole and T = 14 from 100 CTAs, else 7. The CTA stages the
// input tile by cp.async (zeros outside the image and in the channels past
// Cin up to the k step), computes h over the tile plus a 1-pixel halo into
// shared memory, then conv2 over the tile, adds the skip and writes the
// output. Each conv3x3 is a GEMM: M = the positions (h: (T + 2)^2, out: T^2,
// in m-tiles of 16 rows), N = Cout padded to 32 (zero weight columns, whose
// h channels are relu(0) + 0 = 0, so conv2 is unchanged; only the first
// Cout are written), K = 9 Cin taken tap by tap and KC rows at a time. The
// output columns go NC at a time (NC = 32, 64, 128 or 256, the instance's
// template width), a warp owning 32 of them and up to two m-tiles per pass
// (more passes for larger tiles); its A fragments are gathered per tap from
// the tile in shared memory (rows are positions shifted by the tap, so no
// im2col copy), by ldmatrix in bf16 and by scalar loads in f32. Each job's
// weights (KC x NC of one tap, from the wrapper's (9, Cin, Cout_pad)
// packing) are staged by cp.async into a ring of three stages, two jobs
// ahead of the products, with one barrier per job. When x is staged in
// chunks, a job whose chunk differs from the one in shared memory first
// reloads it (and waits for it), and the identity skip reads x from device
// memory. Products run on mma.sync: bf16 on m16n8k16, f32 as 3xTF32 on
// m16n8k8 (flash_mma.cuh), which keeps float32's accuracy; each job's
// products sum into zeroed fragments that are then added in f32 (the tensor
// cores' f32 accumulation truncates). The epilogues act on the C
// fragments: relu(conv1 + b1) + time_bias, zeroed outside the image, into
// the h tile; relu(conv2 + b2), then the 1x1 skip as more GEMM steps
// (K = Cin, A the tile's centre positions) or the identity, then the store.
// Rows are padded (4 floats, 8 bf16) so fragment loads hit distinct banks
// and bf16 rows start on 16 bytes.
//
// Two kernels. Where Cout is 32 or 64 and the plan is one k-chunk of every
// channel with x whole (the UNet's blocks), `fused_resblock_kernel_narrow`
// runs: one job a tap, Cout a template constant, its one-source instance
// the code of the kernel before any width. Everything else runs
// `fused_resblock_kernel`, whose jobs follow the plan.
//
// What bounds it. The block does ~130 MFLOP per image for the four blocks of
// the UNet, against ~3 MB of activations moved at the sampler's batch of 25:
// it is bound by operations. On the tensor cores the least time is that of
// the bf16 products at 989 TFLOP/s, or of the f32 products as 3xTF32 (three
// TF32 products each, at 495 TFLOP/s). This kernel pays on top: the conv1
// halo recomputed by neighbouring tiles (1.65x the conv1 work at T = 7, more
// at the small tiles of wide blocks), the m-tiles' padding rows (81 -> 96
// and 49 -> 64 at T = 7), Cin padded to the k step and Cout to 32, the A
// gathers and the operand splits of 3xTF32 on the FMA and load pipes, and
// mma.sync, which reaches only part of Hopper's tensor-core rate.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // weight stages in the ring
constexpr int kMaxMt = 2;         // m-tiles of 16 rows per warp per pass
constexpr int kWarpCols = 32;     // output columns per warp
constexpr int kNb = kWarpCols / 8;

// The k step of one mma (TF32 m16n8k8, bf16 m16n8k16), which channel
// counts are padded to with zeros, and the padding of a shared-memory row.
template <typename T>
struct Mma;
template <>
struct Mma<float> {
  static constexpr int kStep = 8, kPad = 4;
};
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kStep = 16, kPad = 8;
};

struct Params {
  const void* x;   // (batch, height / up, width / up, ca): x, or x_a
  const void* w1;  // (9, cin, cout_pad): conv1, taps in (ky, kx) order
  const void* b1;  // (cout)
  const void* tb;  // (batch, cout): time bias
  const void* w2;  // (9, cout, cout_pad)
  const void* b2;  // (cout)
  const void* ws;  // (cin, cout_pad): 1x1 skip; null for the identity skip
  const void* bs;  // (cout), with ws
  void* out;       // (batch, height, width, cout)
  int height, width, cin, cin_pad;
  int tile, tiles_x, tiles_per_image;
  int vec;  // bytes per copy of x into shared memory (16, 8, 4; 2 for bf16)
  const void* xb;  // (batch, height, width, cin - ca): x_b; null for one
  int ca, up, cout, cout_pad;
  int kc;         // k-chunk: weight rows a job, x channels a stage
  int x_chunked;  // x staged kc channels at a time (else all cin_pad)
};

// The narrow kernel's parameters: Params up to vec, then the second
// source. With all of Params (the plan's fields after xb) nvcc gave its
// one-source instance 17 % more instructions (7208 against 6136 in f32 at
// Cout 32, nvcc 12.9) and the UNet's blocks 10 % more time on the H100.
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

// Shared memory: the x tile ((T + 4)^2 rows of x_cols channels), the h
// tile ((T + 2)^2 rows of h_cols) and kStages stages of w_rows x NC
// weights. ops/resblock.py `plan` computes the same bytes.
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
// max(Cin, Cout) rows a stage; the general one's: the plan's.
template <typename T, int NC>
__host__ __device__ __forceinline__ Smem<T, NC> narrow_smem(
    const NarrowParams& p) {
  return Smem<T, NC>(p.tile, p.cin_pad, NC, p.cin_pad > NC ? p.cin_pad : NC);
}
template <typename T, int NC>
__host__ __device__ __forceinline__ Smem<T, NC> plan_smem(const Params& p) {
  return Smem<T, NC>(p.tile, p.x_chunked ? p.kc : p.cin_pad, p.cout_pad,
                     p.kc);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The address of channel c of pixel (gy, gx) of image b of the block's
// input: x_a at (gy / up, gx / up) below ca, else x_b.
template <typename T>
__device__ __forceinline__ const T* x_addr(const Params& p, int b, int gy,
                                           int gx, int c) {
  if (c < p.ca) {
    if (p.up == 1) {
      return static_cast<const T*>(p.x) +
             ((int64_t(b) * p.height + gy) * p.width + gx) * p.ca + c;
    }
    const int h = p.height / p.up, w = p.width / p.up;
    return static_cast<const T*>(p.x) +
           ((int64_t(b) * h + gy / p.up) * w + gx / p.up) * p.ca + c;
  }
  const int cb = p.cin - p.ca;
  return static_cast<const T*>(p.xb) +
         ((int64_t(b) * p.height + gy) * p.width + gx) * cb + (c - p.ca);
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

// Channels [lo, hi) of the block's input over the x tile with its 2-pixel
// halo, into x-tile columns [lo - c0, hi - c0), copies of V bytes, from one
// source: `img` holds channels [s0, s0 + cs) of the input for one image at
// 1/UP of its resolution (UP 0: at 1/up). Zeros outside the image and past
// Cin. Joins the open group. lo, hi and s0 are multiples of E.
template <typename T, int V, int UP, typename P>
__device__ __forceinline__ void load_src(T* xs, const T* img, int cs, int s0,
                                         int up, const P& p, int x_edge,
                                         int xs_stride, int y0, int x0,
                                         int c0, int lo, int hi) {
  constexpr int E = V / int(sizeof(T));
  const int f = UP > 0 ? UP : up;
  const int sw = p.width / f;
  const int chunks = (hi - lo) / E;
  const int n = x_edge * x_edge * chunks;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int pos = i / chunks, c = lo + (i % chunks) * E;
    const int gy = y0 - 2 + pos / x_edge, gx = x0 - 2 + pos % x_edge;
    const bool inside = gy >= 0 && gy < p.height && gx >= 0 && gx < p.width;
    const int m = inside ? max(0, min(E, s0 + cs - c)) : 0;
    const T* src =
        m > 0 ? img + (int64_t(gy / f) * sw + gx / f) * cs + (c - s0) : img;
    T* dst = xs + pos * xs_stride + (c - c0);
    if constexpr (V == 2) {  // one bf16: no cp.async of 2 bytes
      *dst = m > 0 ? *src : fmma::zero<T>();
    } else {
      fmma::cp_async<V>(dst, src, m * int(sizeof(T)));
    }
  }
}

template <typename T, int UP, typename P>
__device__ __forceinline__ void load_src_v(T* xs, const T* img, int cs,
                                           int s0, const P& p,
                                           int x_edge, int xs_stride, int y0,
                                           int x0, int c0, int lo, int hi) {
  switch (p.vec) {
    case 16:
      load_src<T, 16, UP>(xs, img, cs, s0, p.up, p, x_edge, xs_stride, y0, x0,
                          c0, lo, hi);
      break;
    case 8:
      load_src<T, 8, UP>(xs, img, cs, s0, p.up, p, x_edge, xs_stride, y0, x0,
                         c0, lo, hi);
      break;
    case 4:
      load_src<T, 4, UP>(xs, img, cs, s0, p.up, p, x_edge, xs_stride, y0, x0,
                         c0, lo, hi);
      break;
    default:
      if constexpr (sizeof(T) == 2) {
        load_src<T, 2, UP>(xs, img, cs, s0, p.up, p, x_edge, xs_stride, y0,
                           x0, c0, lo, hi);
      }
      break;
  }
}

// Channels [c0, c0 + cols) of the x tile of image b: from x alone, or
// those below Ca from x_a (at 1/up of the resolution: up 1, 2 or any) and
// the rest from x_b. A copy never straddles the two sources: V divides Ca
// times the element size.
template <typename T, typename P>
__device__ __forceinline__ void load_sources(T* xs, const P& p, int b,
                                       int x_edge, int xs_stride, int y0,
                                       int x0, int c0, int cols) {
  const int hi = c0 + cols;
  const int64_t pixels = int64_t(p.height) * p.width;
  const T* xa = static_cast<const T*>(p.x) + b * pixels / (p.up * p.up) * p.ca;
  if (p.xb == nullptr) {
    load_src_v<T, 1>(xs, xa, p.cin, 0, p, x_edge, xs_stride, y0, x0, c0, c0,
                     hi);
    return;
  }
  if (c0 < p.ca) {
    const int top = min(hi, p.ca);
    switch (p.up) {
      case 1:
        load_src_v<T, 1>(xs, xa, p.ca, 0, p, x_edge, xs_stride, y0, x0, c0,
                         c0, top);
        break;
      case 2:
        load_src_v<T, 2>(xs, xa, p.ca, 0, p, x_edge, xs_stride, y0, x0, c0,
                         c0, top);
        break;
      default:
        load_src_v<T, 0>(xs, xa, p.ca, 0, p, x_edge, xs_stride, y0, x0, c0,
                         c0, top);
        break;
    }
  }
  if (hi > p.ca) {
    const int cb = p.cin - p.ca;
    load_src_v<T, 1>(xs, static_cast<const T*>(p.xb) + b * pixels * cb, cb,
                     p.ca, p, x_edge, xs_stride, y0, x0, c0, max(c0, p.ca),
                     hi);
  }
}

// Rows [0, rows) of NC columns of a weight matrix (row stride ld, starting
// at `src`) into a ring stage; rows at or past rows_in are zeros (their
// copies read nothing, at `base`). Joins the open group.
template <typename T, int NC>
__device__ __forceinline__ void load_w(T* dst, const T* src, const T* base,
                                       int ld, int rows_in, int rows) {
  constexpr int E = 16 / int(sizeof(T));
  constexpr int kChunks = NC / E;
  constexpr int WS = Smem<T, NC>::kWStride;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * E;
    const bool in = r < rows_in;
    fmma::cp_async<16>(dst + r * WS + c, in ? src + r * ld + c : base,
                       in ? 16 : 0);
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

// The GEMMs' source rows. A conv1 row m is h-tile position m (edge T + 2),
// read at x-tile position (m / (T+2)) (T+4) + m % (T+2) plus the tap; a
// conv2 row m is output pixel m (edge T), read at h-tile position
// (m / T) (T+2) + m % T plus the tap; the skip reads the output pixel's own
// x-tile position.
enum Phase { kConv1, kConv2, kSkip };

__device__ __forceinline__ int source_pos(Phase ph, int m, int tile) {
  const int e1 = tile + 2, ex = tile + 4;
  switch (ph) {
    case kConv1: return (m / e1) * ex + m % e1;
    case kConv2: return (m / tile) * e1 + m % tile;
    default: return (m / tile + 2) * ex + m % tile + 2;
  }
}

// The jobs of a CTA, one stage of weights each, in order: conv1 by column
// chunks of NC, each by passes of up to per_pass m-tiles, each by k-chunks
// of the input channels, 9 taps each; then conv2 likewise over the h
// channels, each pass followed by the skip's k-chunks.
struct Jobs {
  int passes1, passes2, kc1, kc2, per1, per2, ncc, jobs1, total;
  __device__ __forceinline__ Jobs(const Params& p, int per_pass, int nc,
                                  bool has_skip) {
    const int e1 = p.tile + 2;
    passes1 = ((e1 * e1 + 15) / 16 + per_pass - 1) / per_pass;
    passes2 = ((p.tile * p.tile + 15) / 16 + per_pass - 1) / per_pass;
    kc1 = (p.cin_pad + p.kc - 1) / p.kc;
    kc2 = (p.cout_pad + p.kc - 1) / p.kc;
    ncc = p.cout_pad / nc;
    per1 = kc1 * 9;
    per2 = kc2 * 9 + (has_skip ? kc1 : 0);
    jobs1 = ncc * passes1 * per1;
    total = jobs1 + ncc * passes2 * per2;
  }
};

// Job j: its phase, column chunk, pass, k-chunk, tap, and its place s in
// its pass (0 first).
struct Job {
  Phase ph;
  int cc, pass, kc, tap, s;
  __device__ __forceinline__ Job(const Jobs& J, int j) {
    const bool conv1 = j < J.jobs1;
    const int per = conv1 ? J.per1 : J.per2;
    const int jj = conv1 ? j : j - J.jobs1;
    const int passes = conv1 ? J.passes1 : J.passes2;
    cc = jj / (passes * per);
    pass = jj % (passes * per) / per;
    s = jj % per;
    if (conv1 || s < J.kc2 * 9) {
      ph = conv1 ? kConv1 : kConv2;
      kc = s / 9;
      tap = s % 9;
    } else {
      ph = kSkip;
      kc = s - J.kc2 * 9;
      tap = 0;
    }
  }
};

// The UNet's blocks: Cout the instance's 32 or 64 columns, every channel
// in one k-chunk, x whole, one job a tap; kTwo: x from two sources. The
// general kernel, run at these plans, took 16-30 % longer on the H100 (its
// job decode, and its registers at the cap), so these plans keep the
// kernel as it was before any width: its one-source instance is that
// kernel's code, with its parameters (NarrowParams) and its gather.
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

// The kernel at any width: the plan's tile, k-chunks and column chunks.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2)
    fused_resblock_kernel(const Params p) {
  constexpr int kGroups = NC / kWarpCols;  // column groups of the CTA
  constexpr int kWpg = kWarps / kGroups;   // warps per column group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T, NC> L = plan_smem<T, NC>(p);
  constexpr int WS = Smem<T, NC>::kWStride;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* hs = xs + L.hs_off;
  T* ring = xs + L.ring_off;

  const int b = blockIdx.x / p.tiles_per_image;
  const int tile_id = blockIdx.x % p.tiles_per_image;
  const int y0 = (tile_id / p.tiles_x) * p.tile;
  const int x0 = (tile_id % p.tiles_x) * p.tile;
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* ws = static_cast<const T*>(p.ws);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* b2 = static_cast<const T*>(p.b2);
  const T* bs = static_cast<const T*>(p.bs);
  const int cout = p.cout;
  const T* tb = static_cast<const T*>(p.tb) + int64_t(b) * cout;
  T* out = static_cast<T*>(p.out);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = (warp / kWpg) * kWarpCols;  // the warp's columns in a chunk
  const int wm = warp % kWpg;                // its place in the group

  const int m1 = L.h_edge * L.h_edge, m2 = p.tile * p.tile;
  const int per_pass = kWpg * kMaxMt;
  const bool has_skip = ws != nullptr;
  const Jobs J(p, per_pass, NC, has_skip);
  const bool x_chunked = p.x_chunked;
  const int x_cols = x_chunked ? p.kc : p.cin_pad;
  const int ld = p.cout_pad;  // the packed weights' row stride

  auto issue = [&](int j) {
    const Job q(J, j);
    T* dst = ring + (j % kStages) * p.kc * WS;
    const int k0 = q.kc * p.kc, col0 = q.cc * NC;
    if (q.ph == kConv2) {
      load_w<T, NC>(dst, w2 + (int64_t(q.tap) * cout + k0) * ld + col0, w2,
                    ld, min(p.kc, cout - k0), min(p.kc, p.cout_pad - k0));
    } else {
      const T* w = q.ph == kConv1 ? w1 + int64_t(q.tap) * p.cin * ld : ws;
      load_w<T, NC>(dst, w + int64_t(k0) * ld + col0, w, ld,
                    min(p.kc, p.cin - k0), min(p.kc, p.cin_pad - k0));
    }
  };
  // Prologue: the x tile (whole, or its first chunk) and the first
  // kStages - 1 jobs' weights, one group each (the x tile joins the first).
  load_sources(xs, p, b, L.x_edge, L.xs_stride, y0, x0, 0, x_cols);
  int x_chunk = 0;  // the chunk of x in shared memory, when chunked
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < J.total) issue(j);
    fmma::cp_async_commit();
  }

  float acc[kMaxMt][kNb][4];
  int tiles[kMaxMt];  // the warp's m-tiles in this pass
  int mts = 0;
  for (int j = 0; j < J.total; ++j) {
    // Job j's weights have landed, every thread sees them, and every thread
    // is done with job j - 1, whose stage is refilled with job
    // j + kStages - 1's (an empty group past the last, so that the count of
    // groups in flight stays kStages - 2 at the wait).
    fmma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < J.total) issue(j + kStages - 1);
    fmma::cp_async_commit();
    const Job q(J, j);
    if (x_chunked && q.ph != kConv2 && q.kc != x_chunk) {
      // Every thread is done with the old chunk (the barrier above).
      load_sources(xs, p, b, L.x_edge, L.xs_stride, y0, x0, q.kc * p.kc,
                   x_cols);
      fmma::cp_async_commit();
      fmma::cp_async_wait<0>();
      __syncthreads();
      x_chunk = q.kc;
    }
    const bool conv1 = q.ph == kConv1;
    const int rows = conv1 ? m1 : m2;
    if (q.s == 0) {
      mts = 0;
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        tiles[i] = q.pass * per_pass + wm + i * kWpg;
        if (tiles[i] * 16 < rows) mts = i + 1;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][n][c] = 0.f;
        }
      }
    }
    int pos[kMaxMt][2];
#pragma unroll
    for (int i = 0; i < kMaxMt; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = tiles[i] * 16 +
                      (sizeof(T) == 4 ? g + 8 * r : lane % 16);
        pos[i][r] = source_pos(q.ph, min(m, rows - 1), p.tile);
      }
    }
    const T* w = ring + (j % kStages) * p.kc * WS;
    const int k0 = q.kc * p.kc;
    float part[kMaxMt][kNb][4] = {};
    if (mts > 0) {
      if (q.ph == kConv2) {
        const int off = (q.tap / 3) * L.h_edge + q.tap % 3;
        gemm<NC>(part, hs + k0, L.hs_stride, pos, mts, off, w, n0,
                 min(p.kc, p.cout_pad - k0));
      } else {
        const int off = conv1 ? (q.tap / 3) * L.x_edge + q.tap % 3 : 0;
        gemm<NC>(part, xs + (x_chunked ? 0 : k0), L.xs_stride, pos, mts,
                 off, w, n0, min(p.kc, p.cin_pad - k0));
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
    // row tiles[i] 16 + g + 8 (c / 2), column cc NC + n0 + 8 n + 2 t + c % 2.
    const int col_base = q.cc * NC + n0 + 2 * t;
    if (conv1 && q.s == J.per1 - 1) {
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        if (i >= mts) break;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = tiles[i] * 16 + g + 8 * (c / 2);
            if (m >= m1) continue;
            const int col = col_base + 8 * n + c % 2;
            const int gy = y0 - 1 + m / L.h_edge, gx = x0 - 1 + m % L.h_edge;
            const bool inside = gy >= 0 && gy < p.height && gx >= 0 &&
                                gx < p.width && col < cout;
            const float v = inside ? fmaxf(acc[i][n][c] + to_f32(b1[col]),
                                           0.f) + to_f32(tb[col])
                                   : 0.f;
            hs[m * L.hs_stride + col] = from_f32<T>(v);
          }
        }
      }
    }
    if (q.ph == kConv2 && q.s == J.kc2 * 9 - 1) {
      // relu(conv2 + b2), and the identity skip
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = col_base + 8 * n + c % 2;
            if (col >= cout) continue;
            float v = fmaxf(acc[i][n][c] + to_f32(b2[col]), 0.f);
            if (!has_skip) {
              const int m = min(tiles[i] * 16 + g + 8 * (c / 2), m2 - 1);
              if (!x_chunked) {
                v += to_f32(
                    xs[source_pos(kSkip, m, p.tile) * L.xs_stride + col]);
              } else {
                const int gy = min(y0 + m / p.tile, p.height - 1);
                const int gx = min(x0 + m % p.tile, p.width - 1);
                v += to_f32(*x_addr<T>(p, b, gy, gx, col));
              }
            }
            acc[i][n][c] = v;
          }
        }
      }
    }
    if (q.ph != kConv1 && q.s == J.per2 - 1) {  // after the skip: store
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        if (i >= mts) break;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = tiles[i] * 16 + g + 8 * (c / 2);
            const int gy = y0 + m / p.tile, gx = x0 + m % p.tile;
            const int col = col_base + 8 * n + c % 2;
            if (m >= m2 || gy >= p.height || gx >= p.width || col >= cout) {
              continue;
            }
            float v = acc[i][n][c];
            if (has_skip) v += to_f32(bs[col]);
            out[((int64_t(b) * p.height + gy) * p.width + gx) * cout + col] =
                from_f32<T>(v);
          }
        }
      }
    }
  }
}

// The narrow kernel where Cout is its 32 or 64 columns and the plan is one
// k-chunk of every channel with x whole (the UNet's blocks), else the
// general one at the plan's column width.
template <typename K, typename P>
cudaError_t launch_kernel(K kernel, const P& p, int batch, size_t smem,
                          cudaStream_t stream) {
  // Above 48 KB only after this attribute; a refusal (above the device's
  // 227 KB) is returned, never worked around.
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)batch * p.tiles_per_image;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<unsigned(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The host's plan and the kernel's layout must agree on the bytes.
template <typename T, int NC>
cudaError_t launch(const Params& p, int batch, size_t smem, bool narrow,
                   cudaStream_t stream) {
  if constexpr (NC == 32 || NC == 64) {
    if (narrow) {
      const NarrowParams n{p.x, p.w1, p.b1, p.tb, p.w2, p.b2, p.ws, p.bs,
                           p.out, p.height, p.width, p.cin, p.cin_pad,
                           p.tile, p.tiles_x, p.tiles_per_image, p.vec,
                           p.xb, p.ca, p.up};
      if (narrow_smem<T, NC>(n).bytes != smem) return cudaErrorInvalidValue;
      return n.xb ? launch_kernel(fused_resblock_kernel_narrow<T, NC, true>,
                                  n, batch, smem, stream)
                  : launch_kernel(fused_resblock_kernel_narrow<T, NC, false>,
                                  n, batch, smem, stream);
    }
  }
  if (narrow || plan_smem<T, NC>(p).bytes != smem) {
    return cudaErrorInvalidValue;
  }
  return launch_kernel(fused_resblock_kernel<T, NC>, p, batch, smem, stream);
}

template <typename T>
cudaError_t launch_nc(const Params& p, int batch, int nc, size_t smem,
                      cudaStream_t stream) {
  const bool narrow = !p.x_chunked && p.kc >= p.cin_pad &&
                      p.kc >= p.cout_pad && p.cout == nc && nc <= 64;
  switch (nc) {
    case 32: return launch<T, 32>(p, batch, smem, narrow, stream);
    case 64: return launch<T, 64>(p, batch, smem, narrow, stream);
    case 128: return launch<T, 128>(p, batch, smem, false, stream);
    case 256: return launch<T, 256>(p, batch, smem, false, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the block on `stream`. dtype: 0 = float32, 1 = bfloat16,
// every pointer an array of that dtype in the layouts of Params. One
// source: xb null, ca == cin, up == 1. Two sources: the block's input is
// cat(upsample(x, up), xb) along channels, x with ca channels at 1/up of
// height and width (which up divides), xb with cin - ca at full size. ws
// and bs are null for the identity skip (then cin must equal cout). The
// plan (ops/resblock.py): `tile` the output tile edge, `kc` the k-chunk (a
// multiple of the k step, 8 for float32 and 16 for bfloat16), `x_chunked`
// whether x is staged kc channels at a time, `nc` the instance's column
// width (32, 64, 128 or 256, dividing Cout padded to 32), `smem` the
// dynamic shared-memory bytes, which must equal this layout's. vec: bytes
// per copy of x into shared memory (16, 8, 4; 2 for bf16 only), which both
// sources' addresses and ca and cin - ca times the element size must be
// multiples of. Returns the cudaError_t of the launch (0 on success),
// including a refusal of the shared-memory size; the kernel allocates
// nothing.
extern "C" int tdm_fused_resblock(const void* x, const void* xb,
                                  const void* w1, const void* b1,
                                  const void* tb, const void* w2,
                                  const void* b2, const void* ws,
                                  const void* bs, void* out, int dtype,
                                  int batch, int height, int width, int cin,
                                  int ca, int up, int cout, int tile, int kc,
                                  int x_chunked, int nc, int vec,
                                  long long smem, void* stream) {
  const int min_vec = dtype == 1 ? 2 : 4;
  const int step = dtype == 1 ? 16 : 8;
  const bool one = xb == nullptr;
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      tile <= 0 || kc <= 0 || kc % step != 0 || up <= 0 ||
      (dtype != 0 && dtype != 1) || (one && (ca != cin || up != 1)) ||
      (!one && (ca <= 0 || ca >= cin || height % up || width % up)) ||
      (ws == nullptr && cin != cout) || ((ws == nullptr) != (bs == nullptr)) ||
      vec < min_vec || vec > 16 || (vec & (vec - 1)) != 0 || smem <= 0) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.xb = xb;
  p.w1 = w1;
  p.b1 = b1;
  p.tb = tb;
  p.w2 = w2;
  p.b2 = b2;
  p.ws = ws;
  p.bs = bs;
  p.out = out;
  p.height = height;
  p.width = width;
  p.cin = cin;
  p.ca = ca;
  p.up = up;
  p.cout = cout;
  p.cout_pad = (cout + kWarpCols - 1) / kWarpCols * kWarpCols;
  p.cin_pad = (cin + step - 1) / step * step;
  p.kc = kc;
  p.x_chunked = x_chunked;
  p.tile = tile;
  p.tiles_x = (width + tile - 1) / tile;
  p.tiles_per_image = p.tiles_x * ((height + tile - 1) / tile);
  p.vec = vec;
  if (p.cout_pad % nc != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_nc<float>(p, batch, nc, size_t(smem), s)
                 : launch_nc<__nv_bfloat16>(p, batch, nc, size_t(smem), s);
  return int(err);
}
