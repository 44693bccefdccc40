// What both fused resblock kernels share (csrc/fused_resblock.cu's header
// says what the block computes): the k step and row padding of each dtype,
// the gather of the x tile from one source or two, and the GEMMs' source
// rows.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace tdm_resblock {

// Threads of a CTA that gather the x tile: the narrow kernel's 8 warps,
// the wgmma kernel's two consumer warpgroups.
constexpr int kThreads = 256;

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
template <typename T, typename P>
__device__ __forceinline__ const T* x_addr(const P& p, int b, int gy,
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

}  // namespace tdm_resblock
