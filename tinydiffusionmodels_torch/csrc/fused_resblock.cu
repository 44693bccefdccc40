// Fused UNet residual block for Hopper (sm_90a), f32 and bf16: an implicit
// GEMM on the tensor cores.
//
// Replaces the TPU kernel `_resblock_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py (driven by
// `_fused_resblock_impl` there). One launch computes the whole block of the
// MNIST UNet on NHWC activations:
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
// Design. One CTA of 256 threads (8 warps) per (image, output tile of T x T
// pixels); the wrapper passes T = 14 where that still gives 100 CTAs, else
// T = 7, which spreads small batches over more SMs (ops/resblock.py).
// The CTA stages the input tile with a 2-pixel halo in shared memory by
// cp.async (zeros outside the image and in the channels past Cin up to the
// k step), computes h over the tile plus a 1-pixel halo into shared memory,
// then conv2 over the tile, adds the skip and writes the output. Each
// conv3x3 is a GEMM: M = the positions (h: (T + 2)^2, out: T^2, in m-tiles
// of 16 rows), N = Cout (32 or 64), K = 9 Cin taken tap by tap. A warp owns
// 32 output columns and up to two m-tiles per pass (more passes for larger
// tiles); its A fragments are gathered per tap from the tile in shared
// memory (rows are positions shifted by the tap, so no im2col copy), by
// ldmatrix in bf16 and by scalar loads in f32. The weights of one tap
// (Cin x Cout, the wrapper's (9, Cin, Cout) packing) are staged by cp.async
// into a ring of three stages, two taps ahead of the products, with one
// barrier per tap. Products run on mma.sync: bf16 on m16n8k16, f32 as 3xTF32 on
// m16n8k8 (flash_mma.cuh), which keeps float32's accuracy; each tap's
// products sum into zeroed fragments that are then added in f32 (the tensor
// cores' f32 accumulation truncates). The epilogues act on the C
// fragments: relu(conv1 + b1) + time_bias, zeroed outside the image, into
// the h tile; relu(conv2 + b2), then the 1x1 skip as one more GEMM step
// (K = Cin, A the tile's centre positions) or the identity, then the store.
// Rows are padded (4 floats, 8 bf16) so fragment loads hit distinct banks
// and bf16 rows start on 16 bytes.
//
// What bounds it. The block does ~130 MFLOP per image for the four blocks of
// the UNet, against ~3 MB of activations moved at the sampler's batch of 25:
// it is bound by operations. On the tensor cores the least time is that of
// the bf16 products at 989 TFLOP/s, or of the f32 products as 3xTF32 (three
// TF32 products each, at 495 TFLOP/s). This kernel pays on top: the conv1
// halo recomputed by neighbouring tiles (1.65x the conv1 work at T = 7), the
// m-tiles' padding rows (81 -> 96 and 49 -> 64 at T = 7), Cin = 1 padded to
// the k step, the A gathers and the operand splits of 3xTF32 on the FMA and
// load pipes, and mma.sync, which reaches only part of Hopper's
// tensor-core rate.

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
  const void* x;   // (batch, height, width, cin), NHWC
  const void* w1;  // (9, cin, cout): conv1, taps in (ky, kx) row-major order
  const void* b1;  // (cout)
  const void* tb;  // (batch, cout): time bias
  const void* w2;  // (9, cout, cout)
  const void* b2;  // (cout)
  const void* ws;  // (cin, cout): 1x1 skip; null for the identity skip
  const void* bs;  // (cout), with ws
  void* out;       // (batch, height, width, cout)
  int height, width, cin, cin_pad;
  int tile, tiles_x, tiles_per_image;
  int vec;  // bytes per copy of x into shared memory (16, 8, 4; 2 for bf16)
};

// Shared memory: the x tile ((T + 4)^2 rows), the h tile ((T + 2)^2 rows)
// and kStages stages of one tap's weights (max(Cin, Cout) rows).
template <typename T, int COUT>
struct Smem {
  static constexpr int kWStride = COUT + 8;  // weight rows: banks, 16 bytes
  int x_edge, h_edge, xs_stride, hs_stride, w_rows, hs_off, ring_off;
  size_t bytes;
  __host__ __device__ Smem(int tile, int cin_pad)
      : x_edge(tile + 4),
        h_edge(tile + 2),
        xs_stride(cin_pad + Mma<T>::kPad),
        hs_stride(COUT + Mma<T>::kPad),
        w_rows(cin_pad > COUT ? cin_pad : COUT) {
    hs_off = x_edge * x_edge * xs_stride;
    ring_off = hs_off + h_edge * h_edge * hs_stride;
    bytes = sizeof(T) *
            (size_t(ring_off) + kStages * size_t(w_rows) * kWStride);
  }
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

// The x tile with its 2-pixel halo, cin_pad channels per position, copies
// of V bytes; zeros outside the image and past Cin. Joins the open group.
template <typename T, int V>
__device__ __forceinline__ void load_x_v(T* xs, const T* xb, const Params& p,
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

template <typename T>
__device__ __forceinline__ void load_x(T* xs, const T* xb, const Params& p,
                                       int x_edge, int xs_stride, int y0,
                                       int x0) {
  switch (p.vec) {
    case 16: load_x_v<T, 16>(xs, xb, p, x_edge, xs_stride, y0, x0); break;
    case 8: load_x_v<T, 8>(xs, xb, p, x_edge, xs_stride, y0, x0); break;
    case 4: load_x_v<T, 4>(xs, xb, p, x_edge, xs_stride, y0, x0); break;
    default:
      if constexpr (sizeof(T) == 2) {
        load_x_v<T, 2>(xs, xb, p, x_edge, xs_stride, y0, x0);
      }
      break;
  }
}

// Rows [0, rows) of one tap's weights ((rows_in, COUT) row-major at `src`)
// into a ring stage; rows at or past rows_in are zeros. Joins the open group.
template <typename T, int COUT>
__device__ __forceinline__ void load_w(T* dst, const T* src, int rows_in,
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
template <int COUT>
__device__ __forceinline__ void gemm(float (&part)[kMaxMt][kNb][4],
                                     const float* src, int ss,
                                     const int (&pos)[kMaxMt][2], int mts,
                                     int off, const float* w, int n0,
                                     int depth) {
  constexpr int WS = Smem<float, COUT>::kWStride;
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

template <int COUT>
__device__ __forceinline__ void gemm(float (&part)[kMaxMt][kNb][4],
                                     const __nv_bfloat16* src, int ss,
                                     const int (&pos)[kMaxMt][2], int mts,
                                     int off, const __nv_bfloat16* w, int n0,
                                     int depth) {
  constexpr int WS = Smem<__nv_bfloat16, COUT>::kWStride;
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

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads, 2)
    fused_resblock_kernel(const Params p) {
  constexpr int kGroups = COUT / kWarpCols;  // column groups of the CTA
  constexpr int kWpg = kWarps / kGroups;     // warps per column group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T, COUT> L(p.tile, p.cin_pad);
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
      load_w<T, COUT>(dst, w1 + (j % 9) * p.cin * COUT, p.cin, p.cin_pad);
    } else {
      const int step = (j - jobs1) % steps2;
      if (step < 9) {
        load_w<T, COUT>(dst, w2 + step * COUT * COUT, COUT, COUT);
      } else {
        load_w<T, COUT>(dst, ws, p.cin, p.cin_pad);
      }
    }
  };
  // Prologue: the x tile and the first kStages - 1 jobs' weights, one
  // group each (the x tile joins the first).
  load_x(xs, x + int64_t(b) * p.height * p.width * p.cin, p, L.x_edge,
         L.xs_stride, y0, x0);
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

template <typename T, int COUT>
cudaError_t launch(Params& p, int batch, cudaStream_t stream) {
  p.cin_pad = (p.cin + Mma<T>::kStep - 1) / Mma<T>::kStep * Mma<T>::kStep;
  const size_t smem = Smem<T, COUT>(p.tile, p.cin_pad).bytes;
  // Above 48 KB only after this attribute; a refusal (above the device's
  // 227 KB) is returned, never worked around.
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_resblock_kernel<T, COUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = (long long)batch * p.tiles_per_image;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_resblock_kernel<T, COUT><<<unsigned(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cout(Params& p, int batch, int cout, cudaStream_t stream) {
  switch (cout) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the block on `stream`. dtype: 0 = float32, 1 = bfloat16,
// every pointer an array of that dtype in the layouts of Params; ws and bs
// are null for the identity skip (then cin must equal cout). cout: 32 or
// 64. `tile` is the output tile edge. vec: bytes per copy of x into shared
// memory (16, 8, 4; 2 for bf16 only), which x's address and cin times its
// element size must be multiples of. Returns the cudaError_t of the launch
// (0 on success), including a refusal of the shared-memory size; the kernel
// allocates nothing.
extern "C" int tdm_fused_resblock(const void* x, const void* w1,
                                  const void* b1, const void* tb,
                                  const void* w2, const void* b2,
                                  const void* ws, const void* bs, void* out,
                                  int dtype, int batch, int height, int width,
                                  int cin, int cout, int tile, int vec,
                                  void* stream) {
  const int min_vec = dtype == 1 ? 2 : 4;
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || tile <= 0 ||
      (dtype != 0 && dtype != 1) || (cout != 32 && cout != 64) ||
      (ws == nullptr && cin != cout) || ((ws == nullptr) != (bs == nullptr)) ||
      vec < min_vec || vec > 16 || (vec & (vec - 1)) != 0) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
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
  p.tile = tile;
  p.tiles_x = (width + tile - 1) / tile;
  p.tiles_per_image = p.tiles_x * ((height + tile - 1) / tile);
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_cout<float>(p, batch, cout, s)
                 : launch_cout<__nv_bfloat16>(p, batch, cout, s);
  return int(err);
}
