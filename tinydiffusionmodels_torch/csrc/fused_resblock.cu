// Fused UNet residual block for Hopper (sm_90a), f32.
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
// shared memory.
//
// Design. One CTA of 256 threads per (image, output tile of T x T pixels);
// the wrapper passes T = 7, which gives 4 or 16 CTAs per image, so even
// batch 25 fills the card with several CTAs per SM (57 KB of shared memory
// each at the widest block). The CTA stages the input tile with a 2-pixel
// halo in shared memory (zeros outside the image), computes h over the tile
// plus a 1-pixel halo into shared memory, then conv2 over the tile, adds the
// skip and writes the output.
// Both tiles are stored position-major with an odd channel stride, so the
// threads of a warp, which read neighbouring positions at one channel, hit
// distinct banks. Each thread owns 4 consecutive output channels and PX
// positions (PX = 1..4, chosen per phase so that the last pass is not mostly
// idle); per (tap, input channel) it reads one float4 of weights and PX
// shared-memory values and does 4 * PX FMAs. Weights are (9, Cin, Cout)
// copies the wrapper makes on each call, read through L1 and L2: a warp
// reads the same 128 contiguous bytes, the rest broadcast.
//
// What bounds it. The block does ~130 MFLOP per image for the four blocks of
// the UNet, against ~3 MB of activations moved at the sampler's batch of 25:
// it is bound by operations (FP32 at 67 TFLOP/s), not bytes. This first
// version is plain FP32 FMA with one shared-memory load per 4 FMAs and no
// tensor cores, so it sits far above that bound; an implicit GEMM on the
// tensor cores (TF32 or bf16 wgmma, TMA-staged tiles) is later work. The
// conv1 halo is recomputed by neighbouring tiles (1.65x the conv1 work at
// T = 7, 1.31x at T = 14).

#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPx = 4;

struct Params {
  const float* x;   // (batch, height, width, cin), NHWC
  const float* w1;  // (9, cin, cout): conv1, taps in (ky, kx) row-major order
  const float* b1;  // (cout)
  const float* tb;  // (batch, cout): time bias
  const float* w2;  // (9, cout, cout)
  const float* b2;  // (cout)
  const float* ws;  // (cin, cout): 1x1 skip; null for the identity skip
  const float* bs;  // (cout), with ws
  float* out;       // (batch, height, width, cout)
  int height, width, cin, cout;
  int tile, tiles_x, tiles_per_image;
};

__host__ __device__ inline int odd_stride(int channels) { return channels | 1; }

size_t smem_bytes(int tile, int cin, int cout) {
  const size_t in_edge = tile + 4, mid_edge = tile + 2;
  return sizeof(float) * (in_edge * in_edge * odd_stride(cin) +
                          mid_edge * mid_edge * odd_stride(cout));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float v, const float4& w, float (&acc)[4]) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

// acc[j][c] += sum over the 9 taps and cin channels of
// src[(pos[j] + tap) * stride + ci] * w[(tap * cin + ci) * cout + co + c],
// where pos[j] is the top-left corner of position j's 3x3 window in a source
// tile `edge` positions wide.
template <int PX>
__device__ __forceinline__ void conv3x3(const float* __restrict__ src,
                                        int edge, int stride, int cin,
                                        const float* __restrict__ w, int cout,
                                        int co, const int (&pos)[PX],
                                        float (&acc)[PX][4]) {
  for (int k = 0; k < 9; ++k) {
    const int tap = (k / 3) * edge + k % 3;
    const float* wk = w + size_t(k) * cin * cout + co;
    int base[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) base[j] = (pos[j] + tap) * stride;
#pragma unroll 4
    for (int ci = 0; ci < cin; ++ci) {
      const float4 wv = load4(wk + size_t(ci) * cout);
#pragma unroll
      for (int j = 0; j < PX; ++j) fma4(src[base[j] + ci], wv, acc[j]);
    }
  }
}

// h over the tile plus its 1-pixel halo ((T + 2)^2 positions) into hs.
template <int PX>
__device__ void conv1_phase(const Params& p, const float* xs, float* hs,
                            int b, int y0, int x0, int co, int lane,
                            int lanes) {
  const int mid = p.tile + 2, in_edge = p.tile + 4;
  const int n = mid * mid;
  const int hs_stride = odd_stride(p.cout);
  const float4 bias = load4(p.b1 + co);
  const float4 tbias = load4(p.tb + size_t(b) * p.cout + co);
  for (int first = lane; first < n; first += lanes * PX) {
    int q[PX], pos[PX];
    float acc[PX][4];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      q[j] = min(first + j * lanes, n - 1);  // past n: computed, not stored
      pos[j] = (q[j] / mid) * in_edge + q[j] % mid;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    conv3x3<PX>(xs, in_edge, odd_stride(p.cin), p.cin, p.w1, p.cout, co, pos,
                acc);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      if (first + j * lanes >= n) continue;
      const int gy = y0 - 1 + q[j] / mid, gx = x0 - 1 + q[j] % mid;
      const bool inside =
          gy >= 0 && gy < p.height && gx >= 0 && gx < p.width;
      float* h = hs + q[j] * hs_stride + co;
      h[0] = inside ? fmaxf(acc[j][0] + bias.x, 0.f) + tbias.x : 0.f;
      h[1] = inside ? fmaxf(acc[j][1] + bias.y, 0.f) + tbias.y : 0.f;
      h[2] = inside ? fmaxf(acc[j][2] + bias.z, 0.f) + tbias.z : 0.f;
      h[3] = inside ? fmaxf(acc[j][3] + bias.w, 0.f) + tbias.w : 0.f;
    }
  }
}

// relu(conv3x3(h) + b2) + skip(x) over the T x T tile, written to out.
template <int PX>
__device__ void conv2_phase(const Params& p, const float* xs, const float* hs,
                            int b, int y0, int x0, int co, int lane,
                            int lanes) {
  const int t = p.tile, mid = t + 2, in_edge = t + 4;
  const int n = t * t;
  const int xs_stride = odd_stride(p.cin);
  const float4 bias = load4(p.b2 + co);
  for (int first = lane; first < n; first += lanes * PX) {
    int q[PX], pos[PX];
    float acc[PX][4];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      q[j] = min(first + j * lanes, n - 1);
      pos[j] = (q[j] / t) * mid + q[j] % t;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
    conv3x3<PX>(hs, mid, odd_stride(p.cout), p.cout, p.w2, p.cout, co, pos,
                acc);
    int center[PX];  // the output pixel's own input, in the xs tile
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      center[j] = (q[j] / t + 2) * in_edge + q[j] % t + 2;
      acc[j][0] = fmaxf(acc[j][0] + bias.x, 0.f);
      acc[j][1] = fmaxf(acc[j][1] + bias.y, 0.f);
      acc[j][2] = fmaxf(acc[j][2] + bias.z, 0.f);
      acc[j][3] = fmaxf(acc[j][3] + bias.w, 0.f);
    }
    if (p.ws != nullptr) {
      float skip[PX][4];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        skip[j][0] = skip[j][1] = skip[j][2] = skip[j][3] = 0.f;
      }
      for (int ci = 0; ci < p.cin; ++ci) {
        const float4 wv = load4(p.ws + size_t(ci) * p.cout + co);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          fma4(xs[center[j] * xs_stride + ci], wv, skip[j]);
        }
      }
      const float4 sb = load4(p.bs + co);
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        acc[j][0] += skip[j][0] + sb.x;
        acc[j][1] += skip[j][1] + sb.y;
        acc[j][2] += skip[j][2] + sb.z;
        acc[j][3] += skip[j][3] + sb.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const float* xv = xs + center[j] * xs_stride + co;
        acc[j][0] += xv[0];
        acc[j][1] += xv[1];
        acc[j][2] += xv[2];
        acc[j][3] += xv[3];
      }
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int gy = y0 + q[j] / t, gx = x0 + q[j] % t;
      if (first + j * lanes >= n || gy >= p.height || gx >= p.width) continue;
      float* o = p.out + ((size_t(b) * p.height + gy) * p.width + gx) * p.cout +
                 co;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fused_resblock_kernel(const Params p, int px1, int px2) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / p.tiles_per_image;
  const int tile_id = blockIdx.x % p.tiles_per_image;
  const int y0 = (tile_id / p.tiles_x) * p.tile;
  const int x0 = (tile_id % p.tiles_x) * p.tile;
  const int in_edge = p.tile + 4;
  const int xs_stride = odd_stride(p.cin);
  float* xs = smem;
  float* hs = smem + size_t(in_edge) * in_edge * xs_stride;

  // The input tile with a 2-pixel halo; zeros outside the image are conv1's
  // SAME padding.
  const float* xb = p.x + size_t(b) * p.height * p.width * p.cin;
  const int n_in = in_edge * in_edge * p.cin;
  for (int e = threadIdx.x; e < n_in; e += blockDim.x) {
    const int pos = e / p.cin, ci = e - pos * p.cin;
    const int gy = y0 - 2 + pos / in_edge, gx = x0 - 2 + pos % in_edge;
    const bool inside = gy >= 0 && gy < p.height && gx >= 0 && gx < p.width;
    xs[pos * xs_stride + ci] =
        inside ? __ldg(xb + (size_t(gy) * p.width + gx) * p.cin + ci) : 0.f;
  }
  __syncthreads();

  // Thread -> (4-channel group, position lane); the group varies fastest,
  // so a warp reads few positions and its weight loads are contiguous.
  const int groups = p.cout / 4;
  const int lanes = blockDim.x / groups;
  const int co = (threadIdx.x % groups) * 4;
  const int lane = threadIdx.x / groups;
  if (lane < lanes) {
    switch (px1) {
      case 1: conv1_phase<1>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
      case 2: conv1_phase<2>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
      case 3: conv1_phase<3>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
      default: conv1_phase<4>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
    }
  }
  __syncthreads();
  if (lane < lanes) {
    switch (px2) {
      case 1: conv2_phase<1>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
      case 2: conv2_phase<2>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
      case 3: conv2_phase<3>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
      default: conv2_phase<4>(p, xs, hs, b, y0, x0, co, lane, lanes); break;
    }
  }
}

// Positions per thread for a phase of n positions over `lanes` lanes: the
// fewest passes at PX <= 4, then the smallest PX that keeps that count.
int positions_per_thread(int n, int lanes) {
  const int passes = (n + lanes * kMaxPx - 1) / (lanes * kMaxPx);
  return (n + lanes * passes - 1) / (lanes * passes);
}

}  // namespace

// One launch of the block on `stream`. Pointers are device float32 arrays
// in the layouts of Params; ws and bs are null for the identity skip (then
// cin must equal cout). `tile` is the output tile edge. Returns the
// cudaError_t of the launch (0 on success), including a refusal of the
// shared-memory size; the kernel allocates nothing.
extern "C" int tdm_fused_resblock(const void* x, const void* w1,
                                  const void* b1, const void* tb,
                                  const void* w2, const void* b2,
                                  const void* ws, const void* bs, void* out,
                                  int batch, int height, int width, int cin,
                                  int cout, int tile, void* stream) {
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || tile <= 0 ||
      cout <= 0 || cout % 4 != 0 || cout / 4 > kThreads ||
      (ws == nullptr && cin != cout) || ((ws == nullptr) != (bs == nullptr))) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.tb = static_cast<const float*>(tb);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.ws = static_cast<const float*>(ws);
  p.bs = static_cast<const float*>(bs);
  p.out = static_cast<float*>(out);
  p.height = height;
  p.width = width;
  p.cin = cin;
  p.cout = cout;
  p.tile = tile;
  p.tiles_x = (width + tile - 1) / tile;
  p.tiles_per_image = p.tiles_x * ((height + tile - 1) / tile);
  const int lanes = kThreads / (cout / 4);
  const int px1 = positions_per_thread((tile + 2) * (tile + 2), lanes);
  const int px2 = positions_per_thread(tile * tile, lanes);

  const size_t smem = smem_bytes(tile, cin, cout);
  // Above 48 KB only after this attribute; a refusal (above the device's
  // 227 KB) is returned, never worked around.
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_resblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return int(attr);
  const long long blocks = (long long)batch * p.tiles_per_image;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  fused_resblock_kernel<<<unsigned(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(p, px1, px2);
  return int(cudaGetLastError());
}
