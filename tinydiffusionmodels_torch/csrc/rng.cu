// The JAX package's random draws for Hopper (sm_90a): key derivation and a
// draw in one launch.
//
// No TPU kernel stands behind this file: the JAX package draws through
// `jax.random` (threefry-2x32, partitionable) and the counter hashes of its
// core/rng.py, which XLA fuses into the step. The port's plain version is
// tinydiffusionmodels_torch/core/rng.py; ops/rng.py is the wrapper.
//
// A draw names its key by a path: a base key (two words in device memory),
// then optionally the low 32 bits of a device counter (a training step or
// a sampler's timestep, which a replayed CUDA graph reads where it lies),
// then up to kMaxWords host words, each a fold_in: threefry-2x32 of the
// counter pair (0, word) under the key. Every thread derives the key
// itself (a few threefry calls, once per thread), then walks its elements.
// Element j of the launch is element g of the draw's global shape: the
// launch covers a box of that shape (a data-parallel rank's rows, a
// sequence shard's positions, a tensor-parallel rank's columns), given by
// its sizes, the global strides and its start, so a rank draws exactly its
// slice of the one-device draw.
//
// Kinds:
//   kNormal   jax.random.normal: bits = b0 ^ b1 of threefry(key, (g >> 32,
//             g)), u = the float of [1, 2) with the top 23 bits as mantissa
//             minus 1, scaled to [nextafter(-1, 0), 1), then sqrt(2) *
//             erf_inv(u) (XLA's float32 polynomial, log1p and the Horner
//             steps as the plain version rounds them);
//   kRandint  jax.random.randint (32-bit): two draws of bits under the
//             split keys fold_in(key, 0) and fold_in(key, 1), combined
//             modulo the span; written as int32 or int64;
//   kKeep     dropout by jax.random.bernoulli: keep where u < p, and
//             out = keep ? x / div : 0 (div = the keep probability in x's
//             dtype, as the JAX package divides);
//   kCounterNormal, kCounterKeep  the JAX package's counter_normal and
//             counter_bernoulli: murmur3 fmix32 of the flat index under
//             seeds mixed from the key, Box-Muller for the normals (the
//             first half of the draw r cos(theta), the second r sin(theta)).
//
// What bounds it: the bytes it writes (and, for a mask, reads). The
// threefry draws cost about 100 integer operations an element, the
// counter hashes about 10; at the noise and mask sizes of the training
// steps both stay below the memory time on the H100's integer pipes only
// for the counter hashes.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 8;
constexpr int kMaxDims = 4;

enum Kind { kNormal = 0, kRandint = 1, kKeep = 2, kCounterNormal = 3,
            kCounterKeep = 4 };
// Element types: the masks' x and out, and randint's out.
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kI64 = 3 };

struct Params {
  const long long* base;     // the base key's two words
  const long long* counter;  // null: no device fold-in
  uint32_t words[kMaxWords];
  int n_words;
  int ndim;
  long long size[kMaxDims];     // the launch's box
  long long gstride[kMaxDims];  // strides of the global shape
  long long start[kMaxDims];    // the box's first element
  long long n;                  // elements of the box
  long long half;               // counter normal: (global elements + 1) / 2
  void* out;
  const void* x;
  int dtype;
  uint32_t span, mult, thresh;
  long long minval;
  float p, div;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int a,
                                       int b, int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// Threefry-2x32, 20 rounds (JAX's _threefry2x32_lowering).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t word) {
  uint32_t x0 = 0u, x1 = word;
  threefry(k0, k1, x0, x1);
  k0 = x0; k1 = x1;
}

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         long long g) {
  uint32_t x0 = uint32_t(uint64_t(g) >> 32), x1 = uint32_t(g);
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float unit(uint32_t b) {  // [0, 1)
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85EBCA6Bu;
  h ^= h >> 13; h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// XLA's ErfInv32, the logarithm in double rounded once, as the plain
// version computes it.
__device__ __forceinline__ float erf_inv(float x) {
  float w = -float(log1p(double(-(x * x))));
  const bool small = w < 5.0f;
  w = small ? w - 2.5f : sqrtf(w) - 3.0f;
  float p;
  if (small) {
    p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
  } else {
    p = -0.000200214257f;
    p = fmaf(p, w, 0.000100950558f);
    p = fmaf(p, w, 0.00134934322f);
    p = fmaf(p, w, -0.00367342844f);
    p = fmaf(p, w, 0.00573950773f);
    p = fmaf(p, w, -0.0076224613f);
    p = fmaf(p, w, 0.00943887047f);
    p = fmaf(p, w, 1.00167406f);
    p = fmaf(p, w, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? x * 3.402823466e+38f : p * x;
}

__device__ __forceinline__ long long global_index(const Params& p,
                                                  long long j) {
  // One dim (a whole draw, or rows of one): no 64-bit division.
  if (p.ndim == 1) return (j + p.start[0]) * p.gstride[0];
  long long g = 0;
  for (int d = p.ndim - 1; d >= 0; --d) {
    const long long l = j % p.size[d];
    j /= p.size[d];
    g += (l + p.start[d]) * p.gstride[d];
  }
  return g;
}

__device__ __forceinline__ float load(const void* x, int dtype, long long j) {
  return dtype == kBF16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[j])
             : static_cast<const float*>(x)[j];
}

__device__ __forceinline__ void store(void* out, int dtype, long long j,
                                      float v) {
  if (dtype == kBF16) {
    static_cast<__nv_bfloat16*>(out)[j] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[j] = v;
  }
}

template <int KIND>
__global__ void __launch_bounds__(256) draw_kernel(const Params p) {
  uint32_t k0 = uint32_t(p.base[0]), k1 = uint32_t(p.base[1]);
  if (p.counter != nullptr) fold_in(k0, k1, uint32_t(*p.counter));
  for (int i = 0; i < p.n_words; ++i) fold_in(k0, k1, p.words[i]);
  // Per-kind state derived from the key once.
  uint32_t a0 = k0, a1 = k1, b0 = k0, b1 = k1, seed = 0u, seed2 = 0u;
  if (KIND == kRandint) {
    fold_in(a0, a1, 0u);
    fold_in(b0, b1, 1u);
  }
  if (KIND == kCounterNormal || KIND == kCounterKeep) {
    seed = fmix32(k0 ^ (k1 + 0x9E3779B9u));
    seed2 = fmix32(seed ^ 0x632BE59Bu);
    if (KIND == kCounterKeep) seed = fmix32(seed ^ 0x38D1BB47u);
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < p.n; j += step) {
    const long long g = global_index(p, j);
    if (KIND == kNormal) {
      const float lo = -0.99999994f;  // nextafter(-1, 0)
      const float u = fmaxf(lo, unit(bits(k0, k1, g)) * 2.0f + lo);
      static_cast<float*>(p.out)[j] = 1.41421354f * erf_inv(u);
    } else if (KIND == kRandint) {
      const uint32_t hi = bits(a0, a1, g), lo = bits(b0, b1, g);
      uint32_t off = lo;
      if (p.span != 0u) {
        off = (hi % p.span) * p.mult + lo % p.span;
        off %= p.span;
      }
      const int32_t v = int32_t(uint32_t(p.minval) + off);
      if (p.dtype == kI64) {
        static_cast<long long*>(p.out)[j] = v;
      } else {
        static_cast<int32_t*>(p.out)[j] = v;
      }
    } else if (KIND == kKeep) {
      const bool keep = unit(bits(k0, k1, g)) < p.p;
      store(p.out, p.dtype, j, keep ? load(p.x, p.dtype, j) / p.div : 0.0f);
    } else if (KIND == kCounterNormal) {
      const bool second = g >= p.half;
      const uint32_t pair = uint32_t(second ? g - p.half : g);
      const uint32_t h1 = fmix32(pair * 0x9E3779B9u + seed);
      const uint32_t h2 = fmix32(pair * 0x85EBCA6Bu + seed2);
      const float u1 = float(h1 >> 8) * 0x1p-24f + 0x1p-25f;
      const float u2 = float(h2 >> 8) * 0x1p-24f;
      const float r = sqrtf(-2.0f * float(log(double(u1))));
      const double theta = double(6.28318548f * u2);
      static_cast<float*>(p.out)[j] =
          r * float(second ? sin(theta) : cos(theta));
    } else {  // kCounterKeep
      const bool keep = fmix32(uint32_t(g) * 0x9E3779B9u + seed) >= p.thresh;
      store(p.out, p.dtype, j, keep ? load(p.x, p.dtype, j) / p.div : 0.0f);
    }
  }
}

}  // namespace

// One draw. `base` is the key's two int64 words on the device; `counter`
// (null: none) a device int64 whose low 32 bits are folded in next; `words`
// (host) the n_words fold-ins after it. The box: ndim sizes, the global
// shape's strides and the box's start, and n_global the global shape's
// elements. `out` gets the box's elements contiguously; the masks read `x`
// in the same layout. Returns a cudaError_t code.
extern "C" int tdm_rng_draw(int kind, const void* base, const void* counter,
                            const unsigned* words, int n_words, int ndim,
                            const long long* size, const long long* gstride,
                            const long long* start, long long n_global,
                            void* out, const void* x, int dtype,
                            unsigned span, unsigned mult, long long minval,
                            float p, float div, unsigned thresh,
                            void* stream) {
  if (kind < kNormal || kind > kCounterKeep || base == nullptr ||
      out == nullptr || n_words < 0 || n_words > kMaxWords || ndim < 1 ||
      ndim > kMaxDims || n_global < 0 ||
      ((kind == kKeep || kind == kCounterKeep) &&
       (x == nullptr || (dtype != kF32 && dtype != kBF16))) ||
      (kind == kRandint && dtype != kI32 && dtype != kI64)) {
    return int(cudaErrorInvalidValue);
  }
  Params prm{};
  prm.base = static_cast<const long long*>(base);
  prm.counter = static_cast<const long long*>(counter);
  for (int i = 0; i < n_words; ++i) prm.words[i] = words[i];
  prm.n_words = n_words;
  prm.ndim = ndim;
  prm.n = 1;
  for (int d = 0; d < ndim; ++d) {
    if (size[d] < 0 || start[d] < 0) return int(cudaErrorInvalidValue);
    prm.size[d] = size[d];
    prm.gstride[d] = gstride[d];
    prm.start[d] = start[d];
    prm.n *= size[d];
  }
  prm.half = (n_global + 1) / 2;
  prm.out = out;
  prm.x = x;
  prm.dtype = dtype;
  prm.span = span;
  prm.mult = mult;
  prm.thresh = thresh;
  prm.minval = minval;
  prm.p = p;
  prm.div = div;
  if (prm.n == 0) return 0;
  const int threads = 256;
  long long blocks = (prm.n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kNormal: draw_kernel<kNormal><<<int(blocks), threads, 0, s>>>(prm);
      break;
    case kRandint: draw_kernel<kRandint><<<int(blocks), threads, 0, s>>>(prm);
      break;
    case kKeep: draw_kernel<kKeep><<<int(blocks), threads, 0, s>>>(prm);
      break;
    case kCounterNormal:
      draw_kernel<kCounterNormal><<<int(blocks), threads, 0, s>>>(prm);
      break;
    default:
      draw_kernel<kCounterKeep><<<int(blocks), threads, 0, s>>>(prm);
  }
  return int(cudaGetLastError());
}
