// The JAX package's random draws for Hopper (sm_90a): a list of draws, each
// deriving its key from a path, in one launch.
//
// No TPU kernel stands behind this file: the JAX package draws through
// `jax.random` (threefry-2x32, partitionable) and the counter hashes of its
// core/rng.py, which XLA fuses into the step. The port's plain version is
// tinydiffusionmodels_torch/core/rng.py; ops/rng.py is the wrapper.
//
// A draw names its key by a path: a base key (two words in device memory,
// or two host words), then optionally the low 32 bits of a device counter
// (a training step or a sampler's timestep, which a replayed CUDA graph
// reads where it lies), then up to kMaxWords host words, each a fold_in:
// threefry-2x32 of the counter pair (0, word) under the key. Element j of
// a draw is element g of the draw's global shape: the draw covers a box of
// that shape (a data-parallel rank's rows, a sequence shard's positions, a
// tensor-parallel rank's columns), given by its sizes, the global strides
// and its start, so a rank draws exactly its slice of the one-device draw.
//
// Kinds:
//   kNormal   jax.random.normal: bits = b0 ^ b1 of threefry(key, (g >> 32,
//             g)), u = the float of [1, 2) with the top 23 bits as mantissa
//             minus 1, scaled to [nextafter(-1, 0), 1), then sqrt(2) *
//             erf_inv(u) (XLA's float32 polynomial, log1p and the Horner
//             steps as the plain version rounds them), times `scale` (the
//             initialisers' 0.02 * normal);
//   kUniform  jax.random.uniform on [lo, hi): max(lo, fma(u, hi - lo, lo))
//             with u in [0, 1) as above (XLA fuses the multiply-add);
//   kRandint  jax.random.randint (32-bit): two draws of bits under the
//             split keys fold_in(key, 0) and fold_in(key, 1), combined
//             modulo the span; written as int32 or int64;
//   kKeep     dropout by jax.random.bernoulli: keep where u < p, and
//             out = keep ? x / div : 0 (div = the keep probability in x's
//             dtype, as the JAX package divides);
//   kCounterNormal, kCounterKeep  the JAX package's counter_normal and
//             counter_bernoulli: murmur3 fmix32 of the flat index under
//             seeds mixed from the key, Box-Muller for the normals (the
//             first half of the draw r cos(theta), the second r sin(theta));
//   kKey      the path's key itself, its two words as int64: a step's list
//             derives the dropout key once, and the masks fold in from it.
//
// What bounds it on the H100. The counter draws cost about 10 integer
// operations an element: their floor is the bytes they write (and, for a
// mask, read) at 3.35 TB/s. The stock draws cost one threefry-2x32 an
// element (two for randint), about 73 dependent 32-bit adds, rotates and
// xors: at the SMs' integer lanes (64 INT32 and 64 FMA lanes an SM, 132
// SMs, 1.98 GHz: 33.5e12 operations a second) that floor lies above the
// bytes' for every dtype. A step's small draws cost a launch and the
// key's derivation (threefry calls in a row, about 0.16 us each) more than
// either: the step's list derives the dropout key once (kKey), and each
// mask folds in one or two words from it. A mask divides kept elements by
// the keep probability as IEEE division does, from its reciprocal
// (divide below): __fdiv_rn cost about 1 us a small mask.
//
// The design follows from that:
//   - one warp of each block derives the key (and the randint keys or the
//     counter seeds) into shared memory, once; the block reads it after a
//     barrier, and a mask issues its first loads before that barrier, so
//     the derivation hides under them;
//   - each thread takes vectors of contiguous elements, 16 bytes (4 f32 or
//     int32, 8 bf16, 2 int64) where the pointers are 16-byte aligned, one
//     vector an iteration; their hashes are independent chains that the
//     unrolled loops interleave; a ragged end is written element by element;
//     the normals and randint, whose element is long (double-precision
//     math, two threefry calls), keep one copy of it (a vector's elements
//     in turn, one vector an iteration), so that their code stays in the
//     instruction cache between other kernels;
//   - the box walk runs in 32-bit arithmetic when the global shape has
//     fewer than 2^31 elements (64-bit otherwise) and advances a thread's
//     coordinates by the mixed-radix digits of its stride: no division an
//     element, and consecutive global indices within an innermost run;
//   - each draw gets a block for every 256 vectors, at most four an SM (a
//     persistent loop beyond that); a mask's kernel is held to 64
//     registers so that four blocks fit an SM (two vectors a thread an
//     iteration spilled under that cap, and cost 0.9 us a mask);
//     a list of draws shares one launch, each block finding its draw from
//     the list's block offsets.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 8;
constexpr int kMaxDims = 4;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;   // the persistent grid of one draw
constexpr int kSmallList = 8;     // a step's draws
constexpr int kLargeList = 64;    // a model's initialisation

enum Kind { kNormal = 0, kRandint = 1, kKeep = 2, kCounterNormal = 3,
            kCounterKeep = 4, kUniform = 5, kKey = 6, kAny = -1 };
// Element types: the masks' x and out, randint's out, a key's two int64
// words; the other kinds f32. kAnyType: read from the draw.
enum DType { kF32 = 0, kBF16 = 1, kI32 = 2, kI64 = 3, kAnyType = -1 };

// One draw as the host lays it out (ops/rng.py's _Draw mirrors it).
struct Draw {
  const long long* base;     // the key's two words on the device; null: key
  const long long* counter;  // null: no device fold-in
  void* out;                 // the box's elements, contiguous
  const void* x;             // a mask's input, in out's layout
  // The box, innermost last and right-aligned: unused outer dims have
  // size 1, stride 0 and start 0, so every loop over the dims unrolls.
  long long size[kMaxDims];
  long long gstride[kMaxDims];  // strides of the global shape
  long long start[kMaxDims];    // the box's first element
  long long n_global;           // elements of the global shape
  unsigned key[2];
  unsigned words[kMaxWords];
  int kind, dtype, n_words;
  unsigned span, mult, thresh;
  int minval;
  float p, div, rcp, lo, hi, scale;  // rcp: RN(1 / div), a mask's
};

template <int CAP>
struct List {
  Draw d[CAP];
  int block0[CAP + 1];  // the first block of each draw; block0[n] = grid
  int n;
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

template <typename I>
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1, I g) {
  uint32_t x0 = sizeof(I) > 4 ? uint32_t(uint64_t(g) >> 32) : 0u;
  uint32_t x1 = uint32_t(g);
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

// What a block derived from the path, read by every thread.
struct Keys {
  uint32_t k0, k1, a0, a1;  // the key (randint: the two split keys)
  uint32_t seed, seed2;     // the counter draws' seeds
  float rcp;                // a mask's RN(1 / div)
};

// x / div rounded once, as IEEE division gives it, from rcp = RN(1 / div):
// q = RN(x rcp), then one correction by the exact residual x - q div
// (Markstein's theorem: the correctly rounded quotient wherever nothing
// under- or overflows; checked against IEEE division for every float x
// and the divisors 0.1-0.999 in 2^-100 <= |x| < 2^100). Outside that
// range, and for zeros, infinities and NaNs, the IEEE division itself.
__device__ __noinline__ float ieee_divide(float x, float div) {
  return __fdiv_rn(x, div);
}

__device__ __forceinline__ float divide(float x, float div, float rcp) {
  const float a = fabsf(x);
  if (a >= 0x1p-100f && a < 0x1p100f) {
    const float q = __fmul_rn(x, rcp);
    return __fmaf_rn(__fmaf_rn(-q, div, x), rcp, q);
  }
  return ieee_divide(x, div);
}

template <int KIND>
__device__ __forceinline__ void derive(const Draw& d, uint32_t* sk) {
  uint32_t k0, k1;
  if (d.base != nullptr) {
    k0 = uint32_t(d.base[0]);
    k1 = uint32_t(d.base[1]);
  } else {
    k0 = d.key[0];
    k1 = d.key[1];
  }
  if (d.counter != nullptr) fold_in(k0, k1, uint32_t(*d.counter));
  for (int i = 0; i < d.n_words; ++i) fold_in(k0, k1, d.words[i]);
  const int lane = threadIdx.x;
  if constexpr (KIND == kRandint) {
    if (lane < 2) {  // the split keys, in parallel
      fold_in(k0, k1, uint32_t(lane));
      sk[2 * lane] = k0;
      sk[2 * lane + 1] = k1;
    }
  } else if constexpr (KIND == kCounterNormal || KIND == kCounterKeep) {
    if (lane == 0) {
      uint32_t seed = fmix32(k0 ^ (k1 + 0x9E3779B9u));
      const uint32_t seed2 = fmix32(seed ^ 0x632BE59Bu);
      if (KIND == kCounterKeep) seed = fmix32(seed ^ 0x38D1BB47u);
      sk[0] = seed;
      sk[1] = seed2;
    }
  } else if (lane == 0) {
    sk[0] = k0;
    sk[1] = k1;
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T v) { return float(v); }
template <>
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v) { return T(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float v) {
  return __float2bfloat16_rn(v);
}

// One element of a draw at global index g (x: a mask's input).
template <int KIND, typename T, typename I>
__device__ __forceinline__ T element(const Draw& d, const Keys& k, I g,
                                     I half, float x) {
  if constexpr (KIND == kNormal) {
    const float lo = -0.99999994f;  // nextafter(-1, 0); hi - lo rounds to 2
    const float u = fmaxf(lo, unit(bits(k.k0, k.k1, g)) * 2.0f + lo);
    return from_float<T>(__fmul_rn(1.41421354f * erf_inv(u), d.scale));
  } else if constexpr (KIND == kUniform) {
    const float u = unit(bits(k.k0, k.k1, g));
    return from_float<T>(
        fmaxf(d.lo, __fmaf_rn(u, __fsub_rn(d.hi, d.lo), d.lo)));
  } else if constexpr (KIND == kRandint) {
    const uint32_t hi = bits(k.k0, k.k1, g), lo = bits(k.a0, k.a1, g);
    uint32_t off = lo;
    if (d.span != 0u) {
      off = (hi % d.span) * d.mult + lo % d.span;
      off %= d.span;
    }
    return T(int32_t(uint32_t(d.minval) + off));
  } else if constexpr (KIND == kKeep) {
    const bool keep = unit(bits(k.k0, k.k1, g)) < d.p;
    return from_float<T>(keep ? divide(x, d.div, k.rcp) : 0.0f);
  } else if constexpr (KIND == kCounterNormal) {
    const bool second = g >= half;
    const uint32_t pair = uint32_t(second ? g - half : g);
    const uint32_t h1 = fmix32(pair * 0x9E3779B9u + k.seed);
    const uint32_t h2 = fmix32(pair * 0x85EBCA6Bu + k.seed2);
    const float u1 = float(h1 >> 8) * 0x1p-24f + 0x1p-25f;
    const float u2 = float(h2 >> 8) * 0x1p-24f;
    const float r = sqrtf(-2.0f * float(log(double(u1))));
    const double theta = double(6.28318548f * u2);
    // One of the two, by a branch: a vector lies in one half of the draw
    // but where it straddles the middle.
    double trig;
    if (second) {
      trig = sin(theta);
    } else {
      trig = cos(theta);
    }
    return from_float<T>(r * float(trig));
  } else {  // kCounterKeep
    const bool keep = fmix32(uint32_t(g) * 0x9E3779B9u + k.seed) >= d.thresh;
    return from_float<T>(keep ? divide(x, d.div, k.rcp) : 0.0f);
  }
}

// A thread's place in the box: a coordinate per dim, innermost last. The
// box's dims in registers: sizes, global strides, starts.
template <typename I>
struct Box {
  I size[kMaxDims], gstride[kMaxDims], start[kMaxDims];
};

template <typename I>
__device__ __forceinline__ void decompose(const Box<I>& b, I j, I* c) {
#pragma unroll
  for (int k = kMaxDims - 1; k > 0; --k) {
    c[k] = j % b.size[k];
    j /= b.size[k];
  }
  c[0] = j;
}

// c += s (s as decompose gives it), carrying; the outermost dim does not
// wrap.
template <typename I>
__device__ __forceinline__ void advance(const Box<I>& b, I* c, const I* s) {
  I carry = 0;
#pragma unroll
  for (int k = kMaxDims - 1; k > 0; --k) {
    c[k] += s[k] + carry;
    carry = c[k] >= b.size[k];
    if (carry) c[k] -= b.size[k];
  }
  c[0] += s[0] + carry;
}

template <typename I>
__device__ __forceinline__ I global_index(const Box<I>& b, const I* c) {
  I g = 0;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) g += (c[k] + b.start[k]) * b.gstride[k];
  return g;
}

// One element on: the innermost coordinate, carried outwards.
template <typename I>
__device__ __forceinline__ void next(const Box<I>& b, I* w) {
  constexpr int in = kMaxDims - 1;
  bool carry = ++w[in] == b.size[in];
#pragma unroll
  for (int k = in; k > 0; --k) {
    if (carry) {
      w[k] = 0;
      carry = ++w[k - 1] == b.size[k - 1];
    }
  }
}

// The global indices of the V elements from coordinate c on.
template <int V, typename I>
__device__ __forceinline__ void vector_indices(const Box<I>& b, const I* c,
                                               bool contig, I* g) {
  g[0] = global_index(b, c);
  if (contig) {
#pragma unroll
    for (int e = 1; e < V; ++e) g[e] = g[0] + I(e) * b.gstride[kMaxDims - 1];
    return;
  }
  I w[kMaxDims];
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) w[k] = c[k];
#pragma unroll
  for (int e = 1; e < V; ++e) {
    next(b, w);
    g[e] = global_index(b, w);
  }
}

// Kinds whose element is long: double-precision math (erf_inv's log1p;
// Box-Muller's log and a sine or cosine) or two threefry calls (randint).
// Their code holds one copy of it, which takes a vector's elements in
// turn. Unrolled eight times (two vectors of four),
// that code missed in the instruction cache wherever other kernels ran in
// between: a replayed text step's list launch (its noise) took 17 us,
// against 7 us launched alone.
__host__ __device__ constexpr bool heavy(int kind) {
  return kind == kNormal || kind == kCounterNormal || kind == kRandint;
}

template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

// The draw of one block: blk of nblk blocks on this draw.
template <int KIND, typename T, typename I>
__device__ void run(const Draw& d, uint32_t* sk, int blk, int nblk) {
  constexpr int V = 16 / int(sizeof(T));
  constexpr bool kMask = KIND == kKeep || KIND == kCounterKeep;
  Box<I> b;
  I n = 1;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    b.size[k] = I(d.size[k]);
    b.gstride[k] = I(d.gstride[k]);
    b.start[k] = I(d.start[k]);
    n *= b.size[k];
  }
  const I half = I((d.n_global + 1) / 2);
  T* out = static_cast<T*>(d.out);
  const T* x = static_cast<const T*>(d.x);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(out) |
        (kMask ? reinterpret_cast<uintptr_t>(x) : 0)) & 15u) == 0;
  // The innermost run holds whole vectors (or the box is one run).
  const bool one_run = b.size[0] * b.size[1] * b.size[2] == 1;
  const bool contig = one_run || b.size[kMaxDims - 1] % V == 0;

  const I step = I(nblk) * kThreads * V;  // elements between two vectors
  I j = (I(blk) * kThreads + threadIdx.x) * V;
  I c[kMaxDims], s[kMaxDims];
  if (one_run) {  // no division
    c[0] = c[1] = c[2] = s[0] = s[1] = s[2] = 0;
    c[kMaxDims - 1] = j;
    s[kMaxDims - 1] = step;
  } else {
    decompose(b, j, c);
    decompose(b, step, s);
  }

  // A mask's load of the vector at j (as floats).
  float xv[V];
  auto load = [&]() {
    if (aligned && j + V <= n) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(x + j);
#pragma unroll
      for (int e = 0; e < V; ++e) xv[e] = to_float(p.v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xv[e] = j + e < n ? to_float(x[j + e]) : 0.0f;
      }
    }
  };
  bool more = j < n;
  if (kMask && more) load();

  if (threadIdx.x < 32) derive<KIND>(d, sk);
  __syncthreads();
  Keys k{};
  k.k0 = k.seed = sk[0];
  k.k1 = k.seed2 = sk[1];
  if constexpr (KIND == kRandint) {  // lo's key, fold_in(key, 1)
    k.a0 = sk[2];
    k.a1 = sk[3];
  }
  if constexpr (kMask) k.rcp = d.rcp;

  while (more) {
    T v[V];
    if constexpr (heavy(KIND)) {
      I w[kMaxDims];
#pragma unroll
      for (int q = 0; q < kMaxDims; ++q) w[q] = c[q];
      const I g0 = global_index(b, w);
#pragma unroll 1
      for (int e = 0; e < V; ++e) {
        I g = g0 + I(e) * b.gstride[kMaxDims - 1];
        if (!contig) {
          g = global_index(b, w);
          next(b, w);
        }
        const T value = element<KIND, T>(d, k, g, half, 0.0f);
#pragma unroll
        for (int q = 0; q < V; ++q) {  // a register each, no local array
          if (q == e) v[q] = value;
        }
      }
    } else {
      I g[V];
      vector_indices<V>(b, c, contig, g);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[e] = element<KIND, T>(d, k, g[e], half, kMask ? xv[e] : 0.0f);
      }
    }
    if (aligned && j + V <= n) {
      Pack<T, V> p;
#pragma unroll
      for (int e = 0; e < V; ++e) p.v[e] = v[e];
      *reinterpret_cast<Pack<T, V>*>(out + j) = p;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (j + e < n) out[j + e] = v[e];
      }
    }
    j += step;
    more = j < n;
    if (more) {
      advance(b, c, s);
      if (kMask) load();
    }
  }
}

// A global shape of 2^31 elements or more walks its box in 64-bit
// arithmetic (a kernel of its own, so the 32-bit one keeps its registers).
constexpr long long kWide = 1ll << 31;

template <int KIND, int DT, bool WIDE>
__device__ __forceinline__ void run_kind(const Draw& d, uint32_t* sk,
                                         int blk, int nblk) {
  using I = std::conditional_t<WIDE, unsigned long long, uint32_t>;
  if constexpr (KIND == kKey) {
    if (threadIdx.x < 32) derive<kNormal>(d, sk);
    __syncthreads();
    if (threadIdx.x == 0) {
      static_cast<long long*>(d.out)[0] = sk[0];
      static_cast<long long*>(d.out)[1] = sk[1];
    }
  } else if constexpr (KIND == kRandint) {
    if (d.dtype == kI64) {
      run<KIND, long long, I>(d, sk, blk, nblk);
    } else {
      run<KIND, int32_t, I>(d, sk, blk, nblk);
    }
  } else if constexpr (KIND == kKeep || KIND == kCounterKeep) {
    if constexpr (DT == kBF16) {
      run<KIND, __nv_bfloat16, I>(d, sk, blk, nblk);
    } else if constexpr (DT == kF32) {
      run<KIND, float, I>(d, sk, blk, nblk);
    } else if (d.dtype == kBF16) {
      run<KIND, __nv_bfloat16, I>(d, sk, blk, nblk);
    } else {
      run<KIND, float, I>(d, sk, blk, nblk);
    }
  } else {
    run<KIND, float, I>(d, sk, blk, nblk);
  }
}

// Resident blocks an SM the compiler must allow: four for a mask (at most
// 64 registers a thread, so a persistent grid of four an SM keeps enough
// 16-byte loads in flight), two for the rest.
constexpr int min_blocks(int kind) {
  return kind == kKeep || kind == kCounterKeep ? kBlocksPerSm : 2;
}

// CAP draws a launch. KIND: the one kind of a single draw, or kAny (each
// block reads its draw's kind); DT: a mask's element type, or kAnyType.
// Each single draw of 32-bit boxes has a kernel of its own kind (and a
// mask of its own type), whose code is only that; a list, or a draw of a
// global shape past 2^31 elements (WIDE), takes the kernel of every kind.
template <int CAP, int KIND, int DT, bool WIDE>
__global__ void __launch_bounds__(kThreads, min_blocks(KIND))
    draw_kernel(const __grid_constant__ List<CAP> list) {
  __shared__ uint32_t sk[4];
  int i = 0;
  if (CAP > 1) {
    while (i + 1 < list.n && int(blockIdx.x) >= list.block0[i + 1]) ++i;
  }
  const Draw& d = list.d[i];
  const int blk = int(blockIdx.x) - list.block0[i];
  const int nblk = list.block0[i + 1] - list.block0[i];
  if constexpr (KIND != kAny) {
    run_kind<KIND, DT, WIDE>(d, sk, blk, nblk);
  } else {
    switch (d.kind) {
      case kNormal: run_kind<kNormal, DT, WIDE>(d, sk, blk, nblk); break;
      case kUniform: run_kind<kUniform, DT, WIDE>(d, sk, blk, nblk); break;
      case kRandint: run_kind<kRandint, DT, WIDE>(d, sk, blk, nblk); break;
      case kKeep: run_kind<kKeep, DT, WIDE>(d, sk, blk, nblk); break;
      case kCounterNormal:
        run_kind<kCounterNormal, DT, WIDE>(d, sk, blk, nblk);
        break;
      case kCounterKeep:
        run_kind<kCounterKeep, DT, WIDE>(d, sk, blk, nblk);
        break;
      default: run_kind<kKey, DT, WIDE>(d, sk, blk, nblk);
    }
  }
}

long long elements(const Draw& d) {
  long long n = 1;
  for (int k = 0; k < kMaxDims; ++k) n *= d.size[k];
  return n;
}

bool valid(const Draw& d) {
  const bool mask = d.kind == kKeep || d.kind == kCounterKeep;
  if (d.kind < kNormal || d.kind > kKey || d.out == nullptr ||
      d.n_words < 0 || d.n_words > kMaxWords || d.n_global < 0) {
    return false;
  }
  if (d.kind == kKey) return d.dtype == kI64 && elements(d) == 2;
  if (mask && (d.x == nullptr || (d.dtype != kF32 && d.dtype != kBF16) ||
               d.rcp != 1.0f / d.div)) {
    return false;
  }
  if (d.kind == kRandint && d.dtype != kI32 && d.dtype != kI64) return false;

  if (!mask && d.kind != kRandint && d.dtype != kF32) return false;
  for (int k = 0; k < kMaxDims; ++k) {
    if (d.size[k] < 0 || d.start[k] < 0 || d.gstride[k] < 0) return false;
  }
  return true;
}

int vector_width(const Draw& d) {
  if (d.dtype == kBF16) return 8;
  if (d.dtype == kI64) return 2;
  return 4;
}

int multiprocessors() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    sms[dev] = n;
  }
  return sms[dev];
}

template <int CAP, int KIND, int DT = kAnyType, bool WIDE = false>
cudaError_t launch(const Draw* draws, const int* blocks, int n,
                   cudaStream_t stream) {
  List<CAP> list{};
  int total = 0;
  for (int i = 0; i < n; ++i) {
    list.d[i] = draws[i];
    list.block0[i] = total;
    total += blocks[i];
  }
  list.block0[n] = total;
  list.n = n;
  draw_kernel<CAP, KIND, DT, WIDE><<<total, kThreads, 0, stream>>>(list);
  return cudaGetLastError();
}

cudaError_t launch_one(const Draw& d, int blocks, cudaStream_t s) {
  const bool bf16 = d.dtype == kBF16;
  if (d.n_global >= kWide) {
    return launch<1, kAny, kAnyType, true>(&d, &blocks, 1, s);
  }
  switch (d.kind) {
    case kNormal: return launch<1, kNormal>(&d, &blocks, 1, s);
    case kUniform: return launch<1, kUniform>(&d, &blocks, 1, s);
    case kRandint: return launch<1, kRandint>(&d, &blocks, 1, s);
    case kKeep:
      return bf16 ? launch<1, kKeep, kBF16>(&d, &blocks, 1, s)
                  : launch<1, kKeep, kF32>(&d, &blocks, 1, s);
    case kCounterNormal: return launch<1, kCounterNormal>(&d, &blocks, 1, s);
    case kCounterKeep:
      return bf16 ? launch<1, kCounterKeep, kBF16>(&d, &blocks, 1, s)
                  : launch<1, kCounterKeep, kF32>(&d, &blocks, 1, s);
    default: return launch<1, kAny>(&d, &blocks, 1, s);
  }
}

}  // namespace

// The draws draws[0..n): each Draw names its key path, its box of the
// global shape, its output (the box's elements, contiguous) and, for a
// mask, its input. One draw launches a kernel of its kind; a list launches
// one kernel for every kLargeList draws (one for up to kSmallList), but a
// draw of a global shape of 2^31 elements or more launches alone. Draws
// with no elements launch nothing. *launched (if not null) gets the number
// of launches. Returns a cudaError_t code.
extern "C" int tdm_rng_draw_many(const void* list, int n, int* launched,
                                 void* stream) {
  const Draw* draws = static_cast<const Draw*>(list);
  if (launched != nullptr) *launched = 0;
  if (n < 0 || (n > 0 && draws == nullptr)) return int(cudaErrorInvalidValue);
  const int cap_blocks = kBlocksPerSm * multiprocessors();
  Draw todo[kLargeList];
  int blocks[kLargeList] = {};
  int m = 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto flush = [&]() -> cudaError_t {
    if (m == 0) return cudaSuccess;
    cudaError_t err;
    if (m == 1) {
      err = launch_one(todo[0], blocks[0], s);
    } else if (m <= kSmallList) {
      err = launch<kSmallList, kAny>(todo, blocks, m, s);
    } else {
      err = launch<kLargeList, kAny>(todo, blocks, m, s);
    }
    if (err == cudaSuccess && launched != nullptr) ++*launched;
    m = 0;
    return err;
  };
  for (int i = 0; i < n; ++i) {
    const Draw& d = draws[i];
    if (!valid(d)) return int(cudaErrorInvalidValue);
    const long long count = elements(d);
    if (count == 0) continue;
    if (count > d.n_global) return int(cudaErrorInvalidValue);
    // A vector a thread; past a persistent grid, more a thread.
    const long long tile = 1ll * kThreads * vector_width(d);
    long long b = (count + tile - 1) / tile;
    if (b > cap_blocks) b = cap_blocks;
    if (d.n_global >= kWide) {
      cudaError_t err = flush();
      if (err == cudaSuccess) err = launch_one(d, int(b), s);
      if (err != cudaSuccess) return int(err);
      if (launched != nullptr) ++*launched;
      continue;
    }
    todo[m] = d;
    blocks[m] = int(b);
    if (++m == kLargeList) {
      const cudaError_t err = flush();
      if (err != cudaSuccess) return int(err);
    }
  }
  return int(flush());
}
