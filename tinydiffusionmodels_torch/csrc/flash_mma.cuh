// Warp-level tile helpers shared by the tensor-core kernels (the three
// flash-attention kernels, the single-block attention pair and the fused
// resblock): asynchronous tile copies
// into shared memory, mma.sync on bf16 and on TF32, the 3xTF32 split that
// keeps float32 accuracy on the TF32 tensor cores, and the fragment loads
// of both.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 / k16"),
// with g = lane / 4 and t = lane % 4:
//   C (16 x 8, f32):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//   TF32 A (16 x 8):  a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
//   TF32 B (8 x 8):   b0 (k t, n g)   b1 (k t+4, n g)
//   bf16 A (16 x 16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)
//   bf16 B (16 x 8):  b0 (k 2t..2t+1, n g)   b1 (k 2t+8..2t+9, n g)
//
// C to A without a shuffle. A product P V whose left factor P sits in C
// fragments takes them as A fragments directly. In bf16 the C fragments of
// two neighbouring 8-column blocks are exactly the A fragment of their 16
// columns (FlashAttention-2's register reuse). In TF32 the k index of the A
// fragment is renamed: k = t stands for column 2t of the block and k = t + 4
// for column 2t + 1, so A = {c0, c2, c1, c3}, and the B fragment reads the
// right factor's rows 2t and 2t + 1 to match (`tf32_b_perm`).
//
// Shared-memory rows are padded: float rows by 4 words, bf16 rows by 8
// elements (16 bytes). So every row starts on 16 bytes (cp.async and
// ldmatrix) and the fragment loads of a warp hit 32 distinct banks.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace fmma {

constexpr int kMaxWarps = 4;   // warps per CTA, 16 rows each
constexpr int kMinCtas = 128;  // the grid the host aims for (132 SMs)

// The flash kernels' instances take the padded head width D = 16, 32, 64,
// 128 or 256. Past 128 a 16-row warp tile's accumulator no longer fits in
// registers (16 x 256 f32 is 128 per thread, twice that for dk and dv), so
// each CTA owns at most kMaxOutCols output columns: a D 256 instance runs a
// second CTA for columns 128-255, which recomputes the scores. Its tiles
// are twice as wide, so it also takes at most half the warps (shared
// memory). Past 256 all three are the wide kernels of flash_wide.cuh.
constexpr int kMaxOutCols = 128;

template <int D>
__host__ __device__ constexpr int out_cols() {
  return D < kMaxOutCols ? D : kMaxOutCols;
}

template <int D>
__host__ __device__ constexpr int max_warps() {
  return D <= 128 ? kMaxWarps : kMaxWarps / 2;
}

// Warps per CTA for `rows` owned rows of each of `bh` (batch, head) pairs:
// the most, up to `most`, that still give kMinCtas CTAs.
inline int pick_warps(int bh, int rows, int most) {
  int w = most;
  while (w > 1 && int64_t(bh) * ((rows + 16 * w - 1) / (16 * w)) < kMinCtas) {
    w /= 2;
  }
  return w;
}

// Row stride in elements of a D-wide tile of T in shared memory.
template <typename T, int D>
__host__ __device__ constexpr int stride() {
  return sizeof(T) == 4 ? D + 4 : D + 8;
}

// ---- asynchronous copies ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V bytes from global to shared memory, of which the first `src_bytes` are
// read and the rest zero-filled. Both addresses are V-aligned.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(V), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T, int D, int V>
__device__ __forceinline__ void load_tile_v(T* dst, const T* src, int64_t ld,
                                            int r0, int rows, int limit,
                                            int cols) {
  constexpr int S = stride<T, D>();
  constexpr int E = V / int(sizeof(T));  // elements per copy
  constexpr int kChunks = D / E;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * E;
    const int gr = r0 + r;
    const int n = gr < limit ? max(0, min(E, cols - c)) : 0;
    const T* s = n > 0 ? src + int64_t(gr) * ld + c : src;
    if constexpr (V == 2) {  // one bf16: no cp.async of 2 bytes
      dst[r * S + c] = n > 0 ? *s : zero<T>();
    } else {
      cp_async<V>(dst + r * S + c, s, n * int(sizeof(T)));
    }
  }
}

// Rows [r0, r0 + rows) of a row-major operand (row stride `ld` elements,
// `cols` columns) into a D-wide shared tile of stride<T, D>(); rows at or
// past `limit` and columns at or past `cols` are zeros. `vec` is the width
// of each copy in bytes (16, 8 or 4 by cp.async; 2, bf16 only, by plain
// loads), the widest that the operand's address and strides allow (chosen
// by the host). The cp.async copies join the thread's open group.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ld,
                                          int r0, int rows, int limit,
                                          int cols, int vec) {
  switch (vec) {
    case 16: load_tile_v<T, D, 16>(dst, src, ld, r0, rows, limit, cols); break;
    case 8: load_tile_v<T, D, 8>(dst, src, ld, r0, rows, limit, cols); break;
    case 4: load_tile_v<T, D, 4>(dst, src, ld, r0, rows, limit, cols); break;
    default:
      if constexpr (sizeof(T) == 2) {
        load_tile_v<T, D, 2>(dst, src, ld, r0, rows, limit, cols);
      }
      break;
  }
}

// n floats src[i0 .. i0 + n) into dst[0 .. n), zeros past `limit`.
__device__ __forceinline__ void load_row_f32(float* dst, const float* src,
                                             int i0, int n, int limit) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = i0 + i < limit;
    cp_async<4>(dst + i, in ? src + i0 + i : src, in ? 4 : 0);
  }
}

// ---- TF32 ------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 22 bits: big is x rounded to TF32, small the
// rest rounded to TF32.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

template <int N>
struct Split {
  uint32_t big[N], small[N];
  Split() = default;
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j] += a b[j] for the N blocks j in float32 accuracy on the TF32 tensor
// cores (3xTF32): small*big + big*small + big*big; small*small (2^-22
// relative) is dropped. The terms go block by block: mma.sync issues in
// order, and each of the three products into one fragment waits for the
// one before it, so consecutive products must be of other blocks.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const Split<4>& a,
                                           const Split<2> (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], a.big, b[j].big);
}

// Blocks per 3xTF32 group: enough independent products to cover the
// latency of one, few enough B fragments (4 registers each) to stay in
// registers.
constexpr int kTermBlocks = 4;

// TF32 A fragment of rows [0, 16) and columns [k0, k0 + 8) of a row-major
// float tile with row stride S.
template <int S>
__device__ __forceinline__ Split<4> tf32_a(const float* tile, int k0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = tile + g * S + k0 + t;
  const float a[4] = {p[0], p[8 * S], p[4], p[8 * S + 4]};
  return Split<4>(a);
}

// TF32 B fragment of B = X^T, X a row-major float tile with row stride S:
// B (k, n) = X[n0 + n][k0 + k].
template <int S>
__device__ __forceinline__ Split<2> tf32_b_t(const float* tile, int n0,
                                             int k0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = tile + (n0 + g) * S + k0 + t;
  const float b[2] = {p[0], p[4]};
  return Split<2>(b);
}

// TF32 B fragment of rows [k0, k0 + 8) of a row-major float tile (k the
// row), columns [n0, n0 + 8): B (k, n) = X[k0 + k][n0 + n].
template <int S>
__device__ __forceinline__ Split<2> tf32_b(const float* tile, int k0,
                                           int n0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = tile + (k0 + t) * S + n0 + g;
  const float b[2] = {p[0], p[4 * S]};
  return Split<2>(b);
}

// TF32 B fragment of rows [k0, k0 + 8) of a row-major float tile (k the
// row), in the renamed k order of an A fragment taken from C fragments:
// k = t reads row k0 + 2t, k = t + 4 reads row k0 + 2t + 1.
template <int S>
__device__ __forceinline__ Split<2> tf32_b_perm(const float* tile, int k0,
                                                int n0) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = tile + (k0 + 2 * t) * S + n0 + g;
  const float b[2] = {p[0], p[S]};
  return Split<2>(b);
}

// The A fragment of a 16 x 8 block of a product's left factor held in C
// fragments (the k order tf32_b_perm reads).
__device__ __forceinline__ Split<4> tf32_a_from_c(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return Split<4>(a);
}

// ---- bf16 ------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// bf16 A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major
// tile with row stride S.
template <int S>
__device__ __forceinline__ void bf16_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + (lane & 15) * S + k0 + (lane >> 4) * 8);
}

// bf16 B fragments of B = X^T for two 8-column blocks n0 and n0 + 8,
// B (k, n) = X[n0 + n][k0 + k], k in [0, 16): {b0, b1} of block n0 in
// b[0], b[1], of block n0 + 8 in b[2], b[3].
template <int S>
__device__ __forceinline__ void bf16_b_t(uint32_t (&b)[4],
                                         const __nv_bfloat16* tile, int n0,
                                         int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * S + k0 +
                 ((lane >> 3) & 1) * 8);
}

// bf16 B fragments of rows [k0, k0 + 16) of a row-major tile (k the row),
// columns n0 .. n0 + 16 as two 8-column blocks, laid out as bf16_b_t's.
template <int S>
__device__ __forceinline__ void bf16_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int k0,
                                       int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                       n0 + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 A fragment of 16 columns of a left factor held as the C
// fragments of its two 8-column blocks, each rounded to bf16.
__device__ __forceinline__ void bf16_a_from_c(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ---- tile products ---------------------------------------------------------

// acc[j] (16 x 8 C fragments, j < NB) += A B^T over the first `depth`
// columns (rounded up to the k step) of at most D: A the warp's 16 rows of
// a row-major tile `a`, B^T the rows [8j, 8j + 8) of a row-major tile `b`;
// both with the row stride of an SD-wide tile, stride<T, SD>() (SD = D: the
// tiles are D wide; the wide kernels take D columns of wider tiles).
// Columns of both are contiguous, so this is Q K^T, or K Q^T, V dO^T in the
// dk/dv kernel.
template <int NB, int D, int SD = D>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], const float* a,
                                        const float* b, int depth) {
  constexpr int S = stride<float, SD>();
  constexpr int kGroup = NB < kTermBlocks ? NB : kTermBlocks;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 8) {
    if (k0 >= depth) break;
    const Split<4> fa = tf32_a<S>(a, k0);
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += kGroup) {
      Split<2> fb[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) fb[j] = tf32_b_t<S>(b, 8 * (j0 + j), k0);
      mma_3xtf32<kGroup>(acc + j0, fa, fb);
    }
  }
}

template <int NB, int D, int SD = D>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int depth) {
  constexpr int S = stride<__nv_bfloat16, SD>();
  static_assert(NB % 2 == 0, "bf16 B fragments come in pairs of blocks");
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    if (k0 >= depth) break;
    uint32_t fa[4];
    bf16_a<S>(fa, a, k0);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t fb[4];
      bf16_b_t<S>(fb, b, 8 * j, k0);
      mma_bf16(acc[j], fa, fb[0], fb[1]);
      mma_bf16(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// out[n] (16 x 8 C fragments, n < DO / 8, blocks at or past `width` left
// alone) += P X: P the warp's 16 x (8 NB) left factor held in C fragments
// p[j], X the first DO columns of the rows [0, 8 NB) of a row-major tile
// with the row stride of a D-wide tile (P V and dS K, or P^T dO and dS^T Q
// in the dk/dv kernel; X may start at a column offset into the tile). Blocks j at or past `k_blocks` are skipped
// (their P is zero). In bf16, P is rounded to bf16 here.
//
// The products of one call sum into zeroed fragments, which are then added
// to `out` in f32: the tensor cores' f32 accumulation truncates, so one
// fragment that takes every product of a long walk drifts (P V over L 2048
// was off by 7e-5 on the card). Output blocks go in chunks of up to 8, so
// the zeroed fragments cost at most 32 registers.
constexpr int kChunkBlocks = 8;

// GROUP: output blocks a 3xTF32 group (kTermBlocks; the wide kernels, one
// warp a scheduler, take 8, so that twice the products are in flight).
template <int NB, int DO, int D, int GROUP = kTermBlocks>
__device__ __forceinline__ void mma_cx(float (&out)[DO / 8][4],
                                       const float (&p)[NB][4],
                                       const float* x, int width,
                                       int k_blocks) {
  constexpr int S = stride<float, D>();
  constexpr int kChunk = DO / 8 < kChunkBlocks ? DO / 8 : kChunkBlocks;
  constexpr int kGroup = kChunk < GROUP ? kChunk : GROUP;
#pragma unroll
  for (int n0 = 0; n0 < DO / 8; n0 += kChunk) {
    if (8 * n0 >= width) break;
    float part[kChunk][4] = {};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j >= k_blocks) break;
      const Split<4> fa = tf32_a_from_c(p[j]);
#pragma unroll
      for (int n = 0; n < kChunk; n += kGroup) {
        if (8 * (n0 + n) >= width) break;  // whole groups: zeros past width
        Split<2> fb[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          fb[i] = tf32_b_perm<S>(x, 8 * j, 8 * (n0 + n + i));
        }
        mma_3xtf32<kGroup>(part + n, fa, fb);
      }
    }
#pragma unroll
    for (int n = 0; n < kChunk; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[n0 + n][c] += part[n][c];
    }
  }
}

template <int NB, int DO, int D, int GROUP = kTermBlocks>
__device__ __forceinline__ void mma_cx(float (&out)[DO / 8][4],
                                       const float (&p)[NB][4],
                                       const __nv_bfloat16* x, int width,
                                       int k_blocks) {
  constexpr int S = stride<__nv_bfloat16, D>();
  constexpr int kChunk = DO / 8 < kChunkBlocks ? DO / 8 : kChunkBlocks;
  static_assert(NB % 2 == 0, "bf16 A fragments take pairs of blocks");
#pragma unroll
  for (int n0 = 0; n0 < DO / 8; n0 += kChunk) {
    if (8 * n0 >= width) break;
    float part[kChunk][4] = {};
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      if (j >= k_blocks) break;
      uint32_t fa[4];
      bf16_a_from_c(fa, p[j], p[j + 1]);
#pragma unroll
      for (int n = 0; n < kChunk; n += 2) {
        if (8 * (n0 + n) >= width) break;
        uint32_t fb[4];
        bf16_b<S>(fb, x, 8 * j, 8 * (n0 + n));
        mma_bf16(part[n], fa, fb[0], fb[1]);
        mma_bf16(part[n + 1], fa, fb[2], fb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kChunk; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[n0 + n][c] += part[n][c];
    }
  }
}

// acc[j] (16 x 8 C fragments, j < NB) += A X over the first `depth` k (a
// multiple of the k step): A the 16 rows of a row-major tile `a` (row stride
// SA), X the columns [n0, n0 + 8 NB) of a row-major tile `x` (row stride SX,
// k the row). Both factors come from shared memory (the single-block
// backward's dS K, dS^T Q and P^T dO).
template <int NB, int SA, int SX>
__device__ __forceinline__ void mma_ab(float (&acc)[NB][4], const float* a,
                                       const float* x, int n0, int depth) {
  for (int k0 = 0; k0 < depth; k0 += 8) {
    const Split<4> fa = tf32_a<SA>(a, k0);
    Split<2> fb[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) fb[j] = tf32_b<SX>(x, k0, n0 + 8 * j);
    mma_3xtf32<NB>(acc, fa, fb);
  }
}

template <int NB, int SA, int SX>
__device__ __forceinline__ void mma_ab(float (&acc)[NB][4],
                                       const __nv_bfloat16* a,
                                       const __nv_bfloat16* x, int n0,
                                       int depth) {
  static_assert(NB % 2 == 0, "bf16 B fragments come in pairs of blocks");
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t fa[4];
    bf16_a<SA>(fa, a, k0);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t fb[4];
      bf16_b<SX>(fb, x, k0, n0 + 8 * j);
      mma_bf16(acc[j], fa, fb[0], fb[1]);
      mma_bf16(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// ---- combining warps -------------------------------------------------------

// A warp's C fragments out[n] (n < N) to shared memory at `dst`, laid out
// [n][c][lane] so that the stores and loads of a warp hit 32 banks.
template <int N>
__device__ __forceinline__ void stash(float* dst, const float (&out)[N][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(4 * n + c) * 32 + lane] = out[n][c];
  }
}

// The fragment element (n, c) of this lane in a stash.
__device__ __forceinline__ float stashed(const float* src, int n, int c) {
  return src[(4 * n + c) * 32 + threadIdx.x % 32];
}

}  // namespace fmma
