// Persistent guided-decode kernel for Hopper (sm_90a): the whole AR +
// diffusion greedy decode of TinyGPT, all L positions, in one cooperative
// launch.
//
// Replaces the TPU kernel `_decode_kernel` of
// tinydiffusionmodels_tpu/ops/decode_kernel.py (driven by
// `fused_guided_decode` there). The TPU kernel walks positions on a
// sequential grid with ~10 MB of bf16 weights resident in VMEM. Per
// position and row it gathers the token and position embeddings, runs
// `depth` pre-LN GPT blocks (LN1, fused QKV, a bf16 KV cache written at
// `pos`, softmax over slots <= pos, projection; LN2, tanh-GELU MLP), the
// final LN and the LM head, mixes the head's logits with the diffusion
// logits (`sample/guided.mix_logits`, raw or probability-space), and takes
// the greedy argmax (lowest index on ties), which is the next position's
// token. Weights are bf16, activations are rounded to bf16 before each
// product, every sum is f32.
//
// What bounds it here. Per token the work is ~8.4 MFLOP at the bench shape
// (V 4096, D 256, depth 4) over ~8.4 MB of bf16 weights. At batch 8 that is
// far below both roofs; the real bound is the serial chain: 64 positions of
// dependent phases, each of which needs every row of the phase before it.
// On the H100 a phase costs its grid barrier (~1 us at 128 CTAs) plus the
// latency of the instructions one warp issues in it: with one CTA of 8
// warps an SM, the staging and the epilogues are bound by instructions
// issued, far more than by bytes (chip_smoke.py's phase stamps; PERF.md).
//
// What the design does about it.
// - One persistent cooperative grid walks the positions; a phase is a set
//   of units spread over every CTA, and a grid barrier (one arrival counter,
//   `red.release.gpu` and an `ld.acquire.gpu` poll by one thread per CTA)
//   separates phases. A layer is five phases: LN1 + QKV (q to scratch, k
//   and v straight into the bf16 cache at `pos`); attention (a CTA takes
//   (row, head) pairs, their slots split over its warps, each walking its
//   slots 256 scores at a time, merged in shared memory; the output stored
//   bf16, the value the projection rounds it to); projection; LN2 + FC +
//   GELU (stored bf16 likewise); MLP. After
//   the last layer, final LN + head: the head's epilogue mixes its column
//   tile with the diffusion logits and writes a per-row (best, first index)
//   partial, which the next position's first phase merges (raw mixing;
//   `normalize` needs the global max and sum first and keeps one reduce
//   phase). So 5 depth + 1 barriers a position (21 at depth 4), one more
//   with `normalize`.
// - A unit is (rows, n8 column blocks, k32 chunks), chosen per phase on the
//   host (`ops/decode_kernel.plan`) from B, N and K so that each phase
//   fills one wave of the card (as many units as SMs, no more; K split
//   where N is small); M is padded to 16 rows. A unit walks its
//   K in tiles of at most `ktile` chunks, sized by the host to the shared
//   memory: one tile at the bench shape, more for wide models, so every D
//   and F fit (a LayerNorm phase then keeps each row's mean and 1 / std in
//   shared memory and normalises each tile as it stages it). The phase code
//   is inlined once (the kernel's loop over a position's steps calls it
//   from one site), so the parameters stay in the constant bank.
// - Where N is small (projection, MLP) K is split over units. No float
//   atomics: the next LayerNorm phase adds the partial slices in a fixed
//   order while it stages its rows, and the CTAs of its first column group
//   write the summed residual to the other half of a ping-pong x. Two
//   launches give identical tokens.
// - Weights come from a packed layout built once on the host
//   (`pack_weights`): per (n8 block, k32 chunk) the 32 lanes' mma.sync B
//   fragments, 16 bytes a lane, copied by cp.async into shared memory while
//   the unit's left factor is staged. Activations move in 16-byte loads
//   (x and the slices as float4, bf16 rows as uint4; a LayerNorm's scale
//   and bias as 8-byte read-only loads).
// - Products are mma.sync.m16n8k16 bf16 with f32 accumulation; the left
//   factor (activations, LayerNorm'd and rounded to bf16) is read with
//   ldmatrix. The warps of a unit split its columns and then K; their
//   partial tiles are added in a fixed order.
//
// C entry points: tdm_guided_decode, tdm_grid_sync_probe (plain C
// interface, loaded with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMt = 4;    // m16 tiles of a warp: at most 64 rows a unit
constexpr int kMaxNbw = 2;   // n8 blocks of a warp: at most 128 columns
constexpr int kLnRegs = 8;   // row elements a lane keeps in registers
constexpr int kScoreChunk = 256;  // attention scores a warp holds at once
constexpr int kOutChunk = 256;    // and output columns of a (row, head)
constexpr int kSmemMax = 232448;  // 227 KB, the most a CTA may use

typedef __nv_bfloat16 bf16;

enum Phase { kQkv, kProj, kFc, kMlp, kHead, kPhases };
constexpr int kPlanInts = 8;

// One phase's tiling, chosen on the host. A unit is `rows` batch rows x
// `ncols` n8 column blocks x `kchunks` k32 chunks, staged `ktile` chunks at
// a time; units are numbered (row tile, k split, column group), column
// group fastest.
struct Plan {
  int rows, ncols, kchunks, row_tiles, col_groups, ksplit, units, ktile;
};

struct Params {
  // Weights (bf16). Embeddings, LayerNorms and biases as DecodeWeights
  // holds them; the five matrices in the packed fragment layout.
  const bf16* tok_emb;  // (V, D)
  const bf16* pos_emb;  // (T, D)
  const bf16* ln;       // (depth, 4, D): ln1 scale, ln1 bias, ln2 scale, bias
  const bf16* qkv_b;    // (depth, 3D)
  const bf16* proj_b;   // (depth, D)
  const bf16* fc_b;     // (depth, F)
  const bf16* mlp_b;    // (depth, D)
  const bf16* ln_f;     // (2, D)
  const uint4* wp[kPhases];  // packed (depth, N8, KC, 32 lanes) x 16 bytes
  int wkc[kPhases];          // k32 chunks of each packed matrix
  const bf16* diff;     // (B, L, V) diffusion logits
  // Scratch, written and read by the kernel.
  float* x[2];      // (B, D) residual stream, ping-pong
  float* q;         // (B, D)
  float* pproj;     // (ksplit, B, D) projection partials
  float* pmlp;      // (ksplit, B, D) MLP partials
  bf16* hid;        // (B, F8) GELU output, F8 = F rounded up to 8
  bf16* attn;       // (B, D8) attention output, D8 = D rounded up to 8
  float* logits;    // (B, V) head logits / temperature (normalize only)
  float* best;      // (B, head col groups) per-tile best mixed score
  int* best_idx;    // (B, head col groups) its first index
  float* stats;     // (B, head col groups, 2) per-tile max, sum exp
  float* dstats;    // (B, L, 2) diffusion max, sum exp (normalize only)
  bf16* kc;         // (depth, B, H, T, Dh)
  bf16* vc;         // (depth, B, H, T, Dh)
  int* tokens;      // (B, L) output
  unsigned* bar;    // grid barrier counter, 0 at launch
  unsigned long long* trace;  // null, or 4 %globaltimer stamps a barrier
  int B, L, V, D, D8, H, F, F8, T, depth, bos;
  float coef_ar, coef_diff, inv_t;  // (1 - alpha), alpha, 1 / temperature
  int normalize;
  Plan plan[kPhases];
  // Shared-memory offsets (bytes): the reduction tile, the attention's
  // scores and partial outputs, and the staged rows' LayerNorm statistics.
  // A unit's left factor lies at 0 and its packed weights right after it.
  int red_off, att_off, stat_off;
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float ldw(const bf16* p) {
  return __bfloat162float(__ldg(p));
}
// Data the kernel itself wrote (other CTAs, behind a barrier): read at L2.
__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldb(const bf16* p) {
  return __bfloat162float(__ldcg(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (best, idx) across the warp: the larger score, the lower index on ties.
__device__ __forceinline__ void warp_argmax(float& best, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True).
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *
                                  (x + 0.044715f * x * x * x)));
}

// %globaltimer (ns), for the measurement-only phase stamps.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier: every CTA adds one to the counter (release) and waits
// until it reaches this generation's target (acquire). The counter only
// grows, so no reset or sense flip is needed within a launch. A wait of
// more than ~2^35 cycles (about 20 s) traps: a fault becomes a launch
// error instead of a hung card. CTA 0 stamps the release into `trace`.

__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& target,
                                             unsigned long long* trace =
                                                 nullptr) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    const long long t0 = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if (clock64() - t0 > (1ll << 35)) __trap();
    } while (v < target);
    if (trace != nullptr && blockIdx.x == 0)
      trace[4 * (target / gridDim.x)] = global_ns();
  }
  __syncthreads();
}

// Greedy token of row b at the position whose head partials are in
// best / best_idx: the merge of the column tiles' (best, first index).
__device__ int merge_token(const Params& p, int b) {
  const int lane = threadIdx.x & 31;
  const int cgs = p.plan[kHead].col_groups;
  float best = -INFINITY;
  int idx = INT_MAX;
  for (int c = lane; c < cgs; c += 32) {
    const size_t i = static_cast<size_t>(b) * cgs + c;
    const float ob = __ldcg(p.best + i);
    const int oi = __ldcg(p.best_idx + i);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
  warp_argmax(best, idx);
  return idx == INT_MAX ? 0 : idx;  // all-NaN row: token 0
}

// The residual stream as the next LayerNorm phase reads it: the token and
// position embedding (layer 0), or x plus the split-K partial slices of the
// phase before (added in slice order, then their bias).
struct Stream {
  int xb;              // current x buffer
  const float* parts;  // (nparts, B, D) or null
  int nparts;
  const bf16* bias;    // added to the slices' sum
};

// V consecutive floats of x or a slice (V = 4: one 16-byte load).
template <int V>
__device__ __forceinline__ void load_f(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = ldf(p);
  }
}

// V consecutive read-only bf16 (V = 4: one 8-byte load).
template <int V>
__device__ __forceinline__ void load_b(float (&v)[V], const bf16* p) {
  if constexpr (V == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = bf(e[i]);
  } else {
    v[0] = ldw(p);
  }
}

// Stages rows [r0, r0 + rows) of the stream, after a LayerNorm with
// (scale, bias), as the bf16 left factor a_s: columns [k0, k0 + kt) of the
// row (row stride S; columns past D zero). One warp a row. The tile at
// k0 = 0 computes the row's mean and 1 / std, keeping kLnRegs elements a
// lane in registers (V consecutive ones a load: V = 4 where D is a
// multiple of 4, 16-byte loads of x and of each slice, all issued
// together, then 8-byte loads of the scale and bias) and re-reading the
// rest, and leaves
// them (and the row's token) in rstat (4 floats a row) for the tiles after
// it. With `embed` the row is the embedding of its token (bos, or the merge
// of the last position's head partials). Where `xout` is not null the tile
// at 0 writes the summed row there (and, with `embed`, the token to the
// output).
template <int V>
__device__ __forceinline__ void stage_ln(const Params& p, const Stream& st,
                                         bool embed, int pos, int r0,
                                         int rows, int k0, int kt,
                                         const bf16* scale, const bf16* bias,
                                         bf16* a_s, int S, float* xout,
                                         float* rstat) {
  constexpr int kN = kLnRegs / V;  // loads a lane for the cached part
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = p.D, k1 = k0 + kt;
  const size_t slice = static_cast<size_t>(p.B) * D;
  const float* xin = p.x[st.xb];
  for (int r = warp; r < rows; r += kWarps) {
    const int b = r0 + r;
    bf16* dst = a_s + r * S;  // dst[k - k0]: column k of the row
    float* rs = rstat + 4 * r;
    if (b >= p.B) {
      for (int k = k0 + lane; k < k1; k += 32)
        dst[k - k0] = __float2bfloat16(0.f);
      continue;
    }
    const size_t off = static_cast<size_t>(b) * D;
    const bf16* pos_row = p.pos_emb + static_cast<size_t>(pos) * D;
    int tok = p.bos;
    if (embed && k0 > 0) {
      tok = __float_as_int(rs[2]);
    } else if (embed && pos > 0) {
      tok = merge_token(p, b);
      if (xout != nullptr && lane == 0)
        p.tokens[static_cast<size_t>(b) * p.L + pos - 1] = tok;
    }
    const bf16* tok_row = p.tok_emb + static_cast<size_t>(tok) * D;
    auto val = [&](int k) {  // one element of the row (the uncached part)
      if (embed) return ldw(tok_row + k) + ldw(pos_row + k);
      float t = 0.f;
      for (int i = 0; i < st.nparts; ++i) t += ldf(st.parts + i * slice + off + k);
      return st.nparts > 0 ? ldf(xin + off + k) + (t + ldw(st.bias + k))
                           : ldf(xin + off + k);
    };
    if (k0 > 0) {  // a later tile: the statistics of the tile at 0
      const float mu = rs[0], rstd = rs[1];
      for (int k = k0 + lane; k < k1; k += 32)
        dst[k - k0] = k < D ? __float2bfloat16((val(k) - mu) * rstd *
                                                   ldw(scale + k) +
                                               ldw(bias + k))
                            : __float2bfloat16(0.f);
      continue;
    }
    // Elements k = V lane + 32 V i + e, i < kN, stay in registers.
    float x[kN][V], sc[kN][V], bi[kN][V];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int k = V * lane + 32 * V * i;
#pragma unroll
      for (int e = 0; e < V; ++e) x[i][e] = sc[i][e] = bi[i][e] = 0.f;
      if (k < D) {
        if (embed) {
          float t[V], q[V];
          load_b<V>(t, tok_row + k);
          load_b<V>(q, pos_row + k);
#pragma unroll
          for (int e = 0; e < V; ++e) x[i][e] = t[e] + q[e];
        } else {
          load_f<V>(x[i], xin + off + k);
        }
      }
    }
    if (!embed && st.nparts > 0) {
      float t[kN][V];
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) t[i][e] = 0.f;
      for (int j = 0; j < st.nparts; ++j)
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int k = V * lane + 32 * V * i;
          if (k < D) {
            float u[V];
            load_f<V>(u, st.parts + j * slice + off + k);
#pragma unroll
            for (int e = 0; e < V; ++e) t[i][e] += u[e];
          }
        }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int k = V * lane + 32 * V * i;
        if (k < D) {
          float bb[V];
          load_b<V>(bb, st.bias + k);
#pragma unroll
          for (int e = 0; e < V; ++e) x[i][e] += t[i][e] + bb[e];
        }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) s += x[i][e];
    for (int k = lane + 32 * kLnRegs; k < D; k += 32) s += val(k);
    const float mu = warp_sum(s) / D;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = x[i][e] - mu;
        if (V * lane + 32 * V * i < D) var += d * d;
      }
    for (int k = lane + 32 * kLnRegs; k < D; k += 32) {
      const float d = val(k) - mu;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / D + 1e-5f);
    // The scale and bias only now: loaded with x they push the kernel
    // past 255 registers.
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int k = V * lane + 32 * V * i;
      if (k < D) {
        load_b<V>(sc[i], scale + k);
        load_b<V>(bi[i], bias + k);
      }
    }
    if (lane == 0) {
      rs[0] = mu;
      rs[1] = rstd;
      rs[2] = __int_as_float(tok);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int k = V * lane + 32 * V * i;
      if (k >= D) break;
      bf16 o[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        o[e] = __float2bfloat16((x[i][e] - mu) * rstd * sc[i][e] + bi[i][e]);
      if constexpr (V == 4) {
        if (k < k1)  // k1 is a multiple of 32: the 4 columns are in the tile
          *reinterpret_cast<uint2*>(dst + k) = *reinterpret_cast<const uint2*>(o);
        if (xout)
          *reinterpret_cast<float4*>(xout + off + k) =
              make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
      } else {
        if (k < k1) dst[k] = o[0];
        if (xout) xout[off + k] = x[i][0];
      }
    }
    for (int k = lane + 32 * kLnRegs; k < D; k += 32) {
      if (k >= k1 && xout == nullptr) break;
      const float v = val(k);
      if (k < k1)
        dst[k] = __float2bfloat16((v - mu) * rstd * ldw(scale + k) +
                                  ldw(bias + k));
      if (xout) xout[off + k] = v;
    }
    for (int k = D + lane; k < k1; k += 32) dst[k] = __float2bfloat16(0.f);
  }
}

// E bf16 of a cache row (E = 8: one 16-byte load) as floats.
template <int E>
__device__ __forceinline__ void load_cache(float (&v)[E], const bf16* p) {
  if constexpr (E == 8) {
    const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = bf(e[i]);
  } else {
    v[0] = ldb(p);
  }
}

// One chunk of a warp's share of a (row, head) attention: slots
// [t_lo, t_hi) of the cache (at most kScoreChunk), unnormalised. The lanes
// are (slot j, chunk group c): `lps` lanes share a cache row, each taking
// G chunks of E elements (E = 8: 16-byte loads) with its slice of q in
// registers, so a warp reads 32 / lps rows at once (8 at Dh 64); the chunk
// sums meet by shuffles. Merges the chunk's max score, sum of exp(s - max)
// and output sum exp(s - max) v of output columns [o0, o1) (multiples of
// E) into `part` (m, z, then o1 - o0 floats from part + 4; `first` starts
// them). qg is the row's q (f32, global), sc room for the chunk's scores.
template <int E, int G>
__device__ void attend_slots(const bf16* ks, const bf16* vs, int t_lo,
                             int t_hi, int dh, int o0, int o1,
                             const float* qg, float* sc, float* part,
                             bool first) {
  const int lane = threadIdx.x & 31;
  const int nck = dh / E, ngr = (nck + G - 1) / G;
  int lps = 1;
  while (lps < ngr && lps < 32) lps <<= 1;
  const int spp = 32 / lps, j = lane / lps, c = lane % lps;
  const float rsd = sqrtf(static_cast<float>(dh));
  for (int g0 = 0; g0 < nck; g0 += lps * G) {  // one pass where dh <= lps G E
    const int cb = g0 + c * G;
    float q[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if constexpr (E == 8) {  // q rows start on 16 bytes where dh % 8 == 0
        float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
        if (cb + g < nck) {
          load_f<4>(lo, qg + (cb + g) * E);
          load_f<4>(hi, qg + (cb + g) * E + 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) q[g][e] = lo[e], q[g][4 + e] = hi[e];
      } else {
        q[g][0] = cb + g < nck ? ldf(qg + cb + g) : 0.f;
      }
    }
#pragma unroll 4
    for (int t0 = t_lo; t0 < t_hi; t0 += spp) {
      const int t = t0 + j;
      float sg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        sg[g] = 0.f;
        if (t < t_hi && cb + g < nck) {
          float k[E];
          load_cache<E>(k, ks + static_cast<size_t>(t) * dh + (cb + g) * E);
#pragma unroll
          for (int e = 0; e < E; ++e) sg[g] += q[g][e] * k[e];
        }
      }
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) s += sg[g];
      for (int o = 1; o < lps; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (t < t_hi && c == 0) sc[t - t_lo] = g0 == 0 ? s : sc[t - t_lo] + s;
    }
  }
  __syncwarp();
  float m = -INFINITY;
  for (int t = t_lo + lane; t < t_hi; t += 32) {
    const float s = sc[t - t_lo] / rsd;
    sc[t - t_lo] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float z = 0.f;
  for (int t = t_lo + lane; t < t_hi; t += 32) {
    const float e = expf(sc[t - t_lo] - m);
    sc[t - t_lo] = e;
    z += e;
  }
  z = warp_sum(z);
  // The running (max, sum, output) of earlier chunks, rescaled to the new
  // max: fa for them, fb for this chunk.
  const float m_run = first ? -INFINITY : part[0];
  const float mm = fmaxf(m_run, m);
  const float fa = first ? 0.f : expf(m_run - mm), fb = expf(m - mm);
  __syncwarp();
  const int oc0 = o0 / E, oc1 = o1 / E;  // the output's chunks
  for (int g0 = oc0; g0 < oc1; g0 += lps * G) {
    const int cb = g0 + c * G;
    float o[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) o[g][e] = 0.f;
#pragma unroll 4
    for (int t = t_lo + j; t < t_hi; t += spp) {
      const float pt = sc[t - t_lo];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (cb + g >= oc1) break;
        float v[E];
        load_cache<E>(v, vs + static_cast<size_t>(t) * dh + (cb + g) * E);
#pragma unroll
        for (int e = 0; e < E; ++e) o[g][e] += pt * v[e];
      }
    }
    for (int off = lps; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[g][e] += __shfl_xor_sync(0xffffffffu, o[g][e], off);
    if (j == 0)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (cb + g < oc1)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float* pd = part + 4 + (cb + g) * E + e - o0;
            *pd = first ? o[g][e] : *pd * fa + o[g][e] * fb;
          }
  }
  __syncwarp();
  if (lane == 0) {
    part[0] = mm;
    part[1] = first ? z : part[1] * fa + z * fb;
  }
  __syncwarp();
}

// The attention phase: softmax(q k^T / sqrt(dh)) v over cache slots
// 0..pos for every (row, head). A CTA takes P pairs at once (P a power of
// two up to kWarps, from B H over the grid), each on kWarps / P warps that
// split the slots and merge their (max, sum, partial output) in shared
// memory, in warp order; the output goes to attn as bf16 (the value the
// projection rounds it to), with the row's padding columns D..D8 zero.
// Heads wider than kOutChunk take their output columns kOutChunk at a
// time, each pass recomputing the scores.
__device__ __forceinline__ void attention_phase(const Params& p, int layer,
                                                int pos, unsigned char* smem) {
  const int warp = threadIdx.x >> 5;
  const int D = p.D, dh = D / p.H, dh4 = (dh + 3) & ~3;
  // a warp's scores, (m, z) and partial output
  const int stride = kScoreChunk + 4 + (dh4 < kOutChunk ? dh4 : kOutChunk);
  float* att = reinterpret_cast<float*>(smem + p.att_off);
  const int pairs = p.B * p.H, G = gridDim.x, bx = blockIdx.x;
  int P = 1;
  while (P < kWarps && P * G < pairs) P <<= 1;
  const int S = kWarps / P;  // warps a pair
  const int units = (pairs + P - 1) / P;
  const int u0 = (bx * units + G - 1) / G, u1 = ((bx + 1) * units + G - 1) / G;
  const int nt = pos + 1, per = (nt + S - 1) / S;
  for (int u = u0; u < u1; ++u) {
    for (int o0 = 0; o0 < dh; o0 += kOutChunk) {
      const int o1 = min(dh, o0 + kOutChunk), on = o1 - o0;
      const int pr = u * P + warp / S, sw = warp % S;
      __syncthreads();  // the last pass is done with att
      if (pr < pairs) {
        const int b = pr / p.H, h = pr % p.H;
        const size_t slab =
            ((static_cast<size_t>(layer) * p.B + b) * p.H + h) * p.T * dh;
        const int t_lo = min(nt, sw * per), t_hi = min(nt, t_lo + per);
        const float* qg = p.q + static_cast<size_t>(b) * D + h * dh;
        float* sc = att + warp * stride;
        float* part = sc + kScoreChunk;
        if (t_lo >= t_hi && (threadIdx.x & 31) == 0) {  // no slots
          part[0] = -INFINITY;
          part[1] = 0.f;
        }
        for (int c0 = t_lo; c0 < t_hi; c0 += kScoreChunk) {
          const int c1 = min(t_hi, c0 + kScoreChunk);
          if ((dh & 7) == 0)
            attend_slots<8, 2>(p.kc + slab, p.vc + slab, c0, c1, dh, o0, o1,
                               qg, sc, part, c0 == t_lo);
          else
            attend_slots<1, 1>(p.kc + slab, p.vc + slab, c0, c1, dh, o0, o1,
                               qg, sc, part, c0 == t_lo);
        }
      }
      __syncthreads();
      // Merge each pair's S warps: a thread an output element.
      for (int i = threadIdx.x; i < P * on; i += kThreads) {
        const int q = i / on, d = o0 + i % on, pr = u * P + q;
        if (pr >= pairs) break;
        const int b = pr / p.H, h = pr % p.H;
        const float* base = att + q * S * stride + kScoreChunk;
        float mx = -INFINITY;
        for (int w = 0; w < S; ++w) mx = fmaxf(mx, base[w * stride]);
        float z = 0.f, o = 0.f;
        for (int w = 0; w < S; ++w) {
          const float* pw = base + w * stride;
          if (pw[0] == -INFINITY) continue;  // a warp without slots
          const float f = expf(pw[0] - mx);
          z += pw[1] * f;
          o += pw[4 + d - o0] * f;
        }
        p.attn[static_cast<size_t>(b) * p.D8 + h * dh + d] =
            __float2bfloat16(o / z);
        if (h == p.H - 1)
          for (int e = d; e < p.D8 - D; e += dh)
            p.attn[static_cast<size_t>(b) * p.D8 + D + e] =
                __float2bfloat16(0.f);
      }
    }
  }
}

// Rows [r0, r0 + rows) of a bf16 activation `src` (row stride ld, a
// multiple of 8 whose columns past the data are zeros), columns
// [k0, k0 + kp), as the bf16 left factor (zeros past B and past ld).
__device__ void stage_bf16(const Params& p, const bf16* src, int ld, int r0,
                           int rows, int k0, int kp, bf16* a_s, int S) {
  const int per_row = kp / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, k = (i % per_row) * 8;
    const int b = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (b < p.B && k0 + k < ld)
      v = __ldcg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(b) * ld + k0 + k));
    *reinterpret_cast<uint4*>(a_s + r * S + k) = v;
  }
}

// Issues the cp.async copies of a unit's packed weights into w_s: n8
// blocks [n8_0, n8_0 + ncols) x k32 chunks [cbase, cbase + kchunks), as
// (block, chunk, lane) x 16 bytes; blocks and chunks past the matrix are
// zero-filled. The copies are one committed group.
__device__ void load_weights(const uint4* w, int wkc, int n8_total, int n8_0,
                             int ncols, int cbase, int kchunks, uint4* w_s) {
  const int n = ncols * kchunks * 32;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int lane = i & 31, ck = (i >> 5) % kchunks, j = (i >> 5) / kchunks;
    const int n8 = n8_0 + j, c = cbase + ck;
    const bool ok = n8 < n8_total && c < wkc;
    fmma::cp_async<16>(w_s + i,
                       ok ? w + (static_cast<size_t>(n8) * wkc + c) * 32 + lane
                          : w,
                       ok ? 16 : 0);
  }
  fmma::cp_async_commit();
}

// The products of one K tile: a warp takes the unit's n8 blocks [j0, j0 +
// nbw) and k32 chunks [c_lo, c_hi) of the weights in w_s (kchunks a
// block), against all `mt` m16 tiles of a_s, and writes its f32 tile into
// red (slice s of ksub, R x C, columns from col0), or adds it there after
// the unit's first tile (`add`). Each warp owns its entries of red.
__device__ __forceinline__ void unit_products(const uint4* w_s, int kchunks,
                                           int j0, int nbw, int c_lo,
                                           int c_hi, int mt, const bf16* a_s,
                                           int S, float* red, int s, int R,
                                           int C, int col0, bool add) {
  const int lane = threadIdx.x & 31;
  float acc[kMaxMt][kMaxNbw][4];
#pragma unroll
  for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
    for (int j = 0; j < kMaxNbw; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 1
  for (int c = c_lo; c < c_hi; ++c) {
    uint4 bq[kMaxNbw];
#pragma unroll
    for (int j = 0; j < kMaxNbw; ++j)
      bq[j] = j < nbw ? w_s[((j0 + j) * kchunks + c) * 32 + lane]
                      : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 0; m < kMaxMt; ++m) {
        if (m >= mt) break;
        uint32_t a[4];
        fmma::ldsm_x4(a, a_s + (m * 16 + (lane & 15)) * S + c * 32 + h * 16 +
                             (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < kMaxNbw; ++j) {
          if (j >= nbw) break;
          if (h == 0)
            fmma::mma_bf16(acc[m][j], a, bq[j].x, bq[j].y);
          else
            fmma::mma_bf16(acc[m][j], a, bq[j].z, bq[j].w);
        }
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kMaxMt; ++m) {
    if (m >= mt) break;
#pragma unroll
    for (int j = 0; j < kMaxNbw; ++j) {
      if (j >= nbw) break;
      const int col = col0 + j * 8 + 2 * t, row = m * 16 + g;
      float* o = red + (static_cast<size_t>(s) * R + row) * C + col;
      if (add) {
        o[0] += acc[m][j][0];
        o[1] += acc[m][j][1];
        o[8 * C] += acc[m][j][2];
        o[8 * C + 1] += acc[m][j][3];
      } else {
        o[0] = acc[m][j][0];
        o[1] = acc[m][j][1];
        o[8 * C] = acc[m][j][2];
        o[8 * C + 1] = acc[m][j][3];
      }
    }
  }
}

__device__ __forceinline__ float tile_sum(const float* red, int ksub, int R,
                                          int C, int r, int c) {
  float v = red[r * C + c];
  for (int s = 1; s < ksub; ++s) v += red[(static_cast<size_t>(s) * R + r) * C + c];
  return v;
}

// One matmul phase `ph`: per unit and K tile, copy the tile's weights
// (cp.async, in flight while the left factor is staged), stage the left
// factor, multiply; then run the phase's epilogue. The kernel calls it from one site, so one
// inlined copy serves every phase, reading the parameters from the
// constant bank.
__device__ __forceinline__ void matmul_phase(const Params& p, int ph, int layer,
                                          int pos, Stream& st,
                                          unsigned char* smem,
                                          unsigned long long* stamp) {
  const Plan& pl = p.plan[ph];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = p.D, R = pl.rows, C = pl.ncols * 8;
  const int kp = pl.kchunks * 32, S = pl.ktile * 32 + 8;
  const int ntiles = (pl.kchunks + pl.ktile - 1) / pl.ktile;
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  uint4* w_s = reinterpret_cast<uint4*>(smem + R * S * sizeof(bf16));
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  float* rstat = reinterpret_cast<float*>(smem + p.stat_off);
  const int ncw = pl.ncols < kWarps ? pl.ncols : kWarps;
  const int nbw = pl.ncols / ncw, ksub = kWarps / ncw;
  const int cslot = warp % ncw, s = warp / ncw;
  const int N = ph == kQkv ? 3 * D : ph == kFc ? p.F8 : ph == kHead ? p.V : D;
  const int n8_total = (N + 7) / 8;
  const int wkc = p.wkc[ph];
  const uint4* w = p.wp[ph] + static_cast<size_t>(ph == kHead ? 0 : layer) *
                                  n8_total * wkc * 32;
  const bf16* ln = p.ln + static_cast<size_t>(layer) * 4 * D;
  const bf16* bias =
      ph == kQkv    ? p.qkv_b + static_cast<size_t>(layer) * 3 * D
      : ph == kProj ? p.proj_b + static_cast<size_t>(layer) * D
      : ph == kFc   ? p.fc_b + static_cast<size_t>(layer) * p.F
      : ph == kMlp  ? p.mlp_b + static_cast<size_t>(layer) * D
                    : nullptr;
  float* part = ph == kProj ? p.pproj : p.pmlp;
  // Where the LN phases write the summed stream: the other buffer, by the
  // CTAs of column group 0, when slices are pending or at the embedding.
  const bool embed = ph == kQkv && layer == 0;
  const bool ln_phase = ph == kQkv || ph == kFc || ph == kHead;
  const int xnext = embed || st.nparts == 0 ? st.xb : 1 - st.xb;
  float* xout = ln_phase && ph != kHead && (embed || st.nparts > 0)
                    ? p.x[xnext]
                    : nullptr;

  // A contiguous run of units for each CTA; CTA 0's is never empty.
  const int G = gridDim.x, bx = blockIdx.x;
  const int u0 = (bx * pl.units + G - 1) / G;
  const int u1 = ((bx + 1) * pl.units + G - 1) / G;
  int staged = -1;  // (row tile, k split) of a one-tile left factor in a_s
  for (int u = u0; u < u1; ++u) {
    const int cgi = u % pl.col_groups;
    const int rk = u / pl.col_groups;
    const int ks = rk % pl.ksplit, rt = rk / pl.ksplit;
    const int r0 = rt * R, n0 = cgi * C, cbase = ks * pl.kchunks;
    for (int t = 0; t < ntiles; ++t) {
      const int tc = t * pl.ktile;  // the tile's first chunk in the unit
      const int nk = min(pl.ktile, pl.kchunks - tc);
      __syncthreads();  // the last tile's products are done with w_s, a_s
      load_weights(w, wkc, n8_total, cgi * pl.ncols, pl.ncols, cbase + tc, nk,
                   w_s);
      if (ntiles > 1 || rk != staged) {
        const int k0 = ks * kp + tc * 32;
        if (ph == kProj) {
          stage_bf16(p, p.attn, p.D8, r0, R, k0, nk * 32, a_s, S);
        } else if (ph == kMlp) {
          stage_bf16(p, p.hid, p.F8, r0, R, k0, nk * 32, a_s, S);
        } else {
          const bf16* scale = ph == kQkv ? ln : ph == kFc ? ln + 2 * D : p.ln_f;
          float* xo = cgi == 0 ? xout : nullptr;
          if ((D & 3) == 0)
            stage_ln<4>(p, st, embed, pos, r0, R, k0, nk * 32, scale,
                        scale + D, a_s, S, xo, rstat);
          else
            stage_ln<1>(p, st, embed, pos, r0, R, k0, nk * 32, scale,
                        scale + D, a_s, S, xo, rstat);
        }
        staged = rk;
      }
      fmma::cp_async_wait<0>();
      __syncthreads();
      if (stamp != nullptr && u == u0 && t == 0 && threadIdx.x == 0)
        stamp[1] = global_ns();
      const int per = (nk + ksub - 1) / ksub;
      const int c_lo = s * per;
      const int c_hi = min(min(nk, c_lo + per), wkc - cbase - tc);
      unit_products(w_s, nk, cslot * nbw, nbw, c_lo, c_hi, R / 16, a_s, S,
                    red, s, R, C, cslot * nbw * 8, t > 0);
    }
    __syncthreads();
    if (stamp != nullptr && u == u0 && threadIdx.x == 0) stamp[2] = global_ns();

    // Epilogue: a warp a row, lanes over the tile's columns.
    if (ph == kHead && !p.normalize && (p.V & 3) == 0) {
      // Raw mixing with V a multiple of 4: a lane takes 4 consecutive
      // columns (one 8-byte load of diffusion logits a row), the diffusion
      // logits of all this warp's rows loaded together.
      constexpr int kHr = 4;  // rows a batch: their logits loaded together
      const int c4 = 4 * lane, n4 = n0 + c4;
      const bool in = c4 < C && n4 < p.V;
      for (int r0w = warp; r0w < R; r0w += kHr * kWarps) {
        float dv[kHr][4];
#pragma unroll
        for (int i = 0; i < kHr; ++i) {
          const int r = r0w + kWarps * i, b = r0 + r;
#pragma unroll
          for (int e = 0; e < 4; ++e) dv[i][e] = 0.f;
          if (in && r < R && b < p.B)
            load_b<4>(dv[i], p.diff + (static_cast<size_t>(b) * p.L + pos) *
                                          p.V + n4);
        }
#pragma unroll
        for (int i = 0; i < kHr; ++i) {
          const int r = r0w + kWarps * i, b = r0 + r;
          if (r >= R || b >= p.B) break;
          float best = -INFINITY;
          int idx = INT_MAX;
          if (in) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float a = tile_sum(red, ksub, R, C, r, c4 + e) * p.inv_t;
              const float m =
                  p.coef_ar * a + p.coef_diff * (dv[i][e] * p.inv_t);
              if (m > best) {  // n increases: the first maximum is kept
                best = m;
                idx = n4 + e;
              }
            }
          }
          warp_argmax(best, idx);
          if (lane == 0) {
            const size_t pi = static_cast<size_t>(b) * pl.col_groups + cgi;
            p.best[pi] = best;
            p.best_idx[pi] = idx;
          }
        }
      }
      continue;
    }
    if (ph == kHead) {  // normalize, or V not a multiple of 4: by column
      constexpr int kHc = kMaxNbw * 64 / 32;  // columns a lane, C <= 128
      for (int r = warp; r < R; r += kWarps) {
        const int b = r0 + r;
        if (b >= p.B) break;
        float dvr[kHc];
#pragma unroll
        for (int j = 0; j < kHc; ++j) {
          const int c = lane + 32 * j, n = n0 + c;
          dvr[j] = !p.normalize && c < C && n < p.V
                       ? ldw(p.diff + (static_cast<size_t>(b) * p.L + pos) *
                                          p.V + n) * p.inv_t
                       : 0.f;
        }
        float av[kHc];
#pragma unroll
        for (int j = 0; j < kHc; ++j) {
          const int c = lane + 32 * j, n = n0 + c;
          av[j] = c < C && n < p.V ? tile_sum(red, ksub, R, C, r, c) * p.inv_t
                                   : -INFINITY;
        }
        const size_t pi = static_cast<size_t>(b) * pl.col_groups + cgi;
        if (p.normalize) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kHc; ++j) {
            const int c = lane + 32 * j, n = n0 + c;
            if (c < C && n < p.V) {
              p.logits[static_cast<size_t>(b) * p.V + n] = av[j];
              mx = fmaxf(mx, av[j]);
            }
          }
          mx = warp_max(mx);
          float z = 0.f;
#pragma unroll
          for (int j = 0; j < kHc; ++j) {
            const int c = lane + 32 * j;
            if (c < C && n0 + c < p.V) z += expf(av[j] - mx);
          }
          z = warp_sum(z);
          if (lane == 0) {
            p.stats[2 * pi] = mx;
            p.stats[2 * pi + 1] = z;
          }
        } else {
          float best = -INFINITY;
          int idx = INT_MAX;
#pragma unroll
          for (int j = 0; j < kHc; ++j) {
            const int c = lane + 32 * j, n = n0 + c;
            if (c >= C || n >= p.V) break;
            const float m = p.coef_ar * av[j] + p.coef_diff * dvr[j];
            if (m > best) {  // n increases: the first maximum is kept
              best = m;
              idx = n;
            }
          }
          warp_argmax(best, idx);
          if (lane == 0) {
            p.best[pi] = best;
            p.best_idx[pi] = idx;
          }
        }
      }
      continue;
    }
    for (int r = warp; r < R; r += kWarps) {
      const int b = r0 + r;
      if (b >= p.B) break;
      for (int c = lane; c < C; c += 32) {
        const int n = n0 + c;
        if (n >= N) break;
        const float v = tile_sum(red, ksub, R, C, r, c);
        if (ph == kQkv) {
          const float y = v + ldw(bias + n);
          const int which = n / D, d = n % D;
          if (which == 0) {
            p.q[static_cast<size_t>(b) * D + d] = y;
          } else {
            const int dh = D / p.H, hh = d / dh;
            const size_t at =
                (((static_cast<size_t>(layer) * p.B + b) * p.H + hh) * p.T +
                 pos) * dh + d % dh;
            (which == 1 ? p.kc : p.vc)[at] = __float2bfloat16(y);
          }
        } else if (ph == kFc) {
          p.hid[static_cast<size_t>(b) * p.F8 + n] =
              n < p.F ? __float2bfloat16(gelu_tanh(v + ldw(bias + n)))
                      : __float2bfloat16(0.f);
        } else {  // projection or MLP: into the residual stream
          const size_t at = static_cast<size_t>(b) * D + n;
          if (pl.ksplit == 1)  // the whole sum: x' = x + (sum + bias)
            p.x[1 - st.xb][at] = ldf(p.x[st.xb] + at) + (v + ldw(bias + n));
          else  // a slice, added by the next LN phase
            part[static_cast<size_t>(ks) * p.B * D + at] = v;
        }
      }
    }
  }
  if (stamp != nullptr && threadIdx.x == 0) stamp[3] = global_ns();

  // The stream after this phase (uniform over the grid).
  if (ph == kQkv || ph == kFc) {
    st = Stream{xnext, nullptr, 0, nullptr};
  } else if (ph == kHead) {
    st = Stream{st.xb, nullptr, 0, nullptr};
  } else if (pl.ksplit == 1) {
    st = Stream{1 - st.xb, nullptr, 0, nullptr};
  } else {
    st = Stream{st.xb, part, pl.ksplit, bias};
  }
}

// `normalize`: per (row, head column tile), the mixture probability of the
// tile's columns from the merged head statistics and the diffusion
// statistics, and the tile's (best, first index).
__device__ __forceinline__ void normalize_phase(const Params& p, int pos) {
  const Plan& pl = p.plan[kHead];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = pl.ncols * 8, cgs = pl.col_groups;
  const int nw = gridDim.x * kWarps;
  const int tiles = p.B * cgs;
  for (int i = blockIdx.x * kWarps + warp; i < tiles; i += nw) {
    const int b = i / cgs, cgi = i % cgs;
    float m = -INFINITY, z = 0.f;
    for (int c = lane; c < cgs; c += 32) {
      const size_t j = 2 * (static_cast<size_t>(b) * cgs + c);
      const float om = __ldcg(p.stats + j), oz = __ldcg(p.stats + j + 1);
      const float nm = fmaxf(m, om);
      z = (nm == -INFINITY) ? 0.f
                            : z * expf(m - nm) + oz * expf(om - nm);
      m = nm;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const float oz = __shfl_xor_sync(0xffffffffu, z, o);
      const float nm = fmaxf(m, om);
      z = (nm == -INFINITY) ? 0.f : z * expf(m - nm) + oz * expf(om - nm);
      m = nm;
    }
    const float ma = m, za = z;
    const float* ds = p.dstats + 2 * (static_cast<size_t>(b) * p.L + pos);
    const float md = __ldcg(ds), zd = __ldcg(ds + 1);
    const bf16* dr = p.diff + (static_cast<size_t>(b) * p.L + pos) * p.V;
    float best = -INFINITY;
    int idx = INT_MAX;
    for (int c = lane; c < C; c += 32) {
      const int n = cgi * C + c;
      if (n >= p.V) break;
      const float a = __ldcg(p.logits + static_cast<size_t>(b) * p.V + n);
      const float d = ldw(dr + n) * p.inv_t;
      const float v = p.coef_ar * expf(a - ma) / za +
                      p.coef_diff * expf(d - md) / zd;
      if (v > best) {
        best = v;
        idx = n;
      }
    }
    warp_argmax(best, idx);
    if (lane == 0) {
      p.best[i] = best;
      p.best_idx[i] = idx;
    }
  }
}

// `normalize`: the diffusion logits' max and sum exp of every (row,
// position), before the position loop. A warp a row.
__device__ __forceinline__ void diffusion_stats(const Params& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = gridDim.x * kWarps;
  for (int i = blockIdx.x * kWarps + warp; i < p.B * p.L; i += nw) {
    const bf16* dr = p.diff + static_cast<size_t>(i) * p.V;
    float m = -INFINITY;
    for (int v = lane; v < p.V; v += 32) m = fmaxf(m, ldw(dr + v) * p.inv_t);
    m = warp_max(m);
    float z = 0.f;
    for (int v = lane; v < p.V; v += 32) z += expf(ldw(dr + v) * p.inv_t - m);
    z = warp_sum(z);
    if (lane == 0) {
      p.dstats[2 * i] = m;
      p.dstats[2 * i + 1] = z;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    guided_decode_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned target = 0;
  // CTA 0's stamps inside the phase after barrier n (measurement only).
  auto stamp = [&]() -> unsigned long long* {
    return p.trace != nullptr && blockIdx.x == 0
               ? p.trace + 4 * (target / gridDim.x)
               : nullptr;
  };
  const long long c0 = clock64();
  if (p.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.trace[0] = global_ns();
  if (p.normalize) {
    diffusion_stats(p);
    grid_barrier(p.bar, target, p.trace);
  }
  // A position is 4 depth + 1 matmul phases, walked by one loop so that the
  // phase code is inlined once: step 4 i + {0, 1, 2, 3} is layer i's QKV,
  // projection, FC and MLP, step 4 depth the head; the attention phase
  // runs between QKV and the projection.
  const int steps = 4 * p.depth + 1;
  Stream st{0, nullptr, 0, nullptr};
  for (int pos = 0; pos < p.L; ++pos) {
    for (int step = 0; step < steps; ++step) {
      const bool head = step == steps - 1;
      const int layer = head ? 0 : step / 4;
      matmul_phase(p, head ? int(kHead) : step % 4, layer, pos, st, smem,
                   stamp());
      grid_barrier(p.bar, target, p.trace);
      if (!head && step % 4 == kQkv) {
        attention_phase(p, layer, pos, smem);
        grid_barrier(p.bar, target, p.trace);
      }
    }
    if (p.normalize) {
      normalize_phase(p, pos);
      grid_barrier(p.bar, target, p.trace);
    }
  }
  // CTA 0's SM cycles and ns over the launch, beside the last stamp.
  if (p.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    p.trace[4 * (target / gridDim.x) + 1] = clock64() - c0;
    p.trace[4 * (target / gridDim.x) + 2] = global_ns();
  }
  // The last position's token.
  const int warp = threadIdx.x >> 5;
  for (int b = blockIdx.x * kWarps + warp; b < p.B; b += gridDim.x * kWarps) {
    const int tok = merge_token(p, b);
    if ((threadIdx.x & 31) == 0)
      p.tokens[static_cast<size_t>(b) * p.L + p.L - 1] = tok;
  }
}

// Measurement only: n of the decode's grid barriers and nothing else, for
// the cost of one barrier at a given grid size.
__global__ void __launch_bounds__(kThreads)
    grid_sync_probe_kernel(int n, unsigned* bar) {
  unsigned target = 0;
  for (int i = 0; i < n; ++i) grid_barrier(bar, target);
}

}  // namespace

// Launches n_syncs of the decode's grid barriers on `grid` CTAs of its
// block size, with its cooperative launch; `bar` is a zeroed unsigned
// counter. Returns a cudaError_t code.
extern "C" int tdm_grid_sync_probe(int n_syncs, int grid, void* bar,
                                   void* stream) {
  void* args[] = {&n_syncs, &bar};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_probe_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return int(err);
}

// Launches the decode on `stream` with `grid` CTAs and `smem` bytes of
// shared memory. `packed` holds the five packed matrices (QKV, projection,
// FC, MLP, head), `packed_kc` their k32 chunk counts, `plan` the five
// phases' tilings (kPlanInts ints each), `offs` the shared-memory offsets
// of the reduction, attention and statistics regions. `fws` is float
// scratch laid out
// as the wrapper documents, `hid` bf16 scratch of B x (F8 + D8), `ints` int
// scratch of B x (head col groups) + 1 (the barrier counter, zeroed).
// `trace`, where not null, gets %globaltimer stamps (ns) of CTA 0, four a
// barrier n: [4n] when the barrier released (n = 0: the start), then in the
// matmul phase that follows, when its first unit was staged, multiplied,
// and when the phase's epilogue ended (measurement only).
// Returns a cudaError_t code: the launch is refused (and nothing runs)
// where the device cannot launch cooperatively or cannot keep `grid` CTAs
// of this size resident.
extern "C" int tdm_guided_decode(
    const void* tok_emb, const void* pos_emb, const void* ln,
    const void* qkv_b, const void* proj_b, const void* fc_b,
    const void* mlp_b, const void* ln_f, const void* const* packed,
    const int* packed_kc, const void* diff, void* fws, void* hid, void* ints,
    void* kc, void* vc, void* tokens, int B, int L, int V, int D, int H,
    int F, int T, int depth, int bos, float coef_ar, float coef_diff,
    float inv_t, int normalize, const int* plan, const int* offs, int grid,
    int smem, void* trace, void* stream) {
  Params p;
  p.tok_emb = static_cast<const bf16*>(tok_emb);
  p.pos_emb = static_cast<const bf16*>(pos_emb);
  p.ln = static_cast<const bf16*>(ln);
  p.qkv_b = static_cast<const bf16*>(qkv_b);
  p.proj_b = static_cast<const bf16*>(proj_b);
  p.fc_b = static_cast<const bf16*>(fc_b);
  p.mlp_b = static_cast<const bf16*>(mlp_b);
  p.ln_f = static_cast<const bf16*>(ln_f);
  for (int i = 0; i < kPhases; ++i) {
    p.wp[i] = static_cast<const uint4*>(packed[i]);
    p.wkc[i] = packed_kc[i];
    const int* q = plan + kPlanInts * i;
    p.plan[i] = Plan{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
  }
  p.diff = static_cast<const bf16*>(diff);
  p.B = B;
  p.L = L;
  p.V = V;
  p.D = D;
  p.H = H;
  p.F = F;
  p.F8 = (F + 7) / 8 * 8;
  p.D8 = (D + 7) / 8 * 8;
  p.T = T;
  p.depth = depth;
  p.bos = bos;
  p.coef_ar = coef_ar;
  p.coef_diff = coef_diff;
  p.inv_t = inv_t;
  p.normalize = normalize;
  p.red_off = offs[0];
  p.att_off = offs[1];
  p.stat_off = offs[2];
  const int cgs = p.plan[kHead].col_groups;
  const int psplit = p.plan[kProj].ksplit, msplit = p.plan[kMlp].ksplit;
  float* f = static_cast<float*>(fws);
  const size_t bd = static_cast<size_t>(B) * D;
  p.x[0] = f;
  p.x[1] = f + bd;
  p.q = f + 2 * bd;
  p.pproj = f + 3 * bd;
  p.pmlp = p.pproj + psplit * bd;
  p.logits = p.pmlp + msplit * bd;
  p.best = p.logits + static_cast<size_t>(B) * V;
  p.stats = p.best + static_cast<size_t>(B) * cgs;
  p.dstats = p.stats + 2 * static_cast<size_t>(B) * cgs;
  p.hid = static_cast<bf16*>(hid);
  p.attn = p.hid + static_cast<size_t>(B) * p.F8;
  p.best_idx = static_cast<int*>(ints);
  p.bar = reinterpret_cast<unsigned*>(p.best_idx + static_cast<size_t>(B) * cgs);
  p.kc = static_cast<bf16*>(kc);
  p.vc = static_cast<bf16*>(vc);
  p.tokens = static_cast<int*>(tokens);
  p.trace = static_cast<unsigned long long*>(trace);

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return int(err);
  if (!coop) return int(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  if (smem > kSmemMax) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(guided_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, guided_decode_kernel, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1 || grid > per_sm * sms)
    return int(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(guided_decode_kernel), dim3(grid),
      dim3(kThreads), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return int(err);
}
