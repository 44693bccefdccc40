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
// (V 4096, D 256, depth 4), over ~10.5 MB of bf16 weights that every
// position re-reads. At batch 8 that is far below both roofs (a few µs of
// FP32 FMA and of HBM); the real bound is the serial chain: 64 positions x
// (5 x depth + 2) dependent phases, each of which needs every row's
// previous phase. At batch 256 the FP32 FMAs of the matmul phases dominate.
//
// What the design does about it. Hopper has no per-SM memory that holds
// the model, but the weights fit the 50 MB L2, which all SMs share. So one
// persistent cooperative grid (sized from the occupancy calculator, capped
// at the widest phase's work) walks the positions, and a grid barrier
// separates the phases: LN1 + QKV; attention with the cache write (one CTA
// per (row, head)); projection + residual; LN2 + FC + GELU; MLP + residual;
// after the last layer, final LN + head (logits to scratch); and a per-row
// reduce that mixes, takes the argmax, writes the token and gathers the
// next position's embedding. A matmul phase splits the output into units
// of 8 rows x 32 columns; a CTA stages its rows as bf16 in shared memory
// (recomputing the cheap LayerNorm itself), its 8 warps split K, each lane
// owns a column and reads its bf16 weights from L2, and the warps' partial
// sums are added in a fixed order (no atomics, so a run is deterministic).
// Activations, logits and the bf16 KV cache live in global scratch that the
// wrapper allocates; only slots <= pos of the cache are ever read, so it
// needs no zeroing. Tensor cores, TMA and clusters are later work.
//
// C entry point: tdm_guided_decode (plain C interface, loaded with ctypes).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;   // batch rows of one matmul unit
constexpr int kCols = 32;  // output columns of one matmul unit, one per lane

typedef __nv_bfloat16 bf16;

struct Params {
  // Weights (bf16, row-major; linear weights are (in, out)).
  const bf16* tok_emb;  // (V, D)
  const bf16* pos_emb;  // (T, D)
  const bf16* ln;       // (depth, 4, D): ln1 scale, ln1 bias, ln2 scale, bias
  const bf16* qkv_w;    // (depth, D, 3D)
  const bf16* qkv_b;    // (depth, 3D)
  const bf16* proj_w;   // (depth, D, D)
  const bf16* proj_b;   // (depth, D)
  const bf16* fc_w;     // (depth, D, F)
  const bf16* fc_b;     // (depth, F)
  const bf16* mlp_w;    // (depth, F, D)
  const bf16* mlp_b;    // (depth, D)
  const bf16* ln_f;     // (2, D)
  const bf16* head;     // (D, V)
  const bf16* diff;     // (B, L, V) diffusion logits
  // Scratch, written and read by the kernel.
  float* x;       // (B, D) residual stream
  float* qkv;     // (B, 3D)
  float* attn;    // (B, D)
  float* hid;     // (B, F)
  float* logits;  // (B, V) head logits / temperature
  bf16* kc;       // (depth, B, H, T, Dh)
  bf16* vc;       // (depth, B, H, T, Dh)
  int* tokens;    // (B, L) output
  int B, L, V, D, H, F, T, depth, bos;
  float coef_ar, coef_diff, inv_t;  // (1 - alpha), alpha, 1 / temperature
  int normalize;
};

enum Epilogue { kStore, kResidual, kGelu, kScale };

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float ldw(const bf16* p) {
  return __bfloat162float(__ldg(p));
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

// Block-wide sum or max through `red` (kWarps floats); every thread gets it.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True).
  return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *
                                  (x + 0.044715f * x * x * x)));
}

// Stages rows [r0, r0 + nrows) of src (row length K) as bf16 in in_s, after
// a LayerNorm with (scale, bias) when scale is not null. One warp per row.
__device__ void stage_rows(const float* src, int K, int r0, int nrows,
                           const bf16* scale, const bf16* bias, bf16* in_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < nrows; r += kWarps) {
    const float* row = src + static_cast<size_t>(r0 + r) * K;
    bf16* dst = in_s + r * K;
    if (scale == nullptr) {
      for (int k = lane; k < K; k += 32) dst[k] = __float2bfloat16(row[k]);
      continue;
    }
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += row[k];
    const float mu = warp_sum(s) / K;
    float var = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d = row[k] - mu;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
    for (int k = lane; k < K; k += 32)
      dst[k] = __float2bfloat16((row[k] - mu) * rstd * ldw(scale + k) +
                                ldw(bias + k));
  }
  __syncthreads();
}

// out[b, n] (op)= epilogue(sum_k bf16(f(src[b, k])) * W[k, n] + bias[n]) for
// all B rows and N columns, in units of kRows x kCols spread over the grid.
template <Epilogue kEpi>
__device__ void matmul_phase(const Params& p, const float* src, int K,
                             const bf16* ln_scale, const bf16* ln_bias,
                             const bf16* W, const bf16* bias, int N,
                             float* out, bf16* in_s, float* red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col_tiles = (N + kCols - 1) / kCols;
  const int units = (p.B + kRows - 1) / kRows * col_tiles;
  const int kper = (K + kWarps - 1) / kWarps;
  const int k0 = warp * kper, k1 = min(K, k0 + kper);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int r0 = (u / col_tiles) * kRows, c0 = (u % col_tiles) * kCols;
    const int nrows = min(kRows, p.B - r0);
    stage_rows(src, K, r0, nrows, ln_scale, ln_bias, in_s);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const int col = c0 + lane;
    if (col < N) {
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float w = ldw(W + static_cast<size_t>(k) * N + col);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nrows) acc[r] += bf(in_s[r * K + k]) * w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      red_s[(warp * kRows + r) * kCols + lane] = acc[r];
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * kCols; i += kThreads) {
      const int r = i / kCols, c = c0 + i % kCols;
      if (c >= N) continue;
      float s = red_s[(0 * kRows + r) * kCols + i % kCols];
      for (int w = 1; w < kWarps; ++w) s += red_s[(w * kRows + r) * kCols + i % kCols];
      float* o = out + static_cast<size_t>(r0 + r) * N + c;
      if (kEpi == kScale) {
        *o = s * p.inv_t;
      } else {
        const float y = s + ldw(bias + c);
        if (kEpi == kStore) *o = y;
        if (kEpi == kResidual) *o += y;
        if (kEpi == kGelu) *o = gelu_tanh(y);
      }
    }
    __syncthreads();
  }
}

// Causal attention of position pos over cache slots 0..pos, one unit per
// (row, head); writes this position's k and v into the cache first.
__device__ void attention_phase(const Params& p, int layer, int pos,
                                float* sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = p.D, dh = D / p.H;
  const float rsd = sqrtf(static_cast<float>(dh));
  for (int u = blockIdx.x; u < p.B * p.H; u += gridDim.x) {
    const int b = u / p.H, h = u % p.H;
    const float* q = p.qkv + static_cast<size_t>(b) * 3 * D + h * dh;
    const size_t slab =
        ((static_cast<size_t>(layer) * p.B + b) * p.H + h) * p.T * dh;
    bf16* ks = p.kc + slab;
    bf16* vs = p.vc + slab;
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      ks[pos * dh + d] = __float2bfloat16(q[D + d]);
      vs[pos * dh + d] = __float2bfloat16(q[2 * D + d]);
    }
    __syncthreads();
    for (int t = warp; t <= pos; t += kWarps) {
      float s = 0.f;
      for (int d = lane; d < dh; d += 32) s += q[d] * bf(ks[t * dh + d]);
      s = warp_sum(s);
      if (lane == 0) sc[t] = s / rsd;
    }
    __syncthreads();
    if (warp == 0) {
      float m = -INFINITY;
      for (int t = lane; t <= pos; t += 32) m = fmaxf(m, sc[t]);
      m = warp_max(m);
      float z = 0.f;
      for (int t = lane; t <= pos; t += 32) {
        const float e = expf(sc[t] - m);
        sc[t] = e;
        z += e;
      }
      z = warp_sum(z);
      for (int t = lane; t <= pos; t += 32) sc[t] = sc[t] / z;
    }
    __syncthreads();
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      float o = 0.f;
      for (int t = 0; t <= pos; ++t) o += sc[t] * bf(vs[t * dh + d]);
      p.attn[static_cast<size_t>(b) * D + h * dh + d] = o;
    }
    __syncthreads();
  }
}

// x[b] = tok_emb[tok] + pos_emb[pos] for the rows of this CTA's unit.
__device__ void embed_row(const Params& p, int b, int tok, int pos) {
  for (int d = threadIdx.x; d < p.D; d += kThreads)
    p.x[static_cast<size_t>(b) * p.D + d] =
        ldw(p.tok_emb + static_cast<size_t>(tok) * p.D + d) +
        ldw(p.pos_emb + static_cast<size_t>(pos) * p.D + d);
}

// Per row: mix the head's and the diffusion logits, greedy argmax (lowest
// index among equal maxima), write the token, gather the next embedding.
__device__ void reduce_phase(const Params& p, int pos, float* red,
                             int* red_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float* a = p.logits + static_cast<size_t>(b) * p.V;
    const bf16* dr = p.diff + (static_cast<size_t>(b) * p.L + pos) * p.V;
    float ma = 0.f, md = 0.f, za = 1.f, zd = 1.f;
    if (p.normalize) {
      float la = -INFINITY, ld = -INFINITY;
      for (int v = threadIdx.x; v < p.V; v += kThreads) {
        la = fmaxf(la, a[v]);
        ld = fmaxf(ld, bf(dr[v]) * p.inv_t);
      }
      ma = block_reduce<true>(la, red);
      md = block_reduce<true>(ld, red);
      float sa = 0.f, sd = 0.f;
      for (int v = threadIdx.x; v < p.V; v += kThreads) {
        sa += expf(a[v] - ma);
        sd += expf(bf(dr[v]) * p.inv_t - md);
      }
      za = block_reduce<false>(sa, red);
      zd = block_reduce<false>(sd, red);
    }
    float best = -INFINITY;
    int idx = INT_MAX;
    for (int v = threadIdx.x; v < p.V; v += kThreads) {
      const float d = bf(dr[v]) * p.inv_t;
      const float m =
          p.normalize
              ? p.coef_ar * expf(a[v] - ma) / za + p.coef_diff * expf(d - md) / zd
              : p.coef_ar * a[v] + p.coef_diff * d;
      if (m > best) {  // v increases: the first maximum is kept
        best = m;
        idx = v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ob > best || (ob == best && oi < idx)) {
        best = ob;
        idx = oi;
      }
    }
    __syncthreads();
    if (lane == 0) {
      red[warp] = best;
      red_idx[warp] = idx;
    }
    __syncthreads();
    best = red[0];
    idx = red_idx[0];
    for (int w = 1; w < kWarps; ++w)
      if (red[w] > best || (red[w] == best && red_idx[w] < idx)) {
        best = red[w];
        idx = red_idx[w];
      }
    const int tok = idx == INT_MAX ? 0 : idx;  // all-NaN row: token 0
    if (threadIdx.x == 0) p.tokens[static_cast<size_t>(b) * p.L + pos] = tok;
    if (pos + 1 < p.L) embed_row(p, b, tok, pos + 1);
    __syncthreads();
  }
}

__host__ __device__ size_t staged_bytes(int D, int F) {
  const size_t k_max = D > F ? D : F;
  return (kRows * k_max * sizeof(bf16) + 15) / 16 * 16;
}

__host__ __device__ size_t smem_bytes(int D, int F, int T) {
  return staged_bytes(D, F) + sizeof(float) * kWarps * kRows * kCols +
         sizeof(float) * T + (sizeof(float) + sizeof(int)) * kWarps;
}

__global__ void __launch_bounds__(kThreads)
    guided_decode_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* in_s = reinterpret_cast<bf16*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + staged_bytes(p.D, p.F));
  float* sc = red_s + kWarps * kRows * kCols;
  float* red = sc + p.T;
  int* red_idx = reinterpret_cast<int*>(red + kWarps);

  const int D = p.D, F = p.F;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) embed_row(p, b, p.bos, 0);
  grid.sync();
  for (int pos = 0; pos < p.L; ++pos) {
    for (int i = 0; i < p.depth; ++i) {
      const bf16* ln = p.ln + static_cast<size_t>(i) * 4 * D;
      matmul_phase<kStore>(p, p.x, D, ln, ln + D,
                           p.qkv_w + static_cast<size_t>(i) * D * 3 * D,
                           p.qkv_b + static_cast<size_t>(i) * 3 * D, 3 * D,
                           p.qkv, in_s, red_s);
      grid.sync();
      attention_phase(p, i, pos, sc);
      grid.sync();
      matmul_phase<kResidual>(p, p.attn, D, nullptr, nullptr,
                              p.proj_w + static_cast<size_t>(i) * D * D,
                              p.proj_b + static_cast<size_t>(i) * D, D, p.x,
                              in_s, red_s);
      grid.sync();
      matmul_phase<kGelu>(p, p.x, D, ln + 2 * D, ln + 3 * D,
                          p.fc_w + static_cast<size_t>(i) * D * F,
                          p.fc_b + static_cast<size_t>(i) * F, F, p.hid, in_s,
                          red_s);
      grid.sync();
      matmul_phase<kResidual>(p, p.hid, F, nullptr, nullptr,
                              p.mlp_w + static_cast<size_t>(i) * F * D,
                              p.mlp_b + static_cast<size_t>(i) * D, D, p.x,
                              in_s, red_s);
      grid.sync();
    }
    matmul_phase<kScale>(p, p.x, D, p.ln_f, p.ln_f + D, p.head, nullptr, p.V,
                         p.logits, in_s, red_s);
    grid.sync();
    reduce_phase(p, pos, red, red_idx);
    grid.sync();
  }
}

// Measurement only: n grid barriers and nothing else, for the cost of one
// barrier at a given grid size.
__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

}  // namespace

// Launches n_syncs grid barriers on `grid` CTAs of kThreads threads, with
// the decode's cooperative launch; returns a cudaError_t code.
extern "C" int tdm_grid_sync_probe(int n_syncs, int grid, void* stream) {
  void* args[] = {&n_syncs};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_probe_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return int(err);
}

// Launches the decode on `stream`. `ws` is float scratch of
// B * (5 D + F + V) floats; kc and vc hold depth * B * T * D bf16 each.
// Writes the grid size used to *grid_out. Returns a cudaError_t code: the
// launch is refused (and nothing runs) where the device cannot launch
// cooperatively or cannot keep one CTA of this size resident per SM.
extern "C" int tdm_guided_decode(
    const void* tok_emb, const void* pos_emb, const void* ln,
    const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* fc_w, const void* fc_b,
    const void* mlp_w, const void* mlp_b, const void* ln_f, const void* head,
    const void* diff, void* ws, void* kc, void* vc, void* tokens, int B,
    int L, int V, int D, int H, int F, int T, int depth, int bos,
    float coef_ar, float coef_diff, float inv_t, int normalize, void* stream,
    int* grid_out) {
  Params p;
  p.tok_emb = static_cast<const bf16*>(tok_emb);
  p.pos_emb = static_cast<const bf16*>(pos_emb);
  p.ln = static_cast<const bf16*>(ln);
  p.qkv_w = static_cast<const bf16*>(qkv_w);
  p.qkv_b = static_cast<const bf16*>(qkv_b);
  p.proj_w = static_cast<const bf16*>(proj_w);
  p.proj_b = static_cast<const bf16*>(proj_b);
  p.fc_w = static_cast<const bf16*>(fc_w);
  p.fc_b = static_cast<const bf16*>(fc_b);
  p.mlp_w = static_cast<const bf16*>(mlp_w);
  p.mlp_b = static_cast<const bf16*>(mlp_b);
  p.ln_f = static_cast<const bf16*>(ln_f);
  p.head = static_cast<const bf16*>(head);
  p.diff = static_cast<const bf16*>(diff);
  float* w = static_cast<float*>(ws);
  p.x = w;
  p.qkv = p.x + static_cast<size_t>(B) * D;
  p.attn = p.qkv + static_cast<size_t>(B) * 3 * D;
  p.hid = p.attn + static_cast<size_t>(B) * D;
  p.logits = p.hid + static_cast<size_t>(B) * F;
  p.kc = static_cast<bf16*>(kc);
  p.vc = static_cast<bf16*>(vc);
  p.tokens = static_cast<int*>(tokens);
  p.B = B;
  p.L = L;
  p.V = V;
  p.D = D;
  p.H = H;
  p.F = F;
  p.T = T;
  p.depth = depth;
  p.bos = bos;
  p.coef_ar = coef_ar;
  p.coef_diff = coef_diff;
  p.inv_t = inv_t;
  p.normalize = normalize;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return int(err);
  if (!coop) return int(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const size_t smem = smem_bytes(D, F, T);
  err = cudaFuncSetAttribute(guided_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, guided_decode_kernel, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
  // The widest phase's units: more CTAs than that would only wait at the
  // barriers.
  const int row_tiles = (B + kRows - 1) / kRows;
  int widest = F > 3 * D ? F : 3 * D;
  if (V > widest) widest = V;
  int units = row_tiles * ((widest + kCols - 1) / kCols);
  if (B * H > units) units = B * H;
  int grid = per_sm * sms;
  if (units < grid) grid = units;
  *grid_out = grid;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(guided_decode_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return int(err);
}
