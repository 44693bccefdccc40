// Tiling constants and element access of the FP32-FMA single-block attention
// pair (attention_single_block.cu).

#pragma once

#include <cuda_bf16.h>

namespace flash {

constexpr int kBlockQ = 64;       // query rows per tile
constexpr int kBlockK = 64;       // key rows per tile
constexpr int kLanesPerRow = 4;   // threads that share one tile row
constexpr int kThreads = kBlockQ * kLanesPerRow;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace flash
