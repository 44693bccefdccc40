// Counter-based attention-weight dropout of the flash-attention kernels.
//
// Replaces the TPU helper `_dropout_scale` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py, which the TPU forward and
// both recompute-backward kernels call. The mask is a pure function of
// (seed, batch*head, global query position, global key position), where the
// head is the layer's (b * heads_total + head_off + h for a launch on a slice
// of the heads, as a tensor-parallel rank's): the
// murmur3 fmix32 mix of q*0x9E3779B9 + k*0x85EBCA6B + bh*0xC2B2AE35 + seed in
// uint32 arithmetic, kept where the hash is >= a threshold. So the forward
// and both backward kernels regenerate the identical mask from coordinates,
// and no (L, L) mask ever reaches device memory. The plain PyTorch version is
// `dropout_scale` in ops/reference.py; the two are bit-exact.
//
// What bounds it: a handful of integer multiplies, shifts and xors per
// attention weight, beside the 2*(Dh + Dv) FLOPs each weight already costs;
// it adds no memory traffic.

#pragma once

#include <cstdint>

// The part of the hash that depends on the query row only: computed once per
// thread, then completed per key by dropout_factor.
__device__ __forceinline__ uint32_t dropout_row_base(uint32_t seed,
                                                     uint32_t bh,
                                                     int q_pos) {
  return uint32_t(q_pos) * 0x9E3779B9u + bh * 0xC2B2AE35u + seed;
}

// 0 or keep_scale (= float32(1 / (1 - rate))) for key k_pos of the row;
// thresh = min(int(rate * 2^32), 2^32 - 1), computed on the host.
__device__ __forceinline__ float dropout_factor(uint32_t row_base, int k_pos,
                                                uint32_t thresh,
                                                float keep_scale) {
  uint32_t h = row_base + uint32_t(k_pos) * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= thresh ? keep_scale : 0.f;
}
