// The dq kernel of the flash-attention recompute backward
// (flash_attention_bwd.cuh), replacing the TPU kernel `_flash_dq_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py. Its own source, so that it
// compiles in parallel with the other backward kernel.

#include "flash_attention_bwd.cuh"

extern "C" int tdm_flash_attention_bwd_dq(TDM_BWD_ARGS) {
  return flash_bwd::run<flash_bwd::kDqKernel>(TDM_BWD_PASS);
}
