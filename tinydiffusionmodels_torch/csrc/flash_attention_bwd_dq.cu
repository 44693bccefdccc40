// The dq kernel of the flash-attention recompute backward
// (flash_attention_bwd.cuh), replacing the TPU kernel `_flash_dq_kernel` in
// tinydiffusionmodels_tpu/ops/pallas_kernels.py. Its own source, so that it
// compiles in parallel with the dk/dv kernel.

#include "flash_attention_bwd.cuh"

namespace {

template <typename T>
cudaError_t launch_width(const flash_bwd::BwdParams& p, int batch,
                         cudaStream_t s) {
  switch (flash_bwd::padded_width(p.dh, p.dv_dim)) {
    case 16: return flash_bwd::launch_dq<T, 16>(p, batch, s);
    case 32: return flash_bwd::launch_dq<T, 32>(p, batch, s);
    case 64: return flash_bwd::launch_dq<T, 64>(p, batch, s);
    case 128: return flash_bwd::launch_dq<T, 128>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tdm_flash_attention_bwd_dq(TDM_BWD_ARGS) {
  flash_bwd::BwdParams p;
  if (!TDM_BWD_PARAMS(p)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_width<float>(p, batch, s)
                              : launch_width<__nv_bfloat16>(p, batch, s);
  return int(err);
}
