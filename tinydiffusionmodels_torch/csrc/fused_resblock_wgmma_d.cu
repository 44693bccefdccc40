// The fused resblock's wgmma kernel, bf16 at 128 columns and bf16 at 64 columns
// (resblock_wgmma.cuh).

#include "resblock_wgmma.cuh"

namespace tdm_resblock {

TDM_WIDE_INSTANCE(, __nv_bfloat16, 128)
TDM_WIDE_INSTANCE(, __nv_bfloat16, 64)

}  // namespace tdm_resblock
