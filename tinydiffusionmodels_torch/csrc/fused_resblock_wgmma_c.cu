// The fused resblock's wgmma kernel, bf16 at 256 columns and bf16 at 32 columns
// (resblock_wgmma.cuh).

#include "resblock_wgmma.cuh"

namespace tdm_resblock {

TDM_WIDE_INSTANCE(, __nv_bfloat16, 256)
TDM_WIDE_INSTANCE(, __nv_bfloat16, 32)

}  // namespace tdm_resblock
