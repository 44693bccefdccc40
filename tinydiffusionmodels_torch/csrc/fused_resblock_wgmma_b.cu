// The fused resblock's wgmma kernel, f32 at 128 columns and f32 at 64 columns
// (resblock_wgmma.cuh).

#include "resblock_wgmma.cuh"

namespace tdm_resblock {

TDM_WIDE_INSTANCE(, float, 128)
TDM_WIDE_INSTANCE(, float, 64)

}  // namespace tdm_resblock
