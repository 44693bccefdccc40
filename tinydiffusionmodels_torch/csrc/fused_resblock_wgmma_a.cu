// The fused resblock's wgmma kernel, f32 at 256 columns and f32 at 32 columns
// (resblock_wgmma.cuh).

#include "resblock_wgmma.cuh"

namespace tdm_resblock {

TDM_WIDE_INSTANCE(, float, 256)
TDM_WIDE_INSTANCE(, float, 32)

}  // namespace tdm_resblock
