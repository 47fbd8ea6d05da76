// K1b's bf16 form with a given sigma denominator (atrous_level.cuh,
// level_bf16_kernel), its own source so that nvcc builds it beside the
// float32 radii and the fused form.
#include "atrous_level.cuh"

cudaError_t launch_level_bf16(const LevelArgs& a, const AtrousBf16& kb) {
    if (!a.sden || a.sden_out || !a.n_out || a.tile)
        return cudaErrorNotSupported;
    return a.w_out ? launch_level_bf16_radius<true, false>(a, kb)
                   : launch_level_bf16_radius<false, false>(a, kb);
}
