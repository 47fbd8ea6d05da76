// K1b's bf16 form with the sigma denominator fused (atrous_level.cuh,
// level_bf16_kernel<R, STAGED, false, true>), its own source so that nvcc
// builds it beside the other forms.
#include "atrous_level.cuh"

cudaError_t launch_level_bf16_fused(const LevelArgs& a,
                                    const AtrousBf16& kb) {
    if (a.sden || a.w_out || !a.n_out || a.tile)
        return cudaErrorNotSupported;
    return launch_level_bf16_radius<false, true>(a, kb);
}
