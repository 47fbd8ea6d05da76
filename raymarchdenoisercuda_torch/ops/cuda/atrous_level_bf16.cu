// K1b's bf16 form (atrous_level.cuh, level_bf16_kernel), its own source so
// that nvcc builds it beside the float32 radii.
#include "atrous_level.cuh"

cudaError_t launch_level_bf16(const LevelArgs& a, const AtrousBf16& kb) {
    const AtrousParams& p = *a.params;
    if (!a.sden || !a.n_out || a.tile) return cudaErrorNotSupported;
    const size_t staged =
        lattice_entries<K1_TW, K1_TR>(p.spacing, p.radius) * KB_FWD_PLANES
        * sizeof(__nv_bfloat16);
    if (a.wide_taps) {
        return staged <= kBf16MaxStaged
                   ? launch_level_bf16_store<-1, true>(a, kb, staged)
                   : launch_level_bf16_store<-1, false>(a, kb, 0);
    }
    switch (p.radius) {
    case 0: return launch_level_bf16_store<0, true>(a, kb, staged);
    case 1: return launch_level_bf16_store<1, true>(a, kb, staged);
    case 2: return launch_level_bf16_store<2, true>(a, kb, staged);
    default: return cudaErrorInvalidValue;
    }
}
