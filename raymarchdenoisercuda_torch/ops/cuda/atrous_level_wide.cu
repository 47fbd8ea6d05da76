// K1/K1b at any radius above 2, its taps in a device array
// (atrous_level.cuh, R = -1).
#include "atrous_level.cuh"

template cudaError_t launch_level_radius<-1>(const LevelArgs&);
