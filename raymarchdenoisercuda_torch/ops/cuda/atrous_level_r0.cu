// K1/K1b at radius 0 (atrous_level.cuh); one source a radius, so nvcc
// compiles the instantiations of each in parallel.
#include "atrous_level.cuh"

template cudaError_t launch_level_radius<0>(const LevelArgs&);
