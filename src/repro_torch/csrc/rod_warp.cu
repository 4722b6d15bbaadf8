// The warp shape of the rod kernels: heat1d's launcher (rod_warp.cuh).
#include "rod_warp.cuh"

ROD_WARP_LAUNCHER(launch_warp_heat1d, kHeat1D)
