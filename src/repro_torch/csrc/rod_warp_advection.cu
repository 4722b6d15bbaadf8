// The warp shape of the rod kernels: advection1d's launcher (rod_warp.cuh).
#include "rod_warp.cuh"

ROD_WARP_LAUNCHER(launch_warp_advection1d, kAdvection1D)
