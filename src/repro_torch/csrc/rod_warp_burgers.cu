// The warp shape of the rod kernels: burgers1d's launcher (rod_warp.cuh).
#include "rod_warp.cuh"

ROD_WARP_LAUNCHER(launch_warp_burgers1d, kBurgers1D)
