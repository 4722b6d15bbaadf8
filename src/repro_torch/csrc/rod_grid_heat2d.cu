// The grid shape of the rod kernels: heat2d's launcher (rod_grid.cuh).
#include "rod_grid.cuh"

ROD_GRID_LAUNCHER(launch_grid_heat2d, kHeat2D)
