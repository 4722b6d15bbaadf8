// The grid shape of the rod kernels: the periodic bodies' launchers (rod_grid.cuh).
#include "rod_grid.cuh"

ROD_GRID_LAUNCHER(launch_grid_advection1d, kAdvection1D)
ROD_GRID_LAUNCHER(launch_grid_burgers1d, kBurgers1D)
