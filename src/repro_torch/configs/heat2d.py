"""Beyond-paper workload: 2D heat equation (explicit 5-point FD), 64x64.

The same underflow failure mode as the paper's 1D case (the 2D mode decays
faster, so E5M10 freezes by ~1.5k steps), plus 2D range-locality tiles.
"""

from repro_torch.pde.heat2d import Heat2DConfig

CONFIG = Heat2DConfig(nx=64, ny=64, alpha=1e-5, cfl=0.2, amplitude=500.0, modes=(3, 2))
BENCH_STEPS = 1500
