"""Beyond-paper workload: 1D linear advection (flux-form upwind, cfl=1), nx=256.

At cfl=1 the f32 run translates the profile exactly; the 1e5-amplitude
pulse makes the flux operand overflow E5M10's 65504 ceiling: the overflow
failure mode on the field itself.
"""

from repro_torch.pde.advection1d import AdvectionConfig

CONFIG = AdvectionConfig(nx=256, speed=1.0, cfl=1.0, amplitude=1.0e5)
BENCH_STEPS = 256  # one full period of the periodic domain
