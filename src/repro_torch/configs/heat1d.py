"""The paper's workload #1: 1D heat equation (explicit FD), nx = 128.

Physical diffusivity drives the alpha*lap products below E5M10's subnormal
floor late in the run: the underflow failure mode.
"""

from repro_torch.pde.heat1d import HeatConfig

CONFIG = HeatConfig(nx=128, init="sin", alpha=1e-5, cfl=0.4, amplitude=500.0, modes=3)
CONFIG_EXP = HeatConfig(nx=128, init="exp", alpha=1e-5, cfl=0.4)
BENCH_STEPS = {"sin": 4000, "exp": 16000}
