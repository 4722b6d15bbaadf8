"""Beyond-paper workload: 1D inviscid Burgers (Lax-Friedrichs), nx=256.

The nonlinear flux u*u squares the operand range: 1.2e5 overflows E5M10 at
t=0, then the post-shock N-wave decay collapses the range by orders of
magnitude, so the tracked modes' split must grow to FX and shrink back.
"""

from repro_torch.pde.burgers1d import BurgersConfig

CONFIG = BurgersConfig(nx=256, amplitude=350.0, cfl=0.4)
BENCH_STEPS = 1200
