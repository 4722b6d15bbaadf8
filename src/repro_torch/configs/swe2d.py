"""The paper's workload #2: 2D shallow-water equations (Lax-Wendroff), 128x128.

Only the x-midpoint momentum-flux equation runs on the configured
multiplier; h*h at a 500 m basin overflows E5M10's 65504: the overflow
failure mode.
"""

from repro_torch.pde.swe2d import SWEConfig

CONFIG = SWEConfig(nx=128, ny=128, depth=500.0, bump=100.0)
BENCH_STEPS = 400
