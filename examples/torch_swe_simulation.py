"""Paper Fig. 8 on the PyTorch/CUDA port: the 2D shallow-water equations
across precisions, as ``examples/swe_simulation.py`` runs them on the JAX
package. Only the x-midpoint momentum-flux equation's multiplications run
on the configured multiplier (exactly the paper's substitution).

    PYTHONPATH=src python examples/torch_swe_simulation.py [--steps N] [--nx N]
        [--execution reference|fused|megakernel|auto] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.pde import Simulation, SWEConfig
from repro_torch.precision import PRESETS


def ascii_field(w, width=64, height=20):
    h, wid = w.shape
    ramp = " .:-=+*#%@"
    finite = w[np.isfinite(w)]
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    span = (hi - lo) or 1.0
    for y in np.linspace(0, h - 1, height).astype(int):
        line = ""
        for x in np.linspace(0, wid - 1, width).astype(int):
            v = w[y, x]
            line += "?" if not np.isfinite(v) else ramp[int((v - lo) / span * (len(ramp) - 1))]
        print(line)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--execution", default="auto", choices=("reference", "fused", "megakernel", "auto"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = SWEConfig(nx=args.nx, ny=args.nx)
    print(f"SWE: {cfg.nx}x{cfg.ny} basin, depth {cfg.depth} m, bump {cfg.bump} m, dt {cfg.dt:.1f}s x {args.steps} steps, "
          f"execution={args.execution} on {args.device}")
    verdicts, wref = {}, None
    for name in ("f32", "e5m10", "r2f2_16"):
        res = Simulation("swe2d", cfg, PRESETS[name], device=args.device).run(args.steps, execution=args.execution)
        w = res.state[0].cpu().numpy() - cfg.depth
        wref = w if wref is None else wref
        print(f"\n--- {name} ---")
        ascii_field(w)
        if not np.isfinite(w).all():
            verdicts[name] = "DESTROYED"
            print(f"{name}: SIMULATION DESTROYED (h*h overflowed the fixed format)")
        elif name != "f32":
            verdicts[name] = float(np.corrcoef(w.reshape(-1), wref.reshape(-1))[0, 1])
            print(f"{name}: field correlation vs f32 = {verdicts[name]:.4f}")
    return verdicts


if __name__ == "__main__":
    main()
