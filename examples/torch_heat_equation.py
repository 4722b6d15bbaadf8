"""Paper Figs. 1 & 7 on the PyTorch/CUDA port: the 1D heat equation across
precisions (ASCII rendering), as ``examples/heat_equation.py`` runs it on
the JAX package.

    PYTHONPATH=src python examples/torch_heat_equation.py [--init sin|exp] [--steps N]
        [--execution reference|fused|megakernel|auto] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse

import numpy as np

from repro_torch.pde import HeatConfig, Simulation
from repro_torch.precision import PRESETS


def ascii_plot(rows, labels, width=72, height=12):
    lo = min(np.nanmin(r) for r in rows)
    hi = max(np.nanmax(r) for r in rows)
    span = (hi - lo) or 1.0
    grid = [[" "] * width for _ in range(height)]
    marks = "#*o+x"
    for ri, r in enumerate(rows):
        xs = np.linspace(0, len(r) - 1, width).astype(int)
        for c, xi in enumerate(xs):
            v = r[xi]
            if not np.isfinite(v):
                continue
            y = int((1 - (v - lo) / span) * (height - 1))
            grid[y][c] = marks[ri % len(marks)]
    print("\n".join("".join(row) for row in grid))
    for ri, lab in enumerate(labels):
        print(f"  {marks[ri % len(marks)]} = {lab}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", default="sin", choices=["sin", "exp"])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--execution", default="auto", choices=("reference", "fused", "megakernel", "auto"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = HeatConfig(nx=args.nx, init=args.init)
    print(f"heat equation: {args.init} init, alpha={cfg.alpha}, r={cfg.cfl}, {args.steps} steps, "
          f"execution={args.execution} on {args.device}\n")
    curves, labels = [], []
    for name in ("f32", "e5m10", "r2f2_16"):
        res = Simulation("heat1d", cfg, PRESETS[name], device=args.device).run(args.steps, execution=args.execution)
        curves.append(res.state.cpu().numpy())
        labels.append(name)
    ascii_plot(curves, labels)
    ref, rels = curves[0], {}
    for c, label in zip(curves[1:], labels[1:]):
        rels[label] = float(np.linalg.norm(c - ref) / np.linalg.norm(ref))
        verdict = "matches f32" if rels[label] < 0.05 else "WRONG SIMULATION"
        print(f"{label}: rel L2 {rels[label]:.4f} -> {verdict}")
    return rels


if __name__ == "__main__":
    main()
