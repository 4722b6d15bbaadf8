"""Quickstart on the PyTorch/CUDA port (``src/repro_torch``): the paper's
technique in five minutes, as ``examples/quickstart.py`` shows it for the
JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--steps N]

Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import FlexFormat, max_normal, min_normal, quantize_em, r2f2_mul_sequential, r2f2_multiply
from repro_torch.pde import HeatConfig, simulate_heat
from repro_torch.precision import PRESETS, get_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=2000, help="heat equation steps in part 5")
    args = ap.parse_args(argv)
    dev = args.device
    fmt = FlexFormat(3, 9, 3)  # the paper's 16-bit <EB=3, MB=9, FX=3>

    print("=== 1. flexible formats: one 16-bit layout, many tradeoffs ===")
    for k in range(fmt.fx + 1):
        e, m = fmt.em(k)
        print(f"  k={k}: E{e}M{m:<2d} range [{float(min_normal(e)):.2e}, {float(max_normal(e, m)):.3e}], "
              f"rel. precision 2^-{m + 1}")

    print("\n=== 2. runtime reconfiguration beats any fixed 16-bit format ===")
    rng = np.random.default_rng(0)
    a = torch.from_numpy((10.0 ** rng.uniform(-4, 4, 100000)).astype(np.float32)).to(dev)
    b = torch.from_numpy((10.0 ** rng.uniform(-4, 4, 100000)).astype(np.float32)).to(dev)
    exact = a.double() * b.double()
    p_rr, stats = r2f2_multiply(a, b, fmt, tile_shape=(1000,))
    p_half = quantize_em(quantize_em(a, 5, 10) * quantize_em(b, 5, 10), 5, 10)

    def err(p):
        p = p.double()
        return float(torch.where(torch.isfinite(p), (p - exact).abs() / exact.abs(), torch.ones_like(p)).mean())

    print(f"  E5M10 (IEEE half) mean rel error: {err(p_half) * 100:.3f}%  "
          f"(overflows: {int((~torch.isfinite(p_half)).sum())})")
    print(f"  R2F2 {fmt}        mean rel error: {err(p_rr) * 100:.3f}%  (overflows: {int(stats.overflow_count)})")

    print("\n=== 3. the hardware state machine (sequential mode) ===")
    t = torch.linspace(0, 1, 2000, dtype=torch.float32, device=dev)
    drift = 3e4 * torch.exp(-10 * t) + 1e-6
    _, st = r2f2_mul_sequential(drift, drift, fmt)
    print(f"  stream drifting 3e4 -> 1e-6: {int(st.overflow_adjusts)} overflow adjusts, "
          f"{int(st.redundancy_adjusts)} redundancy adjusts (paper §5.3 behaviour)")

    print("\n=== 4. one pluggable engine per policy mode ===")
    for name in ("f32", "e5m10", "r2f2_16", "deploy"):
        eng = get_engine(PRESETS[name])
        print(f"  PRESETS[{name!r}] -> engine {eng.name!r} (emulated={eng.emulated}, "
              f"operand dtype={eng.operand_dtype(PRESETS[name])})")

    print("\n=== 5. drop-in precision policy for a whole simulation ===")
    cfg = HeatConfig(nx=128)
    ref, _ = simulate_heat(cfg, PRESETS["f32"], args.steps, device=dev)
    rels = {}
    for name in ("e5m10", "r2f2_16"):
        out, _ = simulate_heat(cfg, PRESETS[name], args.steps, device=dev)
        rels[name] = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        print(f"  heat equation with {name:8s}: rel L2 vs f32 = {rels[name]:.4f}")
    print("done.")
    return rels


if __name__ == "__main__":
    main()
