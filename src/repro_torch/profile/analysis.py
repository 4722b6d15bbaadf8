"""Offline range analysis (the port of ``repro/profile/analysis.py``): the
paper's Fig. 3/4 views from a captured run, hosted as numpy.

:class:`RangeReport` derives each site's dynamic range (the occupied
exponent span of its operands), its spread over simulation time (per
snapshot interval) and its representability (the share of operations whose
instantaneous need ``k_need`` a static split ``k`` covers).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import PrecisionConfig, evidence_k_need

from .capture import CaptureResult, CaptureSpec

__all__ = ["RangeProfile", "RangeReport"]


def host(x, dtype) -> np.ndarray:
    """A tensor or array as a numpy array of ``dtype`` on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def k_need(evidence: np.ndarray, prec: PrecisionConfig, site_ops=None) -> np.ndarray:
    """``(steps, n_sites)`` instantaneous needs, each site under its op's
    envelope (None: every site a product)."""
    ev = torch.from_numpy(np.asarray(evidence, np.float32))
    ops = site_ops or ("mul",) * ev.shape[1]
    cols = [evidence_k_need(ev[:, j, 0], ev[:, j, 1], prec, op) for j, op in enumerate(ops)]
    if not cols:
        return np.zeros((ev.shape[0], 0), np.int64)
    return torch.stack(cols, dim=1).numpy().astype(np.int64)


class RangeProfile:
    """A captured run, hosted: numpy arrays and static context."""

    def __init__(
        self,
        stepper: str,
        sites: Tuple[str, ...],
        spec: CaptureSpec,
        prec: PrecisionConfig,
        steps: int,
        execution: str,
        result: CaptureResult,
        site_ops: Optional[Tuple[str, ...]] = None,
    ):
        self.stepper = stepper
        self.sites = tuple(sites)
        #: per-site op declarations ("mul"/"add"/"div"/"rsqrt"); None: all "mul"
        self.site_ops = None if site_ops is None else tuple(site_ops)
        if self.site_ops is not None and len(self.site_ops) != len(self.sites):
            raise ValueError(f"site_ops covers {len(self.site_ops)} entries for {len(self.sites)} sites")
        self.spec = spec
        self.prec = prec
        self.steps = int(steps)
        self.execution = execution
        self.evidence = host(result.evidence, np.float32)
        self.exp_time = host(result.exp_time, np.int64)
        self.exp_total = host(result.exp_total, np.int64)
        n_sites = len(self.sites)
        if self.evidence.shape[1:] != (n_sites, 2):
            raise ValueError(f"evidence shape {self.evidence.shape} does not match {n_sites} sites")
        if self.exp_total.shape != (n_sites, 2, spec.n_bins):
            raise ValueError(f"exp_total shape {self.exp_total.shape} != {(n_sites, 2, spec.n_bins)}")

    def site_index(self, name: str) -> int:
        try:
            return self.sites.index(name)
        except ValueError:
            raise KeyError(f"unknown site {name!r}; profiled: {self.sites}") from None

    def report(self) -> "RangeReport":
        return RangeReport(self)


def _occupied_span(counts, spec: CaptureSpec) -> Optional[Tuple[int, int]]:
    """(min_exp, max_exp) of the occupied bins, or None if nothing counted."""
    (occ,) = np.nonzero(counts)
    if occ.size == 0:
        return None
    return int(occ[0] + spec.e_lo), int(occ[-1] + spec.e_lo)


class RangeReport:
    """Derived per-site statistics over a :class:`RangeProfile`."""

    def __init__(self, profile: RangeProfile):
        self.profile = p = profile
        fx = p.prec.fmt.fx
        self.k_need = k_need(p.evidence, p.prec, p.site_ops).astype(np.int32)
        self.sites: Dict[str, Dict[str, Any]] = {}
        for j, name in enumerate(p.sites):
            per_op = [_occupied_span(p.exp_total[j, s], p.spec) for s in (0, 1)]
            both = p.exp_total[j].sum(axis=0)
            span = _occupied_span(both, p.spec)
            kn = self.k_need[:, j]
            self.sites[name] = {
                "values_counted": int(both.sum()),
                "exp_span": span,
                "exp_span_a": per_op[0],
                "exp_span_b": per_op[1],
                "dynamic_range_bits": None if span is None else span[1] - span[0] + 1,
                "k_need_min": int(kn.min()),
                "k_need_max": int(kn.max()),
                "k_need_final": int(kn[-1]),
                "coverage_at_k": {int(k): float(np.mean(kn <= k)) for k in range(fx + 1)},
                "spread_over_time": [
                    _occupied_span(p.exp_time[t, j].sum(axis=0), p.spec) for t in range(p.exp_time.shape[0])
                ],
            }

    def to_dict(self) -> Dict[str, Any]:
        p = self.profile
        return {
            "stepper": p.stepper,
            "execution": p.execution,
            "capture_mode": p.prec.mode,
            "steps": p.steps,
            "fmt": str(p.prec.fmt),
            "sites": self.sites,
        }

    def summary(self) -> str:
        """Human-readable per-site table (the CLI's report body)."""
        p = self.profile
        fx = p.prec.fmt.fx
        lines = [
            f"range profile: {p.stepper} | {p.steps} steps | "
            f"mode={p.prec.mode} | execution={p.execution} | fmt={p.prec.fmt}",
            f"{'site':<16} {'values':>10} {'exp span':>12} {'k_need':>9} " + " ".join(f"cov@k={k}" for k in range(fx + 1)),
        ]
        for name, s in self.sites.items():
            span = s["exp_span"]
            span_s = "-" if span is None else f"[{span[0]},{span[1]}]"
            cov = " ".join(f"{100.0 * s['coverage_at_k'][k]:6.1f}%" for k in range(fx + 1))
            lines.append(f"{name:<16} {s['values_counted']:>10} {span_s:>12} {s['k_need_min']}..{s['k_need_max']:<6} {cov}")
            spread = s["spread_over_time"]
            if spread:
                lines.append(f"{'':<16} spread over time: first interval {spread[0]} -> last {spread[-1]}")
        return "\n".join(lines)
