"""The fused execution plane's sweep driver and its in-kernel arithmetic.

A fused kernel runs ``steps`` solver substeps over blocked state in one
launch, with every policy operation at one runtime split per block and the
per-site operand max exponents emitted as evidence for the adjust unit.

:func:`fused_sweep` owns what every such kernel shares, on the host: it
pads rows and columns with the per-leaf pad constants, cuts the field into
``(br, bw)`` split blocks, runs either the CUDA kernel (CUDA tensors) or the
plain PyTorch version (CPU tensors, or ``plain=True``), max-reduces the
per-block evidence across blocks, and crops. The split block is part of the
numerics: pad lanes keep their pad constants and take part in every block
max, whatever shape a CUDA block has.

The plain version runs ``body(state_blocks, ops)`` per block and substep,
where ``ops`` is a :class:`FusedOps`: ``ops.mul(a, b, site)`` applies the
policy's arithmetic family (``rr`` per-block split / ``bf16`` / ``fixed`` /
``f32``) and records the evidence; the bf16 family's results stay f32, as
in the compiled reference (see ``precision/engines.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fma import fma
from repro_torch.core.flexformat import quantize_em
from repro_torch.kernels.blockops import block_max_exp, rr_add_block, rr_div_block, rr_mul_block, rr_rsqrt_block
from repro_torch.precision.engines import bf16_round
from repro_torch.precision.fusion import fused_family

__all__ = ["FusedOps", "fused_sweep", "STORAGE_PENDING", "CAPTURE_PENDING"]

STORAGE_PENDING = "storage other than 'f32' is not ported yet: ROADMAP.md queue 1 item 6 (pack/)"
CAPTURE_PENDING = "range capture and policies are not ported yet: ROADMAP.md queue 1 item 7 (profile/)"


class FusedOps:
    """Per-substep policy arithmetic inside a fused body (the plain
    version's mirror of ``pde.solver.StepOps``)."""

    __slots__ = ("prec", "sites", "site_ops", "family", "k_floor", "collect", "evidence")

    def __init__(self, prec, sites: Tuple[str, ...], k_floor=None, collect=False, site_ops=None):
        self.prec = prec
        self.sites = tuple(sites)
        self.site_ops = None if site_ops is None else tuple(site_ops)
        self.family = fused_family(prec.mode)
        if self.family is None:
            raise ValueError(f"mode {prec.mode!r} has no fused arithmetic family; run it on the reference plane")
        self.k_floor = k_floor
        self.collect = collect
        self.evidence = {}  # site -> (a_max_exp, b_max_exp) f32 scalars

    def _record(self, a, b, site: str, op: str):
        a, b = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32))
        if self.site_ops is not None:
            declared = self.site_ops[self.sites.index(site)]
            if declared != op:
                raise ValueError(f"site {site!r} is declared as a {declared!r} op but the fused body called ops.{op} there")
        exps = None
        if self.collect or self.family == "rr":
            exps = (block_max_exp(a), block_max_exp(b))
        if self.collect:
            if site in self.evidence:
                raise ValueError(f"fused body hit site {site!r} twice in one substep")
            self.evidence[site] = tuple(e.to(torch.float32) for e in exps)
        return a, b, exps

    def _k_floor_at(self, site: str):
        return None if self.k_floor is None else self.k_floor[self.sites.index(site)]

    def _product(self, a, b, site: str, exps):
        if self.family == "f32":
            return a * b
        if self.family == "bf16":
            return bf16_round(a) * bf16_round(b)
        if self.family == "fixed":
            e, m = self.prec.fixed_em
            return quantize_em(quantize_em(a, e, m) * quantize_em(b, e, m), e, m)
        k_min = self._k_floor_at(site)
        if self.prec.pinned and k_min is not None:
            return rr_mul_block(a, b, self.prec.fmt, self.prec.tail_approx, exps=exps, k_fixed=k_min)
        return rr_mul_block(a, b, self.prec.fmt, self.prec.tail_approx, exps=exps, k_min=k_min)

    def mul(self, a, b, site: str):
        """Product of two blocks on the policy's multiplier at a named site."""
        a, b, exps = self._record(a, b, site, "mul")
        return self._product(a, b, site, exps)

    def mul_add(self, a, b, c, site: str):
        """``a * b + c`` with the product at a named site. The f32 and bf16
        families round once, as the compiled reference fuses their plain
        f32 product into the add."""
        a, b, exps = self._record(a, b, site, "mul")
        if self.family == "f32":
            return fma(a, b, c)
        if self.family == "bf16":
            return fma(bf16_round(a), bf16_round(b), c)
        return self._product(a, b, site, exps) + c

    def _alu(self, a, b, site: str, op: str, substrate, rr_block):
        a, b, exps = self._record(a, b, site, op)
        if self.family == "f32":
            return substrate(a, b)
        if self.family == "bf16":
            return substrate(bf16_round(a), bf16_round(b))
        if self.family == "fixed":
            e, m = self.prec.fixed_em
            return quantize_em(substrate(quantize_em(a, e, m), quantize_em(b, e, m)), e, m)
        k_min = self._k_floor_at(site)
        if self.prec.pinned and k_min is not None:
            return rr_block(a, b, self.prec.fmt, exps=exps, k_fixed=k_min)
        return rr_block(a, b, self.prec.fmt, exps=exps, k_min=k_min)

    def add(self, a, b, site: str):
        """Sum of two blocks on the policy's flexible adder."""
        return self._alu(a, b, site, "add", lambda x, y: x + y, rr_add_block)

    def div(self, a, b, site: str):
        """Quotient of two blocks on the policy's flexible divider."""
        return self._alu(a, b, site, "div", lambda x, y: x / y, rr_div_block)

    def rsqrt(self, x, site: str):
        """Reciprocal square root of one block; evidence is the exponent doubled."""
        return self._alu(
            x, x, site, "rsqrt", lambda v, _w: torch.rsqrt(v),
            lambda a, b, fmt, **kw: rr_rsqrt_block(a, fmt, **kw),
        )


def _sweep_plain(body, leaves, *, prec, sites, site_ops, steps, br, bw, gi, gj, n_out, k_floor, collect):
    """The plain version: every split block advanced on its own, substep by
    substep. Returns padded outputs and ``(gi, gj, steps, n_sites, 2)``
    evidence (or None)."""
    outs = [torch.empty_like(leaves[0]) for _ in range(n_out)]
    block_ev = []
    for i in range(gi):
        for j in range(gj):
            rows, cols = slice(i * br, (i + 1) * br), slice(j * bw, (j + 1) * bw)
            st = tuple(x[rows, cols] for x in leaves)
            step_ev = []
            for _ in range(steps):
                ops = FusedOps(prec, sites, k_floor=k_floor, collect=collect, site_ops=site_ops)
                new = body(st, ops)
                if len(new) != n_out:
                    raise ValueError(f"fused body returned {len(new)} leaves but the sweep was declared with n_out={n_out}")
                if collect:
                    missing = [n for n in sites if n not in ops.evidence]
                    if missing:
                        raise ValueError(f"fused body never reached sites {missing}")
                    step_ev.append(torch.stack([torch.stack(ops.evidence[n]) for n in sites]))
                st = new
            for o, v in zip(outs, st):
                o[rows, cols] = v
            if collect:
                block_ev.append(torch.stack(step_ev))
    ev = torch.stack(block_ev).reshape(gi, gj, steps, len(sites), 2) if collect else None
    return outs, ev


def fused_sweep(
    body: Callable,
    state: Sequence[torch.Tensor],
    *,
    prec,
    sites: Tuple[str, ...],
    site_ops: Optional[Tuple[str, ...]] = None,
    steps: int = 1,
    block: Tuple[int, int],
    n_out: Optional[int] = None,
    pad_values: Optional[Sequence[float]] = None,
    k_floor=None,
    collect_evidence: bool = False,
    kernel: Optional[Callable] = None,
    counter=None,
    plain: bool = False,
    capture=None,
    storage: str = "f32",
):
    """Run ``steps`` substeps of a fused body over blocked 2-D state.

    ``state`` holds ``(rows, width)`` f32 leaves; ``block`` is clamped to
    the state shape; ``pad_values`` are per-leaf pad constants (default
    0.0); ``k_floor`` is the ``(n_sites,)`` carried split that floors (or,
    under ``prec.pinned``, fixes) the rr family's per-block split.

    ``kernel(leaves, br=, bw=, gi=, gj=, k_floor=, collect=)`` launches the
    CUDA kernel on the padded leaves and returns ``(outs, block_evidence)``.
    It runs for CUDA tensors unless ``plain``; CPU tensors (or ``plain``)
    take the plain version, counted in ``counter.plain_calls``.

    Returns ``(out_leaves, evidence)`` with evidence ``(steps, n_sites, 2)``
    (max over blocks) or None.
    """
    if storage != "f32":
        raise NotImplementedError(STORAGE_PENDING)
    if capture is not None:
        raise NotImplementedError(CAPTURE_PENDING)
    n_sites = len(sites)
    if site_ops is not None and len(site_ops) != n_sites:
        raise ValueError(f"site_ops covers {len(site_ops)} entries for {n_sites} sites")
    leaves = [x.to(torch.float32) for x in state]
    rows, width = leaves[0].shape
    for x in leaves[1:]:
        if tuple(x.shape) != (rows, width):
            raise ValueError(f"state leaves disagree: {tuple(x.shape)} vs {(rows, width)}")
    n_state = len(leaves)
    n_out = n_state if n_out is None else n_out
    if steps != 1 and n_out != n_state:
        raise ValueError(
            f"multi-substep sweeps need body in/out leaf counts to match ({n_state} != {n_out})"
        )

    br, bw = min(block[0], rows), min(block[1], width)
    pr, pw = -rows % br, -width % bw
    if pr or pw:
        pv = tuple(pad_values) if pad_values is not None else (0.0,) * n_state
        leaves = [F.pad(x, (0, pw, 0, pr), value=v) for x, v in zip(leaves, pv)]
    gi, gj = (rows + pr) // br, (width + pw) // bw
    collect = bool(collect_evidence)
    if k_floor is not None:
        k_floor = torch.as_tensor(k_floor).to(device=leaves[0].device, dtype=torch.int32)

    if leaves[0].is_cuda and not plain:
        if kernel is None:
            raise RuntimeError("this fused body has no CUDA kernel; pass CPU tensors to run its plain version")
        outs, block_ev = kernel(leaves, br=br, bw=bw, gi=gi, gj=gj, k_floor=k_floor, collect=collect)
    else:
        if counter is not None:
            counter.plain_calls += 1
        outs, block_ev = _sweep_plain(
            body, leaves, prec=prec, sites=tuple(sites), site_ops=site_ops, steps=steps,
            br=br, bw=bw, gi=gi, gj=gj, n_out=n_out, k_floor=k_floor, collect=collect,
        )
    evidence = block_ev.amax(dim=(0, 1)) if collect else None
    if pr or pw:
        outs = [o[:rows, :width] for o in outs]
    return tuple(outs), evidence
