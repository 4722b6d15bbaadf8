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

With ``storage="packed"`` the leaves are :class:`repro_torch.pack.PackedArray`
payloads: the kernel decodes each leaf at its carried split in its prologue
and re-encodes the advanced leaf at a split picked afresh from it in its
epilogue, so the chunk moves ``fmt.total_bits`` an element, not 32.

With ``capture`` (a :class:`repro_torch.profile.CaptureSpec`) every
policy operation also bins its operands' exponents per site, over the valid
lanes only (pad lanes never count), summed over substeps and blocks into
``(n_sites, 2, n_bins)`` int32 counts; capture turns the evidence on.

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

import repro_torch.obs as _obs
from repro_torch.core.fma import fma
from repro_torch.core.flexformat import quantize_em
from repro_torch.kernels.blockops import block_max_exp, rr_add_block, rr_div_block, rr_mul_block, rr_rsqrt_block
from repro_torch.pack.packed import PackedArray, block_storage_k, pack_block, payload_dtype, unpack_block
from repro_torch.precision.engines import bf16_round
from repro_torch.precision.fusion import fused_family
from repro_torch.profile.capture import pair_exp_hist

__all__ = ["FusedOps", "fused_sweep"]


class FusedOps:
    """Per-substep policy arithmetic inside a fused body (the plain
    version's mirror of ``pde.solver.StepOps``). With ``capture`` it bins
    each operation's broadcast operands into ``counts`` (site -> ``(2,
    n_bins)``), masked to the block's valid lanes ``valid`` (see
    :func:`_valid_lanes`) on a padded grid."""

    __slots__ = ("prec", "sites", "site_ops", "family", "k_floor", "collect", "capture", "valid", "evidence", "counts")

    def __init__(self, prec, sites: Tuple[str, ...], k_floor=None, collect=False, site_ops=None, capture=None,
                 valid=None):
        self.prec = prec
        self.sites = tuple(sites)
        self.site_ops = None if site_ops is None else tuple(site_ops)
        self.family = fused_family(prec.mode)
        if self.family is None:
            raise ValueError(f"mode {prec.mode!r} has no fused arithmetic family; run it on the reference plane")
        self.k_floor = k_floor
        self.collect = collect
        self.capture = capture
        self.valid = valid
        self.evidence = {}  # site -> (a_max_exp, b_max_exp) f32 scalars
        self.counts = {}  # site -> (2, n_bins) int32 operand exponent counts

    def _valid_mask(self, shape):
        """The valid-lane mask broadcast to an operand's shape (None: all
        valid). Row padding needs operands that keep the block's rows,
        column padding operands that keep its width; anything else cannot
        be attributed to lanes and is refused."""
        if self.valid is None:
            return None
        row_ok, col_ok, br, bw = self.valid
        m = None
        if row_ok is not None:
            if len(shape) != 2 or shape[0] != br:
                raise ValueError(f"capture on a row-padded grid needs body operands to keep the block row extent {br}; "
                                 f"got shape {tuple(shape)}")
            m = row_ok.expand(shape)
        if col_ok is not None:
            if len(shape) != 2 or shape[1] != bw:
                raise ValueError(f"capture on a width-padded grid needs body operands to keep the block width {bw}; "
                                 f"got shape {tuple(shape)}")
            m = col_ok.expand(shape) if m is None else m & col_ok.expand(shape)
        return m

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
        if self.capture is not None:  # the operands as the body passes them, before any rounding
            self.counts[site] = pair_exp_hist(a, b, self.capture, self._valid_mask(a.shape))
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


def _valid_lanes(i, j, br, bw, extent, device):
    """Block ``(i, j)``'s valid-lane masks on a padded grid, ``(row_ok (br,
    1) | None, col_ok (1, bw) | None, br, bw)``, or None where the grid is
    not padded; ``extent`` holds the unpadded rows and width (None where
    that axis has no padding)."""
    if extent is None:
        return None
    rows, width = extent
    row_ok = None if rows is None else (i * br + torch.arange(br, device=device) < rows)[:, None]
    col_ok = None if width is None else (j * bw + torch.arange(bw, device=device) < width)[None, :]
    return row_ok, col_ok, br, bw


def _sweep_plain(body, leaves, *, prec, sites, site_ops, steps, br, bw, gi, gj, n_out, k_floor, collect, capture=None,
                 extent=None):
    """The plain version: every split block advanced on its own, substep by
    substep. Returns padded outputs, ``(gi, gj, steps, n_sites, 2)``
    evidence (or None) and, with ``capture``, the ``(n_sites, 2, n_bins)``
    counts summed over blocks and substeps (or None)."""
    outs = [torch.empty_like(leaves[0]) for _ in range(n_out)]
    block_ev = []
    counts = None
    if capture is not None:
        counts = torch.zeros((len(sites), 2, capture.n_bins), dtype=torch.int32, device=leaves[0].device)
    for i in range(gi):
        for j in range(gj):
            rows, cols = slice(i * br, (i + 1) * br), slice(j * bw, (j + 1) * bw)
            st = tuple(x[rows, cols] for x in leaves)
            valid = None if capture is None else _valid_lanes(i, j, br, bw, extent, leaves[0].device)
            step_ev = []
            for _ in range(steps):
                ops = FusedOps(prec, sites, k_floor=k_floor, collect=collect, site_ops=site_ops, capture=capture,
                               valid=valid)
                new = body(st, ops)
                if len(new) != n_out:
                    raise ValueError(f"fused body returned {len(new)} leaves but the sweep was declared with n_out={n_out}")
                if collect:
                    missing = [n for n in sites if n not in ops.evidence]
                    if missing:
                        raise ValueError(f"fused body never reached sites {missing}")
                    step_ev.append(torch.stack([torch.stack(ops.evidence[n]) for n in sites]))
                if capture is not None:
                    counts += torch.stack([ops.counts[n] for n in sites])
                st = new
            for o, v in zip(outs, st):
                o[rows, cols] = v
            if collect:
                block_ev.append(torch.stack(step_ev))
    ev = torch.stack(block_ev).reshape(gi, gj, steps, len(sites), 2) if collect else None
    return outs, ev, counts


def _packed_leaves(state, prec):
    """The payloads of packed leaves, with the reference's refusals."""
    pas = list(state)
    for pa in pas:
        if not isinstance(pa, PackedArray):
            raise TypeError(f"storage='packed' takes repro_torch.pack.PackedArray leaves; got {type(pa).__name__}")
        if pa.fmt != prec.fmt:
            raise ValueError(f"packed leaf format {pa.fmt} disagrees with the policy format {prec.fmt}")
    return pas


def _single_block(pas, what: str):
    for pa in pas:
        if tuple(pa.k.shape[-2:]) != (1, 1):
            raise ValueError(f"{what} takes single-block PackedArrays (one split per leaf); got k of shape {tuple(pa.k.shape)}")


def fused_sweep(
    body: Callable,
    state: Sequence,
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
    members: bool = False,
):
    """Run ``steps`` substeps of a fused body over blocked 2-D state.

    ``state`` holds ``(rows, width)`` f32 leaves; ``block`` is clamped to
    the state shape; ``pad_values`` are per-leaf pad constants (default
    0.0); ``k_floor`` is the ``(n_sites,)`` carried split that floors (or,
    under ``prec.pinned``, fixes) the rr family's per-block split.

    ``members=True`` runs an ensemble: every leaf leads with a member dim
    ``(members, rows, width)``, ``k_floor`` is ``(members, n_sites)``, and
    each member is swept as on its own (its own blocks, splits, evidence,
    counts and storage splits) in one launch; the evidence is then
    ``(members, steps, n_sites, 2)`` and the counts lead with the member too.

    ``storage="packed"`` takes PackedArray leaves instead and returns them:
    each leaf is decoded at its split before the first substep and encoded
    after the last at a split picked from the advanced leaf. As in the
    reference, it needs the block to cover the whole field (one storage
    block per leaf), ``n_out == n_state`` and the policy's format.

    ``capture`` (a CaptureSpec) bins every policy operation's operands
    over the valid lanes, summed over substeps and blocks, and turns the
    evidence on; the result then has a third element, the ``(n_sites, 2,
    n_bins)`` int32 counts.

    ``kernel(leaves, br=, bw=, gi=, gj=, k_floor=, collect=, k_in=)``
    launches the CUDA kernel on the padded leaves, each ``(members, rows,
    width)`` (a run alone is one member), with ``k_floor`` ``(members,
    n_sites)``, and returns ``(outs, block_evidence)``, the evidence
    ``(members, gi, gj, steps, n_sites, 2)``; with ``k_in`` (the leaves'
    splits, ``(members,)`` each, packed storage) the leaves and outs are
    payloads and it returns ``(outs, block_evidence, k_outs)``. Under
    capture it is also given ``capture=`` and ``extent=`` (the unpadded rows
    and width, each None where that axis has no padding) and returns the
    ``(members, n_sites, 2, n_bins)`` counts last. It runs for CUDA tensors
    unless ``plain``; CPU tensors (or ``plain``) take the plain version,
    counted in ``counter.plain_calls``.

    Returns ``(out_leaves, evidence)`` with evidence ``(steps, n_sites, 2)``
    (max over blocks) or None, and the counts under capture.
    """
    if storage not in ("f32", "packed"):
        raise ValueError(f"unknown fused storage {storage!r}; 'f32' | 'packed'")
    packed = storage == "packed"
    n_sites = len(sites)
    if site_ops is not None and len(site_ops) != n_sites:
        raise ValueError(f"site_ops covers {len(site_ops)} entries for {n_sites} sites")
    if packed:
        pas = _packed_leaves(state, prec)
        leaves = [pa.payload for pa in pas]
    else:
        leaves = [x.to(torch.float32) for x in state]
    if not members:  # a run alone: one member
        leaves = [x[None] for x in leaves]
    if leaves[0].dim() != 3:
        raise ValueError(f"fused_sweep takes 2-D leaves (3-D with members=True); got {tuple(leaves[0].shape)}")
    n_members, rows, width = leaves[0].shape
    for x in leaves[1:]:
        if tuple(x.shape) != (n_members, rows, width):
            raise ValueError(f"state leaves disagree: {tuple(x.shape)} vs {(n_members, rows, width)}")
    n_state = len(leaves)
    n_out = n_state if n_out is None else n_out
    if steps != 1 and n_out != n_state:
        raise ValueError(
            f"multi-substep sweeps need body in/out leaf counts to match ({n_state} != {n_out})"
        )

    br, bw = min(block[0], rows), min(block[1], width)
    pr, pw = -rows % br, -width % bw
    if packed:
        if (br, bw) != (rows, width):
            raise ValueError(
                "in-kernel packed storage requires the sweep block to cover the whole field: "
                f"block {(br, bw)} vs state {(rows, width)} (one storage block per leaf)"
            )
        if n_out != n_state:
            raise ValueError(f"in-kernel packed storage needs body in/out leaf counts to match ({n_state} != {n_out})")
        _single_block(pas, "in-kernel packed storage")
    pv = tuple(pad_values) if pad_values is not None else (0.0,) * n_state
    gi, gj = (rows + pr) // br, (width + pw) // bw
    collect = bool(collect_evidence) or capture is not None
    extent = (rows if pr else None, width if pw else None) if (pr or pw) else None
    if k_floor is not None:
        k_floor = torch.as_tensor(k_floor).to(device=leaves[0].device, dtype=torch.int32)
        k_floor = k_floor.reshape(n_members, n_sites) if members else k_floor.reshape(1, n_sites)

    k_outs = counts = None
    if leaves[0].is_cuda and not plain:
        if kernel is None:
            raise RuntimeError("this fused body has no CUDA kernel; pass CPU tensors to run its plain version")
        if pr or pw:
            leaves = [F.pad(x, (0, pw, 0, pr), value=v) for x, v in zip(leaves, pv)]
        kw = {} if capture is None else {"capture": capture, "extent": extent}
        if packed:
            kw["k_in"] = [pa.k.reshape(n_members).to(torch.int32) for pa in pas]
        with _obs.span("cuda.fused_sweep", steps=steps, grid=f"{gi}x{gj}", members=n_members):
            _obs.inc("repro_cuda_dispatch_total", help="CUDA kernel launches entered", kernel="fused_sweep")
            res = kernel(leaves, br=br, bw=bw, gi=gi, gj=gj, k_floor=k_floor, collect=collect, **kw)
        outs, block_ev = res[:2]
        if packed:
            k_outs = res[2]
        if capture is not None:
            counts = res[-1]
        evidence = block_ev.amax(dim=(1, 2)) if collect else None
        if not packed and (pr or pw):
            outs = [o[:, :rows, :width] for o in outs]
    else:
        if counter is not None:
            counter.plain_calls += 1
        outs, evidence, counts, k_outs = _sweep_members(
            body, leaves, pas if packed else None, prec=prec, sites=tuple(sites), site_ops=site_ops, steps=steps,
            br=br, bw=bw, gi=gi, gj=gj, pr=pr, pw=pw, pv=pv, n_out=n_out, k_floor=k_floor, collect=collect,
            capture=capture, extent=extent,
        )
    if packed:
        outs = [
            PackedArray(p if members else p[0], k.reshape(pa.k.shape).to(torch.int32), pa.fmt, pa.shape, pa.block)
            for p, k, pa in zip(outs, k_outs, pas)
        ]
    elif not members:
        outs = [o[0] for o in outs]
    if not members:
        evidence = None if evidence is None else evidence[0]
        counts = None if counts is None else counts[0]
    if capture is not None:
        return tuple(outs), evidence, counts
    return tuple(outs), evidence


def _sweep_members(body, leaves, pas, *, prec, sites, site_ops, steps, br, bw, gi, gj, pr, pw, pv, n_out, k_floor,
                   collect, capture, extent):
    """The plain version over ``(members, rows, width)`` leaves, member by
    member: each member's leaves (decoded at its split under packed
    storage), padded, swept by :func:`_sweep_plain` at its own floor, cropped
    (or encoded at a split picked afresh from it). Returns the stacked outs,
    evidence, counts and splits (each None where absent)."""
    n_members, rows, width = leaves[0].shape
    fmt = prec.fmt
    outs, evs, cnts, ks = [], [], [], []
    for m in range(n_members):
        if pas is not None:  # the prologue: each leaf decoded at the member's carried split
            st = [unpack_block(x[m].to(torch.int64), fmt, pa.k.reshape(n_members)[m]) for x, pa in zip(leaves, pas)]
        else:
            st = [x[m] for x in leaves]
        if pr or pw:
            st = [F.pad(x, (0, pw, 0, pr), value=v) for x, v in zip(st, pv)]
        out, block_ev, cnt = _sweep_plain(
            body, st, prec=prec, sites=sites, site_ops=site_ops, steps=steps, br=br, bw=bw, gi=gi, gj=gj, n_out=n_out,
            k_floor=None if k_floor is None else k_floor[m], collect=collect, capture=capture, extent=extent,
        )
        if pas is not None:  # the epilogue: a split picked afresh from each advanced leaf
            k_m = [block_storage_k(v, fmt) for v in out]
            out = [pack_block(v, fmt, k).to(payload_dtype(fmt)) for v, k in zip(out, k_m)]
            ks.append(torch.stack(k_m))
        elif pr or pw:
            out = [o[:rows, :width] for o in out]
        outs.append(out)
        if collect:
            evs.append(block_ev.amax(dim=(0, 1)))
        if cnt is not None:
            cnts.append(cnt)
    stacked = [torch.stack(col) for col in zip(*outs)]
    k_outs = None if pas is None else list(torch.stack(ks).T)
    return stacked, torch.stack(evs) if evs else None, torch.stack(cnts) if cnts else None, k_outs
