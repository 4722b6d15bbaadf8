"""A fused body traced into a tape: the program kernels K8 and K9 run.

``repro``'s generic Pallas kernels trace any ``body(state, ops)``. The port
does the same on the host: :func:`tape_for` traces the body at the block's
static shapes (``torch.fx.experimental.proxy_tensor.make_fx`` over
``torch.func.functionalize``, so slice assignments become scatters of fresh
values) and compiles the graph into a :class:`Tape`, a fixed list of
instructions over strided views of three spaces: the state leaves, a
scratch of fresh values, and the body's constants. ``csrc/generic_body.cu``
runs a tape on the card (K8 the fused sweep, K9 the megakernel);
:func:`run_tape` runs it here in PyTorch, which is how the tests hold the
tracer to the plain versions without a card.

The instructions, one row of :data:`ROW` int32 each:

* ``COPY``: ``dst = a`` over the view's shape (broadcast, slices, ``cat``,
  ``stack``, ``roll``, scatters, reshapes of strided views);
* ``ARITH``: one IEEE f32 op, ``neg``, ``add``, ``sub``, ``mul``, ``div``
  or ``fma`` (one rounding, ``core/fma.py``);
* ``STATS`` and ``APPLY``: one policy operation (``FusedOps.mul``,
  ``mul_add``, ``add``, ``div``, ``rsqrt`` at a site). ``STATS`` takes the
  block maxima of the broadcast operands, picks the split, writes the
  evidence and bins the operands; ``APPLY`` runs the family op at that
  split over the result's shape (``mul_add``'s addend may broadcast further).

Views, ``clone``, ``copy`` and scalar constants cost no instruction: a value
is a view (space, offset, shape, strides) and a constant a broadcast view of
the constant space. Python scalars meet f32 tensors as f32 values, as
PyTorch rounds them on the CPU (``x / 3.0`` is an IEEE division by
``f32(3.0)``).

An aten op outside this set, a dtype other than f32 or a rank over
:data:`RANK` raises :class:`UntraceableBody` at trace time, naming the op
and the body's function. The site rules are ``repro``'s: a site called as
another op than ``site_ops`` declares raises at trace time; a site hit
twice in one substep or never reached raises at launch where the call
collects evidence, as the plain version does.

Bodies are fresh closures every chunk, so tapes are cached by the body's
code object, its closure's values (tensors by content), the leaf shapes,
the policy, the sites and the device type.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
from collections import OrderedDict
from typing import NamedTuple, Tuple

import torch

import repro_torch.core.fma as _fma_mod

__all__ = ["RANK", "ROW", "Tape", "UntraceableBody", "tape_for", "run_tape", "POLICY_OPS"]

#: most dims of an instruction's shape
RANK = 5
#: the spaces a view reads or writes: the current state, the scratch of
#: fresh values, the constants, and the next state (the body's outputs)
SP_STATE, SP_SCRATCH, SP_CONST, SP_NEXT = 0, 1, 2, 3
#: instruction kinds
I_COPY, I_ARITH, I_STATS, I_APPLY = 0, 1, 2, 3
#: ARITH op codes
A_NEG, A_ADD, A_SUB, A_MUL, A_DIV, A_FMA = 0, 1, 2, 3, 4, 5
#: policy op codes (STATS and APPLY): the first four are the adjust unit's
#: (kernels/mega.py::OP_CODES); mul_add picks its split as a product
POLICY_OPS = ("mul", "div", "add", "rsqrt", "mul_add")
#: an operand: space, offset, RANK strides
DESC = 2 + RANK
#: a row: kind, op, site, n, RANK shape dims, then dst, a, b, c
ROW = 4 + RANK + 4 * DESC


class UntraceableBody(ValueError):
    """A fused body the generic kernels cannot run, found at trace time."""


class View(NamedTuple):
    space: int
    offset: int
    shape: Tuple[int, ...]
    strides: Tuple[int, ...]


def _contig(shape):
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _is_contig(v: View) -> bool:
    return all(s == c for d, s, c in zip(v.shape, v.strides, _contig(v.shape)) if d != 1)


class Tape(NamedTuple):
    """A compiled body: ``code`` (the body's rows) and ``out_code`` (the
    copies of its outputs into the next state), ``(n, ROW)`` int32; the
    constants; the scratch a run needs (floats); the leaves' offsets in the
    state space and its size; the outputs' shapes; each policy operation's
    site and its operands' and result's shapes, in order; and the most
    elements one row covers."""

    code: torch.Tensor
    out_code: torch.Tensor
    consts: torch.Tensor
    scratch: int
    leaf_offsets: Tuple[int, ...]
    state_size: int
    out_shapes: Tuple[Tuple[int, ...], ...]
    site_calls: Tuple[int, ...]
    policy_shapes: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]
    max_n: int

    def check_sites(self, sites, collect: bool) -> None:
        """The launch-time site rules (only where evidence is collected, as
        the plain version checks them)."""
        if not collect:
            return
        seen = set()
        for j in self.site_calls:
            if j in seen:
                raise ValueError(f"fused body hit site {sites[j]!r} twice in one substep")
            seen.add(j)
        missing = [n for j, n in enumerate(sites) if j not in seen]
        if missing:
            raise ValueError(f"fused body never reached sites {missing}")


# ---------------------------------------------------------------------------
# the traced operations
# ---------------------------------------------------------------------------

_LIB = None


def _library():
    """The two operations a trace keeps whole: a policy operation and fma
    (registered once, at the first trace)."""
    global _LIB
    if _LIB is None:
        lib = torch.library.Library("repro_tape", "DEF")
        lib.define("policy(Tensor a, Tensor b, Tensor? c, int op, int site) -> Tensor")
        lib.define("fma(Tensor a, Tensor b, Tensor c) -> Tensor")

        def shaped(*ts):
            shape = torch.broadcast_shapes(*(t.shape for t in ts if t is not None))
            return ts[0].new_empty(shape, dtype=torch.float32)

        def policy(a, b, c, op, site):
            return shaped(a, b, c)

        def fma(a, b, c):
            return shaped(a, b, c)

        for name, fn in (("policy", policy), ("fma", fma)):
            lib.impl(name, fn, "CompositeExplicitAutograd")
            torch.library.register_fake(f"repro_tape::{name}", fn, lib=lib)
        _LIB = lib
    return _LIB


def _f32(x, like):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


class TraceOps:
    """The ``ops`` a body sees while it is traced: each policy operation is
    one node of the graph."""

    def __init__(self, prec, sites, site_ops):
        self.prec = prec
        self.sites = tuple(sites)
        self.site_ops = None if site_ops is None else tuple(site_ops)

    def _call(self, op, a, b, c, site, declared_as):
        if site not in self.sites:
            raise ValueError(f"fused body called ops.{op} at {site!r}, which is not one of its sites {self.sites}")
        j = self.sites.index(site)
        if self.site_ops is not None and self.site_ops[j] != declared_as:
            raise ValueError(f"site {site!r} is declared as a {self.site_ops[j]!r} op but the fused body called "
                             f"ops.{declared_as} there")
        like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
        a, b = _f32(a, like), _f32(b, like)
        c = None if c is None else _f32(c, like)
        return torch.ops.repro_tape.policy(a, b, c, POLICY_OPS.index(op), j)

    def mul(self, a, b, site):
        return self._call("mul", a, b, None, site, "mul")

    def mul_add(self, a, b, c, site):
        return self._call("mul_add", a, b, c, site, "mul")

    def add(self, a, b, site):
        return self._call("add", a, b, None, site, "add")

    def div(self, a, b, site):
        return self._call("div", a, b, None, site, "div")

    def rsqrt(self, x, site):
        return self._call("rsqrt", x, x, None, site, "rsqrt")


@contextlib.contextmanager
def _no_function_modes():
    """Trace outside any torch function mode the caller runs under (the card's
    flush mode, ``core/ftz.py``, would trace its own ops into the body)."""
    modes = []
    while torch._C._len_torch_function_stack() > 0:
        modes.append(torch._C._pop_torch_function_stack())
    try:
        yield
    finally:
        for mode in reversed(modes):
            torch._C._push_on_torch_function_stack(mode)


@contextlib.contextmanager
def _fma_as_one_node():
    prev = _fma_mod._TRACE
    _fma_mod._TRACE = lambda a, b, c: torch.ops.repro_tape.fma(*(_f32(t, a) for t in (a, b, c)))
    try:
        yield
    finally:
        _fma_mod._TRACE = prev


def _body_name(body) -> str:
    code = getattr(body, "__code__", None)
    name = getattr(body, "__qualname__", type(body).__name__)
    return f"{name} ({code.co_filename}:{code.co_firstlineno})" if code is not None else name


def _trace(body, leaf_shapes, prec, sites, site_ops=None, device="cpu"):
    """The functional aten graph of one substep of ``body`` on leaves of
    ``leaf_shapes`` (a ``torch.fx.GraphModule``)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    _library()

    def step(*leaves):
        out = body(tuple(leaves), TraceOps(prec, sites, site_ops))
        return tuple(out)

    leaves = [torch.empty(s, dtype=torch.float32, device=device) for s in leaf_shapes]
    try:
        with _no_function_modes(), _fma_as_one_node():
            return make_fx(torch.func.functionalize(step, remove="mutations_and_views"), tracing_mode="fake")(*leaves)
    except ValueError:  # the site rules, and UntraceableBody
        raise
    except Exception as exc:  # data-dependent control flow, unknown tensors, ...
        raise UntraceableBody(f"the fused body {_body_name(body)} could not be traced for the generic kernels: "
                              f"{type(exc).__name__}: {exc}") from exc


# ---------------------------------------------------------------------------
# the compiler: a graph into rows
# ---------------------------------------------------------------------------


def _coalesce(shape, strides_list):
    """Drop size-1 dims and merge adjacent dims every operand walks as one."""
    dims = [(d, [s[i] for s in strides_list]) for i, d in enumerate(shape) if d != 1]
    out = []
    for d, ss in dims:
        if out:
            pd, pss = out[-1]
            if all(ps == s * d for ps, s in zip(pss, ss)):
                out[-1] = (pd * d, ss)
                continue
        out.append((d, ss))
    return tuple(d for d, _ in out), [tuple(ss[i] for _, ss in out) for i in range(len(strides_list))]


class _Compiler:
    def __init__(self, name, leaf_shapes):
        self.name = name
        self.rows = []
        self.consts = []
        self.scratch = 0
        self.site_calls = []
        self.policy_shapes = []
        self.max_n = 1
        self.leaf_offsets, off = [], 0
        for s in leaf_shapes:
            self.leaf_offsets.append(off)
            off += _numel(s)
        self.state_size = off
        self.leaves = [View(SP_STATE, o, tuple(s), _contig(tuple(s))) for o, s in zip(self.leaf_offsets, leaf_shapes)]

    def refuse(self, what):
        raise UntraceableBody(f"the fused body {self.name} calls {what}, which the generic kernels (K8, K9) do not run; "
                              "their ops are indexing, slicing, select, cat, stack, roll, reshape, clone and slice "
                              "assignment, full/zeros_like and scalar constants, broadcasting, f32 add, sub, mul, div, "
                              "neg, core.fma.fma and the policy ops")

    # -- values ------------------------------------------------------------

    def const(self, t: torch.Tensor) -> View:
        t = t.detach().to("cpu", torch.float32)
        off = sum(c.numel() for c in self.consts)
        self.consts.append(t.reshape(-1).clone())
        return View(SP_CONST, off, tuple(t.shape), _contig(tuple(t.shape)))

    def scalar(self, v) -> View:
        return self.const(torch.tensor(v, dtype=torch.float32))

    def alloc(self, shape) -> View:
        v = View(SP_SCRATCH, self.scratch, tuple(shape), _contig(tuple(shape)))
        self.scratch += _numel(shape)
        return v

    def bcast(self, v: View, shape) -> View:
        shape = tuple(shape)
        if len(v.shape) > len(shape):
            raise UntraceableBody(f"{self.name}: cannot broadcast {v.shape} to {shape}")
        lead = len(shape) - len(v.shape)
        strides = [0] * lead
        for d, s, t in zip(v.shape, v.strides, shape[lead:]):
            if d == t:
                strides.append(s if d != 1 else 0)
            elif d == 1:
                strides.append(0)
            else:
                raise UntraceableBody(f"{self.name}: cannot broadcast {v.shape} to {shape}")
        return View(v.space, v.offset, shape, tuple(strides))

    # -- rows --------------------------------------------------------------

    def emit(self, kind, op, shape, dst=None, a=None, b=None, c=None, site=-1, coalesce=True):
        ops = [dst, a, b, c]
        n = _numel(shape)
        if n == 0:
            return
        full = [None if v is None else self.bcast(v, shape).strides for v in ops]
        present = [s for s in full if s is not None]
        if coalesce:
            shape, merged = _coalesce(shape, present)
        else:
            merged = present
        if len(shape) > RANK:
            raise UntraceableBody(f"{self.name}: an operation over {len(shape)} dims; the generic kernels take {RANK}")
        it = iter(merged)
        row = [kind, op, site, n] + [1] * (RANK - len(shape)) + list(shape)
        for v, s in zip(ops, full):
            if v is None:
                row += [-1, 0] + [0] * RANK
            else:
                st = next(it)
                row += [v.space, v.offset] + [0] * (RANK - len(st)) + list(st)
        assert len(row) == ROW
        self.rows.append(row)
        self.max_n = max(self.max_n, n)

    def copy_into(self, dst: View, src: View):
        self.emit(I_COPY, 0, dst.shape, dst=dst, a=self.bcast(src, dst.shape))

    def materialize(self, v: View) -> View:
        out = self.alloc(v.shape)
        self.copy_into(out, v)
        return out

    def contiguous(self, v: View) -> View:
        return v if _is_contig(v) else self.materialize(v)

    # -- view arithmetic ---------------------------------------------------

    @staticmethod
    def _dim(v, d):
        r = len(v.shape)
        return d + r if d < 0 else d

    def slice(self, v, dim=0, start=None, end=None, step=1, **_):
        d = self._dim(v, dim)
        size = v.shape[d]
        start, end, step = slice(start, end, step).indices(size)
        n = len(range(start, end, step))
        shape = v.shape[:d] + (n,) + v.shape[d + 1:]
        strides = v.strides[:d] + (v.strides[d] * step,) + v.strides[d + 1:]
        return View(v.space, v.offset + start * v.strides[d] if n else v.offset, shape, strides)

    def select(self, v, dim, index, **_):
        d = self._dim(v, dim)
        index = index + v.shape[d] if index < 0 else index
        return View(v.space, v.offset + index * v.strides[d], v.shape[:d] + v.shape[d + 1:],
                    v.strides[:d] + v.strides[d + 1:])

    def reshape(self, v, size):
        size = list(size)
        if -1 in size:
            i = size.index(-1)
            rest = _numel(size[:i] + size[i + 1:])
            size[i] = _numel(v.shape) // rest if rest else 0
        size = tuple(size)
        if _numel(size) != _numel(v.shape):
            raise UntraceableBody(f"{self.name}: reshape of {v.shape} to {size}")
        c = self.contiguous(v)
        return View(c.space, c.offset, size, _contig(size))

    def unsqueeze(self, v, dim, **_):
        d = dim + len(v.shape) + 1 if dim < 0 else dim
        inner = v.strides[d] * v.shape[d] if d < len(v.shape) else 1
        return View(v.space, v.offset, v.shape[:d] + (1,) + v.shape[d:], v.strides[:d] + (inner,) + v.strides[d:])

    def squeeze(self, v, dims=None, **_):
        if dims is None:
            dims = [i for i, d in enumerate(v.shape) if d == 1]
        elif isinstance(dims, int):
            dims = [dims]
        dims = {self._dim(v, d) for d in dims if v.shape[self._dim(v, d)] == 1}
        keep = [i for i in range(len(v.shape)) if i not in dims]
        return View(v.space, v.offset, tuple(v.shape[i] for i in keep), tuple(v.strides[i] for i in keep))

    def permute(self, v, dims, **_):
        dims = [self._dim(v, d) for d in dims]
        return View(v.space, v.offset, tuple(v.shape[d] for d in dims), tuple(v.strides[d] for d in dims))

    def expand(self, v, size, **_):
        size = list(size)
        lead = len(size) - len(v.shape)
        for i in range(len(size)):
            if size[i] == -1:
                size[i] = v.shape[i - lead]
        return self.bcast(v, size)

    def cat(self, vs, dim=0):
        vs = [v for v in vs if not (len(v.shape) == 1 and v.shape[0] == 0)]
        d = self._dim(vs[0], dim)
        shape = list(vs[0].shape)
        shape[d] = sum(v.shape[d] for v in vs)
        out = self.alloc(shape)
        at = 0
        for v in vs:
            self.copy_into(self.slice(out, d, at, at + v.shape[d]), v)
            at += v.shape[d]
        return out

    def stack(self, vs, dim=0):
        d = dim + len(vs[0].shape) + 1 if dim < 0 else dim
        return self.cat([self.unsqueeze(v, d) for v in vs], d)

    def roll(self, v, shifts, dims=()):
        shifts = [shifts] if isinstance(shifts, int) else list(shifts)
        dims = [dims] if isinstance(dims, int) else list(dims)
        if not dims:  # a roll of the flattened tensor
            flat = self.reshape(v, (_numel(v.shape),))
            return self.reshape(self.roll(flat, shifts, [0]), v.shape)
        for s, dim in zip(shifts, dims):
            d = self._dim(v, dim)
            n = v.shape[d]
            s = s % n if n else 0
            if s == 0:
                continue
            out = self.alloc(v.shape)
            self.copy_into(self.slice(out, d, s, n), self.slice(v, d, 0, n - s))
            self.copy_into(self.slice(out, d, 0, s), self.slice(v, d, n - s, n))
            v = out
        return v

    def scatter(self, base, src, region):
        out = self.materialize(base)
        self.copy_into(region(out), src)
        return out

    def arith(self, op, *args):
        views = [a if isinstance(a, View) else self.scalar(a) for a in args]
        shape = tuple(torch.broadcast_shapes(*(v.shape for v in views)))
        out = self.alloc(shape)
        self.emit(I_ARITH, op, shape, out, *views)
        return out

    def policy(self, a, b, c, op, site):
        ab = tuple(torch.broadcast_shapes(a.shape, b.shape))
        shape = ab if c is None else tuple(torch.broadcast_shapes(ab, c.shape))
        self.emit(I_STATS, op, ab, a=a, b=b, site=site, coalesce=False)
        out = self.alloc(shape)
        self.emit(I_APPLY, op, shape, out, a, b, c, site=site, coalesce=False)
        self.site_calls.append(site)
        self.policy_shapes.append((ab, shape))
        return out


_VIEWS = {
    "slice": "slice", "slice_copy": "slice", "select": "select", "select_copy": "select",
    "unsqueeze": "unsqueeze", "unsqueeze_copy": "unsqueeze", "squeeze": "squeeze", "squeeze_copy": "squeeze",
    "permute": "permute", "permute_copy": "permute", "expand": "expand", "expand_copy": "expand",
}
_RESHAPES = {"view", "view_copy", "_unsafe_view", "reshape", "_reshape_alias_copy"}
_SAME = {"clone", "alias", "alias_copy", "lift_fresh_copy", "lift_fresh", "detach", "detach_copy", "contiguous"}
_FILLS = {"full", "full_like", "zeros", "zeros_like", "ones", "ones_like", "scalar_tensor", "new_full", "new_zeros",
          "new_ones"}
_ARITH = {"add": A_ADD, "sub": A_SUB, "mul": A_MUL, "div": A_DIV, "neg": A_NEG}


def _fill_value(name, args, kwargs):
    if name in ("zeros", "zeros_like", "new_zeros"):
        return 0.0
    if name in ("ones", "ones_like", "new_ones"):
        return 1.0
    if name == "scalar_tensor":
        return args[0]
    if name == "new_full":
        return args[2] if len(args) > 2 else kwargs["fill_value"]
    return args[1] if len(args) > 1 else kwargs["fill_value"]  # full, full_like


def _compile(gm, leaf_shapes, name, out_shapes=None) -> Tape:
    """A traced graph as a :class:`Tape`; ``out_shapes`` are the shapes the
    outputs are broadcast to in the next state (None: their own)."""
    cc = _Compiler(name, leaf_shapes)
    env = {}
    placeholders = iter(cc.leaves)
    outs = None

    def val(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(val(x) for x in a)
        return a

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(placeholders)
            continue
        if node.op == "get_attr":
            t = getattr(gm, node.target)
            if not isinstance(t, torch.Tensor):
                cc.refuse(f"a constant {type(t).__name__}")
            env[node] = cc.const(t.to(torch.float32))
            continue
        if node.op == "output":
            outs = val(node.args[0])
            continue
        if node.op != "call_function":
            cc.refuse(f"{node.op} {node.target}")
        target = node.target
        meta = node.meta.get("val")
        opname = getattr(target, "_opname", str(target))
        ns = getattr(getattr(target, "_schema", None), "name", "").split("::")[0]
        label = f"{ns}.{opname}.{getattr(target, '_overloadname', '')}" if ns else str(target)
        if isinstance(meta, torch.Tensor) and meta.dtype != torch.float32:
            cc.refuse(f"{label} (a {meta.dtype} result)")
        args, kwargs = val(node.args), val(dict(node.kwargs))
        if ns == "repro_tape":
            if opname == "policy":
                a, b, c, op, site = (list(args) + [None] * 5)[:5]
                env[node] = cc.policy(a, b, c, op, site)
            else:
                env[node] = cc.arith(A_FMA, *args)
        elif ns != "aten":
            cc.refuse(label)
        elif opname in _VIEWS:
            env[node] = getattr(cc, _VIEWS[opname])(*args, **kwargs)
        elif opname in _RESHAPES and target._overloadname != "dtype":
            env[node] = cc.reshape(args[0], args[1])
        elif opname in ("transpose", "transpose_copy"):
            v, d0, d1 = args
            dims = list(range(len(v.shape)))
            d0, d1 = cc._dim(v, d0), cc._dim(v, d1)
            dims[d0], dims[d1] = dims[d1], dims[d0]
            env[node] = cc.permute(v, dims)
        elif opname in ("t", "t_copy"):
            v = args[0]
            env[node] = cc.permute(v, list(range(len(v.shape)))[::-1])
        elif opname in _SAME:
            env[node] = args[0]
        elif opname == "_to_copy":
            if kwargs.get("dtype", torch.float32) != torch.float32:
                cc.refuse(f"{label} to {kwargs.get('dtype')}")
            env[node] = args[0]
        elif opname == "copy":
            env[node] = cc.bcast(args[1], args[0].shape)
        elif opname == "slice_scatter":
            base, src, *rest = args
            rest = list(rest) + [kwargs.get(k) for k in ("dim", "start", "end", "step")[len(rest):]]
            dim, start, end, step = rest[0] or 0, rest[1], rest[2], rest[3] or 1
            env[node] = cc.scatter(base, src, lambda out: cc.slice(out, dim, start, end, step))
        elif opname == "select_scatter":
            base, src, dim, index = args
            env[node] = cc.scatter(base, src, lambda out: cc.select(out, dim, index))
        elif opname == "cat":
            env[node] = cc.cat(args[0], args[1] if len(args) > 1 else kwargs.get("dim", 0))
        elif opname == "stack":
            env[node] = cc.stack(args[0], args[1] if len(args) > 1 else kwargs.get("dim", 0))
        elif opname == "roll":
            env[node] = cc.roll(args[0], args[1], args[2] if len(args) > 2 else kwargs.get("dims", ()))
        elif opname in _FILLS:
            env[node] = cc.bcast(cc.scalar(_fill_value(opname, args, kwargs)), tuple(meta.shape))
        elif opname in _ARITH:
            if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode") is not None:
                cc.refuse(f"{label} with {kwargs}")
            env[node] = cc.arith(_ARITH[opname], *args)
        elif opname == "rsub":
            if kwargs.get("alpha", 1) != 1:
                cc.refuse(f"{label} with {kwargs}")
            env[node] = cc.arith(A_SUB, args[1], args[0])
        else:
            cc.refuse(label)
        if isinstance(meta, torch.Tensor) and tuple(env[node].shape) != tuple(meta.shape):
            raise UntraceableBody(f"{name}: {label} gave {env[node].shape}, expected {tuple(meta.shape)}")

    outs = list(outs)
    targets = [tuple(v.shape) for v in outs] if out_shapes is None else [tuple(s) for s in out_shapes]
    if len(targets) != len(outs):
        raise ValueError(f"fused body {name} returned {len(outs)} leaves for {len(targets)} outputs")
    code_rows, cc.rows, at = cc.rows, [], 0
    for v, s in zip(outs, targets):
        cc.copy_into(View(SP_NEXT, at, s, _contig(s)), v)
        at += _numel(s)
    out_code = cc.rows
    consts = torch.cat(cc.consts) if cc.consts else torch.zeros(1)

    def rows(r):
        return torch.tensor(r, dtype=torch.int32).reshape(len(r), ROW)

    return Tape(rows(code_rows), rows(out_code), consts, max(cc.scratch, 1), tuple(cc.leaf_offsets), cc.state_size,
                tuple(targets), tuple(cc.site_calls), tuple(cc.policy_shapes), cc.max_n)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

_CACHE: "OrderedDict[object, Tape]" = OrderedDict()
_CACHE_SIZE = 64


class _Uncacheable(Exception):
    pass


def _freeze(v, depth=0):
    if depth > 8:
        raise _Uncacheable
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu").contiguous()
        return ("tensor", str(t.dtype), tuple(t.shape), hashlib.sha1(t.reshape(-1).view(torch.uint8).numpy()).hexdigest())
    code = getattr(v, "__code__", None)
    if code is not None:
        return ("fn", code, _closure_key(v, depth + 1))
    if isinstance(v, functools.partial):
        return ("partial", _freeze(v.func, depth + 1), _freeze(v.args, depth + 1),
                _freeze(tuple(sorted(v.keywords.items())), depth + 1))
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, tuple(_freeze(x, depth + 1) for x in v))
    try:
        hash(v)
    except TypeError:
        raise _Uncacheable from None
    return (type(v), v)


def _closure_key(fn, depth=0):
    cells = getattr(fn, "__closure__", None) or ()
    return tuple(_freeze(c.cell_contents, depth) for c in cells) + (_freeze(getattr(fn, "__defaults__", None), depth),)


def tape_for(body, leaf_shapes, *, prec, sites, site_ops=None, out_shapes=None, device="cpu") -> Tape:
    """The body's tape at these leaf shapes, its outputs broadcast to
    ``out_shapes`` (None: their own); cached, see the module docstring."""
    leaf_shapes = tuple(tuple(int(d) for d in s) for s in leaf_shapes)
    if out_shapes is not None:
        out_shapes = tuple(tuple(int(d) for d in s) for s in out_shapes)
    dev = torch.device(device).type
    try:
        key = (_freeze(body), leaf_shapes, out_shapes, prec, tuple(sites), None if site_ops is None else tuple(site_ops),
               dev)
    except _Uncacheable:
        key = None
    if key is not None and key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    gm = _trace(body, leaf_shapes, prec, sites, site_ops, device=device)
    tape = _compile(gm, leaf_shapes, _body_name(body), out_shapes)
    if key is not None:
        _CACHE[key] = tape
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    return tape


# ---------------------------------------------------------------------------
# the tape on the CPU (the tests' executor)
# ---------------------------------------------------------------------------


def _view(spaces, row, j):
    base = 4 + RANK + j * DESC
    space = int(row[base])
    if space < 0:
        return None
    shape = [int(d) for d in row[4:4 + RANK]]
    strides = [int(s) for s in row[base + 2:base + 2 + RANK]]
    return torch.as_strided(spaces[space], shape, strides, int(row[base + 1]))


def run_tape(tape: Tape, leaves, ops):
    """One substep of the tape in PyTorch on one block's ``leaves`` with a
    plain version's ``ops`` (a FusedOps): the body's outputs, as
    ``body(leaves, ops)`` gives them. Every row runs as the kernels run it,
    over the same views of the same spaces; a policy operation hands its
    operands, read through its STATS row, to ``ops``."""
    dev = leaves[0].device
    state = torch.cat([x.to(torch.float32).reshape(-1) for x in leaves]) if leaves else torch.zeros(0)
    nxt = torch.empty(sum(_numel(s) for s in tape.out_shapes) or 1, device=dev)
    spaces = [state, torch.empty(tape.scratch, device=dev), tape.consts.to(dev), nxt]
    pending, calls = {}, iter(tape.policy_shapes)
    for row in tape.code.tolist() + tape.out_code.tolist():
        kind, op, site = row[:3]
        if kind == I_STATS:
            ab, out_shape = next(calls)
            pending[site] = (_view(spaces, row, 1).reshape(ab), _view(spaces, row, 2).reshape(ab), out_shape)
            continue
        dst = _view(spaces, row, 0)
        if kind == I_COPY:
            dst.copy_(_view(spaces, row, 1))
        elif kind == I_ARITH:
            a, b, c = (_view(spaces, row, j) for j in (1, 2, 3))
            if op == A_NEG:
                r = -a
            elif op == A_FMA:
                r = _fma_mod.fma(a, b, c)
            else:
                r = {A_ADD: torch.add, A_SUB: torch.sub, A_MUL: torch.mul, A_DIV: torch.div}[op](a, b)
            dst.copy_(r)
        else:  # APPLY: the STATS row's operands through the plain version's ops
            a, b, out_shape = pending.pop(site)
            name = ops.sites[site]
            pop = POLICY_OPS[op]
            if pop == "mul_add":
                r = ops.mul_add(a, b, _view(spaces, row, 3).reshape(out_shape), name)
            elif pop == "rsqrt":
                r = ops.rsqrt(a, name)
            else:
                r = getattr(ops, pop)(a, b, name)
            dst.copy_(r.reshape(dst.shape))
    outs, at = [], 0
    for s in tape.out_shapes:
        n = _numel(s)
        outs.append(nxt[at:at + n].reshape(s).clone())
        at += n
    return tuple(outs)
