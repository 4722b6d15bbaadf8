"""Logical-axis sharding: name a tensor's dims, resolve them per mesh.

Code annotates tensors with *logical* axis names (``constrain(x, "batch",
None)``: an ensemble's member dim is ``batch``) instead of mesh axes, so the
same code runs on one device and on a mesh without edits. The mapping from a
logical name to mesh axes lives in one table, :data:`DEFAULT_RULES`, which
is ``repro``'s:

  * ``batch``   -> ("pod", "data")   data parallelism (ensemble members)
  * ``heads`` / ``mlp`` / ``vocab`` / ``experts`` / ``kv_seq`` -> "model"
  * ``seq`` / ``embed`` / ``kv_heads`` -> None (unconstrained)

A mesh is any object with ``axis_names`` and ``shape`` (axis name -> size),
as ``jax.sharding.Mesh`` has; :class:`LocalMesh` describes one device.
:func:`constrain` is the identity outside an :func:`axis_rules` context.
Inside one it checks the names against the tensor (a ``ValueError`` for the
wrong count, a ``KeyError`` for an unknown name) and resolves each against
the live mesh: axes the mesh does not have are dropped, and a dim the
surviving axes do not divide is left unconstrained. On one device every
dim resolves to no split and the tensor comes back unchanged, so the layer
is passive. A dim that a mesh of several devices would split raises
``NotImplementedError``: the port places no tensor across devices yet
(``torch.distributed`` is not used here).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Tuple, Union

__all__ = ["DEFAULT_RULES", "LocalMesh", "active_mesh", "axis_rules", "constrain", "logical_spec"]

# One entry per logical axis: a mesh axis name, a tuple of names, or None
# (unconstrained). Axes missing from the live mesh are filtered at
# resolution time, so one table serves (data,), (data, model) and
# (pod, data, model) meshes.
Rule = Union[None, str, Tuple[str, ...]]

DEFAULT_RULES: Dict[str, Rule] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,
    "kv_seq": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
}


class LocalMesh:
    """A mesh of one device: every named axis has size 1 (default the one
    ``data`` axis)."""

    def __init__(self, axis_names: Tuple[str, ...] = ("data",)):
        self.axis_names = tuple(axis_names)
        self.shape: Mapping[str, int] = {name: 1 for name in self.axis_names}

    @property
    def size(self) -> int:
        return 1

    def __repr__(self) -> str:
        return f"LocalMesh(axis_names={self.axis_names})"


_ACTIVE = threading.local()  # .stack: list of (mesh, rules)


def _filter_rule(rule: Rule, mesh) -> Rule:
    """Drop mesh axes the live mesh doesn't have; collapse empties to None."""
    if rule is None:
        return None
    if isinstance(rule, str):
        return rule if rule in mesh.axis_names else None
    kept = tuple(a for a in rule if a in mesh.axis_names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_spec(name: Optional[str], *, mesh, rules: Optional[Dict[str, Rule]] = None) -> Rule:
    """Resolve one logical axis name to the mesh axes it splits over on
    ``mesh`` (a name, a tuple of names, or None).

    Unknown names raise ``KeyError``: a mistyped logical axis fails loudly
    rather than silently replicate. ``None`` passes through (unconstrained).
    """
    if name is None:
        return None
    table = DEFAULT_RULES if rules is None else rules
    return _filter_rule(table[name], mesh)


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, Rule]] = None):
    """Activate :func:`constrain` with this mesh and rule table for the
    block. Nestable; the innermost context wins."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append((mesh, DEFAULT_RULES if rules is None else rules))
    try:
        yield mesh
    finally:
        stack.pop()


def active_mesh():
    """The innermost :func:`axis_rules` context's mesh, or None."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1][0] if stack else None


def _axis_extent(rule: Rule, mesh) -> int:
    ext = 1
    for a in rule if isinstance(rule, tuple) else (rule,):
        ext *= int(mesh.shape[a])
    return ext


def constrain(x, *names: Optional[str]):
    """Annotate each dim of ``x`` with a logical axis name (or None).

    The identity outside an :func:`axis_rules` context. Inside one, every
    name resolves through the active rule table, dims the mesh extent does
    not divide are left unconstrained, and ``x`` comes back unchanged where
    nothing is split (one device); a split raises ``NotImplementedError``.
    """
    stack = getattr(_ACTIVE, "stack", None)
    if not stack:
        return x
    mesh, rules = stack[-1]
    if len(names) != len(x.shape):
        raise ValueError(f"constrain got {len(names)} axis names for rank-{len(x.shape)} value {tuple(x.shape)}")
    for dim, name in zip(x.shape, names):
        rule = logical_spec(name, mesh=mesh, rules=rules)
        if rule is None:
            continue
        ext = _axis_extent(rule, mesh)
        if ext > 1 and dim % ext == 0:
            raise NotImplementedError(
                f"constrain would split a dim of {dim} over mesh axes {rule} ({ext} devices): splitting across "
                "devices is outside the port, which runs on one device"
            )
    return x
