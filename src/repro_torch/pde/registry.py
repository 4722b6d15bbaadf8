"""String-keyed stepper registry (mirrors ``repro.pde.registry``).

heat1d and swe2d are ported; the other builtin steppers of the reference
raise until their slice lands.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["register_stepper", "get_stepper", "known_steppers", "PENDING_STEPPERS"]

_STEPPERS: Dict[str, object] = {}
_builtins_loaded = False

#: the reference's other steppers, not ported yet
PENDING_STEPPERS = ("heat2d", "advection1d", "burgers1d")


def register_stepper(name: str, stepper=None):
    """Register ``stepper`` (an instance or a class) under ``name``; usable
    as a class decorator. Re-registering a name replaces it."""
    if stepper is None:
        return lambda s: register_stepper(name, s)
    instance = stepper() if isinstance(stepper, type) else stepper
    instance.name = name
    _STEPPERS[name] = instance
    return stepper


def _load_builtins() -> None:
    global _builtins_loaded
    if not _builtins_loaded:
        from repro_torch.pde import heat1d, swe2d  # noqa: F401 (register on import)

        _builtins_loaded = True


def get_stepper(name: str):
    """Resolve a stepper name to its registered instance."""
    _load_builtins()
    if name in _STEPPERS:
        return _STEPPERS[name]
    if name in PENDING_STEPPERS:
        raise NotImplementedError(
            f"stepper {name!r} is not ported to repro_torch yet: ROADMAP.md queue 1 item 8"
        )
    raise KeyError(f"no PDE stepper registered for {name!r}; known: {known_steppers()}")


def known_steppers() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_STEPPERS))
