"""String-keyed stepper registry (mirrors ``repro.pde.registry``): the five
builtin steppers register on first lookup."""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["register_stepper", "get_stepper", "known_steppers"]

_STEPPERS: Dict[str, object] = {}
_builtins_loaded = False


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
        from repro_torch.pde import advection1d, burgers1d, heat1d, heat2d, swe2d  # noqa: F401 (register on import)

        _builtins_loaded = True


def get_stepper(name: str):
    """Resolve a stepper name to its registered instance."""
    _load_builtins()
    if name in _STEPPERS:
        return _STEPPERS[name]
    raise KeyError(f"no PDE stepper registered for {name!r}; known: {known_steppers()}")


def known_steppers() -> Tuple[str, ...]:
    _load_builtins()
    return tuple(sorted(_STEPPERS))
