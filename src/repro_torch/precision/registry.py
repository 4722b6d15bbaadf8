"""String-keyed engine registry: every ``PrecisionConfig.mode`` names an
engine registered here. ``repro_torch.core.policy.KNOWN_MODES`` is the one
list of valid modes; :func:`register_engine` extends it."""

from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.policy import KNOWN_MODES

__all__ = ["register_engine", "get_engine", "known_modes", "is_known_mode"]

_REGISTRY: Dict[str, object] = {}


def register_engine(name: str, engine=None):
    """Register ``engine`` (an instance or a class) under ``name``; usable as
    a class decorator. Re-registering a name replaces the engine."""
    if engine is None:
        return lambda e: register_engine(name, e)
    instance = engine() if isinstance(engine, type) else engine
    instance.name = name
    _REGISTRY[name] = instance
    KNOWN_MODES.add(name)
    return engine


def _load_builtins() -> None:
    if not _REGISTRY:
        from repro_torch.precision import engines  # noqa: F401 (registers on import)


def get_engine(cfg):
    """Resolve a config (or bare mode string) to its registered engine."""
    mode = cfg if isinstance(cfg, str) else cfg.mode
    _load_builtins()
    try:
        return _REGISTRY[mode]
    except KeyError:
        raise KeyError(f"no precision engine registered for mode {mode!r}; known: {known_modes()}") from None


def known_modes() -> Tuple[str, ...]:
    return tuple(sorted(KNOWN_MODES))


def is_known_mode(mode: str) -> bool:
    return mode in KNOWN_MODES
