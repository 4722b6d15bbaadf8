"""The health monitor's process-wide registry, as ``repro.obs.health`` has it.

The serving plane asks :func:`active` for the enabled monitor at each of its
hooks and skips the monitor when there is none, as ``repro.service`` does
when no monitor is enabled. The monitor itself (anomaly detectors,
shadow-oracle sampling, SLO rules, the flight recorder and the scrape
endpoint) is not ported yet: :func:`enable` raises until it is.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["enable", "disable", "active"]

_MONITOR = None


def enable(config=None, **overrides):
    """Install the process-wide health monitor: not ported yet, so this
    raises and nothing is installed."""
    raise NotImplementedError(
        "the health monitor is not ported to repro_torch yet (ROADMAP.md queue 1, obs/health: "
        "health, shadow, flightrec and server, with Simulation.oracle/oracle_replay)"
    )


def disable() -> None:
    """Remove the monitor; every service hook reverts to a no-op."""
    global _MONITOR
    _MONITOR = None


def active() -> Optional[object]:
    """The enabled monitor, or None (always None until it is ported)."""
    return _MONITOR
