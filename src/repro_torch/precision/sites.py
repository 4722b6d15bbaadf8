"""Named multiplication sites over a RangeTracker.

A :class:`SiteTracker` maps site names (``"heat.flux"``, ``"swe.div"``) to
tracker rows, so stepper code never numbers its multipliers by hand.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.flexformat import FlexFormat
from repro_torch.core.policy import RangeTracker, tracker_init

__all__ = ["SiteTracker", "site_tracker_init", "resolve_site", "rewrap"]


class SiteTracker:
    """A RangeTracker whose rows are addressed by name."""

    def __init__(self, names: Tuple[str, ...], state: RangeTracker):
        self.names = tuple(names)
        self.state = state
        if len(self.names) != len(set(self.names)):
            raise ValueError(f"duplicate site names: {self.names}")

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown precision site {name!r}; tracked sites: {self.names}") from None

    def k(self, name: str):
        """Current flexible split for a named site."""
        return self.state.k[self.index(name)]

    def with_state(self, state: RangeTracker) -> "SiteTracker":
        return SiteTracker(self.names, state)

    def to(self, device) -> "SiteTracker":
        return SiteTracker(self.names, self.state.to(device))

    def __len__(self) -> int:
        return len(self.names)

    def __repr__(self) -> str:
        return f"SiteTracker(sites={list(self.names)})"


def site_tracker_init(names: Sequence[str], fmt: FlexFormat, k0=None, *, device) -> SiteTracker:
    """Fresh tracker with one row per named site."""
    return SiteTracker(tuple(names), tracker_init(len(names), fmt, k0=k0, device=device))


def resolve_site(tracker, site) -> Tuple[Optional[RangeTracker], Optional[int]]:
    """Normalize ``(tracker, site)`` to ``(RangeTracker, int)``: a SiteTracker
    with a name, a RangeTracker with an int, or no tracker at all."""
    if tracker is None:
        return None, None
    if isinstance(tracker, SiteTracker):
        if site is None:
            return tracker.state, None
        return tracker.state, tracker.index(site) if isinstance(site, str) else int(site)
    if isinstance(site, str):
        raise TypeError(
            f"named site {site!r} needs a SiteTracker; got {type(tracker).__name__}"
        )
    return tracker, site


def rewrap(tracker, state: Optional[RangeTracker]):
    """Re-attach updated state to the caller's tracker container."""
    if state is None or tracker is None:
        return tracker
    if isinstance(tracker, SiteTracker):
        return tracker.with_state(state)
    return state
