"""Step builders (this slice: the greedy serve step)."""

from .step import make_serve_step
