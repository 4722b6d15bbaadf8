"""Step builders: the greedy serve step (training is not ported yet)."""

from .step import make_serve_step
