"""Batched greedy serving."""

from .decode import generate, resolve_policy

__all__ = ["generate", "resolve_policy"]
