"""Batched greedy serving."""

from .decode import generate
