"""Tile-wise flexible ALU ops beyond multiply (add, sub, div, rsqrt)."""

from .flexops import flex_add, flex_div, flex_op, flex_rsqrt, flex_sub

__all__ = ["flex_add", "flex_sub", "flex_div", "flex_rsqrt", "flex_op"]
